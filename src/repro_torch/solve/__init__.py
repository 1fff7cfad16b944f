"""Tiered iterative-refinement solvers of the port (``rgesv``/``rposv``
and the refinement-backed solves on existing factorizations)."""

from .refine import (LADDER_CELLS, TIERS, RefinementInfo,
                     cholesky_solve_refined, lu_solve_refined, rgesv, rposv,
                     tier_eps)

__all__ = ["TIERS", "LADDER_CELLS", "RefinementInfo", "rgesv", "rposv",
           "lu_solve_refined", "cholesky_solve_refined", "tier_eps"]

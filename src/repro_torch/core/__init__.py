"""Core numerics of the port: EFTs, the dd/td/qd tiers and the
count-generic ``mp`` seam, Ozaki slicing, BLAS and dense linear algebra."""

from . import dd, efts, mp, qd, td  # noqa: F401

"""repro_torch — the PyTorch/CUDA port of ``repro``.

A binary128-class (dd) GEMM under MPLAPACK-style ``Rgemm``, the blocked LU
it accelerates and the tiered refined solve above it, on an NVIDIA H100.
The reference's two Pallas kernels are hand-written CUDA C++ for sm_90a
(``csrc/``), each beside a plain PyTorch version.  This package imports
no JAX and nothing of ``repro``.  Entry points run on the card unless the
caller passes ``device="cpu"`` (or a CPU tensor).
"""

from . import core, gemm, kernels, solve  # noqa: F401

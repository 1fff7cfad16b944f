"""Kernels of the port: the two hand-written Hopper GEMM kernels
(``mlgemm`` -> ``csrc/mlgemm.cu``; ``ozgemm`` -> ``csrc/ozgemm.cu`` for f64
slices and ``csrc/ozgemm_narrow.cu`` for bf16/f32 slices, both on the
workspace of kernel #2's slicing pre-pass ``ozslice`` ->
``csrc/ozslice.cu``) and the
elementwise tier arithmetic (``mpops`` -> ``csrc/mpops.cu``), each beside
its plain PyTorch version, plus the ``ref`` oracle and the blocked ``ops``
loop.  Nothing here builds or imports a compiler at import time.
"""

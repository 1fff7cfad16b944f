"""Build the hand-written CUDA kernels at first use and load them.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` once per limb count
(``-DKLIMBS=2|3|4``: dd, td, qd), and ``ozgemm_narrow.cu`` once more per
slice variant (``-DOZ_VARIANT=0..3``, so that its eight instantiations at
qd do not make one long pole of the build), each into its own shared
library with a plain C interface, loaded through ``ctypes`` (no PyTorch
headers, so a build takes seconds).  ``--fmad=false`` is load-bearing:
contracting a multiply into a following add collapses the error terms of
the error-free transformations, and the kernels must repeat the plain
versions' rounding sequence bit for bit.

Libraries land in ``build/kernels/`` at the repository root (listed in
``.gitignore``), named by a hash of the sources and flags, so an edited
source never loads a stale library.  ``build_all()`` starts one ``nvcc``
per source, limb count and variant, all at once, and waits for every one of
them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["NVCC_FLAGS", "SOURCES", "LIMBS", "build_all", "load",
           "pointers", "stream", "BUILD_DIR", "CSRC"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("mlgemm", "ozslice", "ozgemm", "ozgemm_narrow", "mpops")
LIMBS = (2, 3, 4)
# sources built once per variant: name -> the variants' -DOZ_VARIANT values
BUILD_VARIANTS = {"ozgemm_narrow": (0, 1, 2, 3)}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "--fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_LIBS: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit at first use on the card")
    return path


def _target(name: str, nlimbs: int, variant=None) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh") and (
                src.stem == name or src.suffix == ".cuh"):
            h.update(src.name.encode() + src.read_bytes())
    v = "" if variant is None else f"v{variant}"
    return BUILD_DIR / f"lib{name}{nlimbs}{v}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES, counts=LIMBS, variants=None) -> dict:
    """Compile every missing library in parallel (``variants``: only these
    of a split source); return {(label, nlimbs): ptxas log}, the label
    being the source's name, with ``:v`` for a variant."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    try:
        for name in names:
            for nl in counts:
                for v in variants or BUILD_VARIANTS.get(name, (None,)):
                    out = _target(name, nl, v)
                    if out.exists():
                        continue
                    tmp = out.with_suffix(f".{os.getpid()}.tmp")
                    flags = [f"-DKLIMBS={nl}"] + (
                        [] if v is None else [f"-DOZ_VARIANT={v}"])
                    cmd = [_nvcc(), *NVCC_FLAGS, *flags, "-o", str(tmp),
                           str(CSRC / f"{name}.cu")]
                    label = name if v is None else f"{name}:{v}"
                    procs[label, nl] = (subprocess.Popen(
                        cmd, stdout=subprocess.PIPE,
                        stderr=subprocess.STDOUT, text=True), tmp, out)
        logs = {}
        for key, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {key[0]}.cu at "
                                   f"KLIMBS={key[1]}:\n{log}")
            os.replace(tmp, out)
            logs[key] = log
        return logs
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def load(name: str, nlimbs: int, variant=None) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` at ``nlimbs`` limbs (and
    ``variant``, for a source built per variant), built if missing."""
    lib = _LIBS.get((name, nlimbs, variant))
    if lib is None:
        out = _target(name, nlimbs, variant)
        if not out.exists():
            build_all((name,), (nlimbs,),
                      None if variant is None else (variant,))
        lib = ctypes.CDLL(str(out))
        _LIBS[name, nlimbs, variant] = lib
    return lib


def stream(device) -> int:
    """The raw handle of PyTorch's current CUDA stream on ``device``
    (``torch.cuda.current_stream`` builds a Stream object per call, a cost
    the SDP loop's tens of thousands of small launches would feel)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def pointers(tensors):
    """A C array of the tensors' device addresses (``None`` -> null)."""
    return (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])

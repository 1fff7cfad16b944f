"""Core numerics of the port: EFTs, the dd/td/qd tiers and the
count-generic ``mp`` seam, Ozaki slicing, BLAS, dense linear algebra and
the SDP interior-point solver (``core.sdp``)."""

from . import dd, efts, mp, qd, td  # noqa: F401

r"""Reconstruction primitives (counterpart of :mod:`pytorch_nmf_tpu.ops.recon`).

Only the dense ``linear`` map :math:`H W^\top` is ported so far; the
deconvolutional reconstructions come with the NMFD family.
"""

import torch

__all__ = ["acc_type", "linear"]


def acc_type(*xs) -> torch.dtype:
    """Accumulation dtype: float32, except when an operand is float64 —
    double-precision inputs must not be truncated (reference
    ``torchnmf/nmf.py:215`` honors the input dtype)."""
    for x in xs:
        if x.dtype == torch.float64:
            return torch.float64
    return torch.float32


def linear(H: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """``H @ W.T`` accumulated in :func:`acc_type`
    (reference ``F.linear``, nmf.py:693)."""
    dt = acc_type(H, W)
    return H.to(dt) @ W.to(dt).T

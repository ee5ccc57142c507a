r"""Fused E-step for dense PLCA (counterpart of
:mod:`pytorch_nmf_tpu.ops.fast_plca`), opt-in.

The PLCA EM E-step is one backward pass with cotangent ``Vn / (WZH + eps)``
(reference plca.py:252-253).  For the dense model, ``recon = H @ (W·Z)ᵀ``,
its three gradients are β=1 contractions of B1 (:mod:`.fused_mu`) with
``Wz = W·Z``:

    gH = ratio @ Wz                    (the H-side contraction)
    gW = (ratioᵀ @ H) · Z              (the W-side contraction, scaled)
    gZ = Σ_k W ⊙ (ratioᵀ @ H)

where ``ratio = Vn / (H Wzᵀ + eps)`` stays on chip; each contraction
recomputes the reconstruction.  The contractions return their raw sums (no
``mu_pos`` epilogue): the M-step applies ``relu`` itself.  The kernel's β=1
cotangent is ``v / (wh + eps)``, the E-step's constant in the E-step's
place.

The JAX package keeps this form behind ``PNT_PLCA_FUSED=1`` because the
generic E-step measured faster on its TPU; the port keeps the same switch,
read per call, for float32 2-D targets.  Without it the E-step is the
generic one: three ``torch.matmul``\ s through autograd.
"""

import os

import torch

from . import fused_mu

__all__ = [
    "plca_em_engine_fused",
    "plca_em_engine_plain",
    "resolve_plca_em_engine",
]


def _cotangents(contract):
    """``cotangents(Vn, w, h, z) -> (gH, gW, gZ)`` over ``contract``: the
    B1 wrapper or its plain version."""
    last = [None, None]  # Vn, and Vn with aligned rows (padded once per fit)

    def aligned(Vn):
        if last[0] is not Vn:
            last[:] = Vn, fused_mu.aligned_rows(Vn)
        return last[1]

    def cotangents(Vn, w, h, z):
        V, wz = aligned(Vn), w * z
        gH, _ = contract(V, h, wz, beta=1.0, need_pos=False, w_side=False)
        base_w, _ = contract(V, h, wz, beta=1.0, need_pos=False, w_side=True)
        return gH, base_w * z, torch.sum(w * base_w, dim=0)

    return cotangents


def plca_em_engine_fused():
    """The fused E-step over the B1 wrapper (the CUDA kernel on a CUDA
    target)."""
    return _cotangents(fused_mu.fused_contractions)


def plca_em_engine_plain():
    """The same E-step over B1's plain version, on any device."""
    return _cotangents(fused_mu.plain_contractions)


def resolve_plca_em_engine(V):
    """The dense PLCA E-step engine factory for this fit: ``None`` (the
    generic E-step) unless ``PNT_PLCA_FUSED=1``; then, for a float32 2-D
    target, the kernel engine on a CUDA target and its plain twin
    elsewhere.  Any other target (a bfloat16 one included) takes the
    generic E-step, as the JAX package's fused E-step declines a non-float32
    target: that is its path, not a fallback after a failure (its ``Vn =
    V / V.sum()`` is bfloat16, and the E-step's cotangent promotes it)."""
    if os.environ.get("PNT_PLCA_FUSED", "") != "1":
        return None
    if V.ndim != 2 or V.dtype != torch.float32:
        return None
    if V.device.type == "cuda":
        return plca_em_engine_fused
    return plca_em_engine_plain

r"""The generic multiplicative-update (MU) engine.

Counterpart of :mod:`pytorch_nmf_tpu.ops.mu`.  For a factor ``p`` with
reconstruction ``WH = recon(p)`` the update is ``p · (neg / pos) ** γ``
where ``neg = ∂⟨WH, neg_cot⟩/∂p`` and ``pos = ∂⟨WH, pos_cot⟩/∂p`` — the
reference's double-cotangent trick (``torchnmf/nmf.py:52-92``), here as two
``torch.autograd.grad`` calls on one graph.  Cotangents per β:

=====  =====================================  ==========================
β      ``neg_cot``                            ``pos_cot``
=====  =====================================  ==========================
2      ``V``                                  ``WH``
1      ``V / (WH + eps)``                     analytic col-sums
0      ``V / (WH + eps)**2``                  ``1 / (WH + eps)``
else   ``V * (WH + eps)**(β-2)``              ``(WH + eps)**(β-1)``
=====  =====================================  ==========================

This engine is what float64 fits run, and the plain formulation the fused
kernels (:mod:`pytorch_nmf_tpu_torch.ops.fused_mu`) are algebraically equal to.
"""

from typing import Callable, Optional

import torch

from ..constants import eps

__all__ = [
    "gamma_from_beta",
    "mu_cotangents",
    "mu_multiplier",
    "mu_update",
    "kl_pos_W",
    "kl_pos_H",
    "get_norm",
    "renorm",
]


def gamma_from_beta(beta: float) -> float:
    """MU exponent guaranteeing monotone descent (reference nmf.py:341-346)."""
    if beta < 1:
        return 1.0 / (2.0 - beta)
    elif beta > 2:
        return 1.0 / (beta - 1.0)
    return 1.0


def mu_cotangents(V, WH, beta: float, kl_pos_ones: bool = False):
    """The β-specific ``(neg, pos)`` output cotangent pair.

    ``pos`` is ``None`` at β=1 when the caller has the analytic positive
    term; with ``kl_pos_ones=True`` it is ``ones_like(WH)`` instead.
    """
    if beta == 2:
        # a bfloat16 V is the one cotangent not promoted by arithmetic: the
        # backward passes and the kernels take the reconstruction's dtype
        return V.to(torch.promote_types(V.dtype, WH.dtype)), WH
    elif beta == 1:
        neg = V / (WH + eps)
        pos = torch.ones_like(WH) if kl_pos_ones else None
        return neg, pos
    elif beta == 0:
        recip = 1.0 / (WH + eps)
        return recip * recip * V, recip
    else:
        WH_eps = WH + eps
        # one pow, shared: WH_eps^(β-1) = WH_eps^(β-2) · WH_eps
        p2 = WH_eps ** (beta - 2)
        return p2 * V, p2 * WH_eps


def mu_multiplier(neg, pos, p, gamma: float, l1_reg: float, l2_reg: float):
    """``(neg / pos) ** γ`` with the L1 constant and the L2 ``l2·p`` term in
    the denominator (reference nmf.py:78-92)."""
    if l1_reg > 0:
        pos = pos + l1_reg
    if l2_reg > 0:
        pos = pos + l2_reg * p
    multiplier = neg / pos
    if gamma != 1:
        multiplier = multiplier**gamma
    return multiplier


def mu_update(
    recon: Callable,
    V,
    p,
    beta: float,
    gamma: float,
    l1_reg: float = 0.0,
    l2_reg: float = 0.0,
    pos_precomputed: Optional[torch.Tensor] = None,
):
    """One dense MU step for the factor ``p``; ``recon`` closes over the
    other factors as constants."""
    with torch.enable_grad():
        p_ = p.detach().requires_grad_(True)
        WH = recon(p_)
        neg_cot, pos_cot = mu_cotangents(
            V, WH.detach(), beta, kl_pos_ones=pos_precomputed is None
        )
        need_pos = pos_precomputed is None
        (neg,) = torch.autograd.grad(WH, p_, neg_cot, retain_graph=need_pos)
        neg = torch.relu(neg) + eps
        if need_pos:
            (pos,) = torch.autograd.grad(WH, p_, pos_cot)
            pos = torch.relu(pos) + eps
        else:
            pos = pos_precomputed
    return p * mu_multiplier(neg, pos, p, gamma, l1_reg, l2_reg)


def kl_pos_W(H):
    """Analytic β=1 denominator of the W update: ``H`` summed over every
    axis but the rank axis, kept for broadcasting (reference nmf.py:122-131)."""
    axes = tuple(d for d in range(H.ndim) if d != 1)
    return torch.sum(H, dim=axes, keepdim=True)


def kl_pos_H(W):
    """Analytic β=1 denominator of the H update."""
    axes = tuple(d for d in range(W.ndim) if d != 1)
    return torch.sum(W, dim=axes, keepdim=True).squeeze(0)


def get_norm(x, axis: int = 1):
    """Per-rank-slice L2 norm: reduce ``x*x`` over all axes but ``axis``."""
    axes = tuple(d for d in range(x.ndim) if d != axis)
    return torch.sqrt(torch.sum(x * x, dim=axes))


def renorm(W, H, unit_norm: str = "W"):
    """Return ``(W, H)`` rescaled so the chosen factor has unit per-rank L2
    norm, the scale moved to the other factor (reference nmf.py:134-159)."""
    def rank_axis(n, x):  # (R,) broadcast against x's rank axis 1
        return n.reshape((-1,) + (1,) * (x.ndim - 2))

    if unit_norm == "W":
        n = get_norm(W)
        return W / rank_axis(n, W), H * rank_axis(n, H)
    elif unit_norm == "H":
        n = get_norm(H)
        return W * rank_axis(n, W), H / rank_axis(n, H)
    raise ValueError("Input type isn't valid!")

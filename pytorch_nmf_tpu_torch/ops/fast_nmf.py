r"""Specialized MU updaters for the plain ``NMF`` model (counterpart of
:mod:`pytorch_nmf_tpu.ops.fast_nmf`), handed to the solver through its
``updater_factory`` argument.

β = 2 (Frobenius): the Gram trick.  ``(H Wᵀ)ᵀ H`` re-associates to
``W (Hᵀ H)``, an (R, R) Gram matrix and a skinny GEMM, so no update ever
materializes the (M, K) reconstruction.  Plain ``torch.matmul``: these are
ordinary GEMMs, as the JAX package left them to XLA.

Other β keep the WH-ratio structure and run the fused contractions of
:mod:`pytorch_nmf_tpu_torch.ops.fused_mu` — the CUDA kernels on a CUDA
target — or their plain PyTorch versions.
"""

import weakref

import torch

from ..constants import eps
from ..metrics import beta_div
from . import fused_mu
from .mu import kl_pos_H, kl_pos_W, mu_multiplier
from .recon import row_blocks, target_mm, target_tmm

__all__ = [
    "nmf_updater_factory_fused",
    "nmf_updater_factory_plain",
    "nmf_updater_factory_generic",
    "resolve_nmf_updater_factory",
]


def _beta2_updaters(gamma, l1_reg, l2_reg):
    # ``mT``: the same updates on a batch of problems (a leading batch axis,
    # batched GEMMs), which the batched fit runs.  A bfloat16 V is upcast a
    # row block at a time (recon.target_tmm / target_mm)
    def upd_W(V, W, H):
        neg = torch.relu(target_tmm(V, H)) + eps  # VᵀH : (K, R)
        G = H.mT @ H  # HᵀH : (R, R)
        pos = torch.relu(W @ G) + eps
        return W * mu_multiplier(neg, pos, W, gamma, l1_reg, l2_reg)

    def upd_H(V, W, H):
        neg = torch.relu(target_mm(V, W)) + eps  # (M, R)
        G = W.mT @ W  # WᵀW : (R, R)
        pos = torch.relu(H @ G) + eps
        return H * mu_multiplier(neg, pos, H, gamma, l1_reg, l2_reg)

    # no fused loss: the Gram identity for the Frobenius loss cancels
    # catastrophically in float32 near convergence, so the direct
    # euclidean(recon, V) serves the every-10-iterations cadence
    # (:func:`_blocked_loss` in the dense fit)
    return upd_W, upd_H


def _blocked_loss(beta):
    """The β ∈ {1, 2} cadence loss ``beta_div(H Wᵀ, V)`` summed over row
    blocks of V (:func:`~.recon.row_blocks`): the reconstruction and the
    divergence's temporaries never exist whole, so the fit's peak memory
    is V's and not that of several (M, K) float32 arrays.  One block is
    exactly ``beta_div(H Wᵀ, V)``."""
    def loss_terms(V, W, H):
        total = None
        for rows in row_blocks(V):
            part = beta_div(H[rows] @ W.T, V[rows], beta)
            total = part if total is None else total + part
        return total

    return loss_terms


def _fused_updaters(beta, gamma, l1_reg, l2_reg, contract, beta_loss):
    """``contract``/``beta_loss``: the fused wrappers or their plain versions."""
    need_pos = beta != 1

    if beta == 1 and gamma == 1 and l1_reg == 0 and l2_reg == 0:
        # fully fused KL update: the contraction applies relu/eps and the
        # analytic denominator after its reduction and returns the factor
        def upd_W(V, W, H):
            out, _ = contract(V, H, W, beta=1.0, need_pos=False, w_side=True,
                              mu_pos=kl_pos_W(H))
            return out

        def upd_H(V, W, H):
            out, _ = contract(V, H, W, beta=1.0, need_pos=False, w_side=False,
                              mu_pos=kl_pos_H(W).reshape(1, -1))
            return out

        return upd_W, upd_H, _blocked_loss(1)

    def upd_W(V, W, H):
        neg, pos = contract(V, H, W, beta=beta, need_pos=need_pos, w_side=True)
        neg = torch.relu(neg) + eps
        pos = kl_pos_W(H) if beta == 1 else torch.relu(pos) + eps
        return W * mu_multiplier(neg, pos, W, gamma, l1_reg, l2_reg)

    def upd_H(V, W, H):
        neg, pos = contract(V, H, W, beta=beta, need_pos=need_pos, w_side=False)
        neg = torch.relu(neg) + eps
        pos = kl_pos_H(W) if beta == 1 else torch.relu(pos) + eps
        return H * mu_multiplier(neg, pos, H, gamma, l1_reg, l2_reg)

    if beta == 1:
        # β=1 keeps the plain kl_div cadence loss, as the JAX package does
        return upd_W, upd_H, _blocked_loss(1)

    def loss_terms(V, W, H):
        return beta_loss(V, H, W, beta)

    return upd_W, upd_H, loss_terms


def _dense_beta2_updaters(gamma, l1_reg, l2_reg):
    """The Gram updaters with the blocked Frobenius cadence loss."""
    return _beta2_updaters(gamma, l1_reg, l2_reg) + (_blocked_loss(2),)


def nmf_updater_factory_fused(beta, gamma, l1_reg, l2_reg):
    """β = 2 → Gram trick; other β → the fused contraction and loss
    wrappers (the CUDA kernels on a CUDA target, for a float32 or a
    bfloat16 V).  The kernels copy rows of V in 16-byte pieces: a V whose
    rows are not 16-byte aligned (a card tensor the caller passed as it
    is; ``target_like`` aligns the copies it makes) is padded at the first
    update, into a copy the updaters keep (a compiled fit's chunk reads it
    where it lies); their ``refresh(V)`` copies V's values into it, which
    the solver calls at the start of every later fit."""
    if beta == 2:
        return _dense_beta2_updaters(gamma, l1_reg, l2_reg)
    # a weak reference to V, and V's copy with aligned rows (None: V's own
    # rows are aligned); V is not kept alive by the updaters
    last = [None, None]

    def aligned(V):
        if last[0] is None or last[0]() is not V:
            A = fused_mu.aligned_rows(V)
            last[:] = weakref.ref(V), (None if A is V else A)
        return V if last[1] is None else last[1]

    def refresh(V):
        if last[1] is not None and last[0]() is V:
            last[1].copy_(V)

    def contract(V, *args, **kwargs):
        return fused_mu.fused_contractions(aligned(V), *args, **kwargs)

    def beta_loss(V, H, W, beta):
        return fused_mu.fused_beta_loss(aligned(V), H, W, beta)

    updaters = _fused_updaters(beta, gamma, l1_reg, l2_reg, contract,
                               beta_loss)
    for fn in updaters:
        fn.refresh = refresh
    return updaters


def nmf_updater_factory_plain(beta, gamma, l1_reg, l2_reg):
    """Like :func:`nmf_updater_factory_fused`, through the plain PyTorch
    versions of the kernels on any device."""
    if beta == 2:
        return _dense_beta2_updaters(gamma, l1_reg, l2_reg)
    return _fused_updaters(beta, gamma, l1_reg, l2_reg,
                           fused_mu.plain_contractions, fused_mu.plain_beta_loss)


def nmf_updater_factory_generic(beta, gamma, l1_reg, l2_reg):
    """The Gram trick at β = 2, the generic autograd MU engine otherwise
    (``None`` lets the solver build it); accumulates in the operand dtype."""
    if beta == 2:
        return _beta2_updaters(gamma, l1_reg, l2_reg)
    return None


def resolve_nmf_updater_factory(device, dtype):
    """The factory for a fit of a ``dtype`` target on ``device``: float64
    takes the generic engine, a CUDA float32 or bfloat16 target the kernels,
    and any other target their plain versions."""
    if dtype == torch.float64:
        return nmf_updater_factory_generic
    if torch.device(device).type == "cuda":
        return nmf_updater_factory_fused
    return nmf_updater_factory_plain

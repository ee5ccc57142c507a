r"""Fused β-divergence MU contractions and loss (the port of
:mod:`pytorch_nmf_tpu.ops.pallas_mu`).

Per factor update of dense NMF at β ≠ 2:

    WH    = H Wᵀ                         (M, K)  — the reconstruction
    C     = f_β(V, WH)                   (M, K)  — elementwise cotangent
    neg_W = Cᵀ H   (K, R)   /   neg_H = C W   (M, R)
    pos_* = the same with g_β(WH)        (skipped at β=1: analytic)

On a CUDA tensor each wrapper launches the hand-written kernel of
``csrc/fused_mu.cu``, which keeps ``WH`` and ``C`` on chip.  On a CPU tensor
it runs the plain PyTorch version beside it (``plain_*``), which
materializes them.  There is no other dispatch: a CUDA tensor the kernel
does not take raises.

Each wrapper counts its kernel launches in a plain integer attribute,
``fused_contractions.launches`` and ``fused_beta_loss.launches``.
"""

import functools
from typing import Optional

import torch

from ..constants import eps

__all__ = [
    "aligned_rows",
    "fused_contractions",
    "w_side_contractions",
    "h_side_contractions",
    "fused_beta_loss",
    "plain_contractions",
    "plain_beta_loss",
]


def _cotangents(v, wh, beta: float, need_pos: bool):
    """Elementwise β-cotangents (mirrors pallas_mu._cotangent_tiles)."""
    if beta == 2:
        return v, (wh if need_pos else None)
    elif beta == 1:
        return v / (wh + eps), None
    elif beta == 0:
        r = 1.0 / (wh + eps)
        return r * r * v, (r if need_pos else None)
    whe = wh + eps
    p2 = whe ** (beta - 2)  # one pow, shared: whe^(β-1) = whe^(β-2)·whe
    return p2 * v, ((p2 * whe) if need_pos else None)


def _loss_terms(v, wh, beta: float):
    """Per-element β-divergence terms (mirrors pallas_mu._loss_kernel)."""
    if beta == 2:
        d = wh - v
        return 0.5 * d * d
    elif beta == 1:
        return v * (torch.log(v + eps) - torch.log(wh + eps)) - v + wh
    elif beta == 0:
        te, ie = v + eps, wh + eps
        return te / ie - torch.log(te) + torch.log(ie) - 1.0
    t = v + eps if beta < 0 else v
    ie = wh + eps
    ie_bm1 = ie ** (beta - 1)  # share: ie^β = ie^(β-1)·ie
    return (t**beta + (beta - 1) * ie_bm1 * ie - beta * t * ie_bm1) / (
        beta * (beta - 1)
    )


def plain_contractions(V, H, W, *, beta: float, need_pos: bool, w_side: bool,
                       mu_pos: Optional[torch.Tensor] = None):
    """Plain PyTorch version of :func:`fused_contractions`."""
    c_neg, c_pos = _cotangents(V, H @ W.T, beta, need_pos)
    other = H if w_side else W
    contract = (lambda c: c.T @ other) if w_side else (lambda c: c @ other)
    neg = contract(c_neg)
    if mu_pos is not None:
        factor = W if w_side else H
        return factor * ((torch.relu(neg) + eps) / mu_pos.reshape(1, -1)), None
    return neg, (contract(c_pos) if need_pos else None)


def plain_beta_loss(V, H, W, beta: float):
    """Plain PyTorch version of :func:`fused_beta_loss`."""
    return torch.sum(_loss_terms(V, H @ W.T, beta))


def aligned_rows(x):
    """``x`` (2-D) itself when its rows are contiguous and 16-byte aligned,
    as the kernels copy them, else the same values as a view of a copy whose
    rows are zero-padded to a multiple of 4 floats.  CPU tensors are
    returned as they are.  The dense fit pads V once per fit with it
    (``fast_nmf``): V = 5168×1025 has 4100-byte rows."""
    if x.device.type == "cpu" or (
            x.stride(1) == 1 and x.stride(0) % 4 == 0 and
            x.stride(0) >= x.shape[1] and x.data_ptr() % 16 == 0):
        return x
    return _padded(x)


def _padded(x):
    """A copy of ``x`` whose rows are zero-padded to a multiple of 4 floats
    (fresh storage, so 16-byte aligned), as a view of its first columns."""
    n = x.shape[1]
    buf = x.new_empty((x.shape[0], n + -n % 4))
    buf[:, :n] = x
    buf[:, n:] = 0
    return buf[:, :n]


def _factor_rows(F, G):
    """``F`` and ``G`` with 16-byte aligned rows and one row stride, which
    the kernels take for both."""
    F, G = aligned_rows(F), aligned_rows(G)
    if F.stride(0) != G.stride(0):
        F, G = _padded(F), _padded(G)
    return F, G


def _check_operands(V, H, W):
    """Raise on any CUDA operand the kernels do not take; returns M, K, R."""
    for name, x in (("V", V), ("H", H), ("W", W)):
        if x.device != V.device:
            raise ValueError(f"{name} is on {x.device}, V on {V.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"the fused kernels take float32; {name} is {x.dtype}")
        if x.ndim != 2 or x.stride(1) != 1 or x.stride(0) < x.shape[1]:
            raise ValueError(f"{name} must be a 2-D tensor with contiguous rows")
    M, K = V.shape
    R = H.shape[1]
    if H.shape != (M, R) or W.shape != (K, R):
        raise ValueError(
            f"shapes V {tuple(V.shape)}, H {tuple(H.shape)}, W {tuple(W.shape)}"
            " do not form V ~ H Wᵀ"
        )
    if M * K >= 2**31:
        raise ValueError(f"V has {M * K} elements; the kernels index with int32")
    return M, K, R


def _ptr(x):
    return None if x is None else x.data_ptr()


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def fused_contractions(V, H, W, *, beta: float, need_pos: bool, w_side: bool,
                       mu_pos: Optional[torch.Tensor] = None):
    """``(neg, pos)`` MU contractions of ``f_β(V, H Wᵀ)`` and ``g_β(H Wᵀ)``
    against ``H`` (``w_side``, outputs ``(K, R)``) or ``W`` (outputs
    ``(M, R)``); ``pos`` is ``None`` unless ``need_pos``.

    With ``mu_pos`` (the analytic β=1 denominator, ``R`` values) the first
    output is the updated factor ``f·(relu(neg)+eps)/mu_pos`` instead.
    """
    if mu_pos is not None and need_pos:
        raise ValueError("mu_pos (the β=1 epilogue) excludes need_pos")
    if V.device.type == "cpu":
        return plain_contractions(V, H, W, beta=beta, need_pos=need_pos,
                                  w_side=w_side, mu_pos=mu_pos)
    if V.device.type != "cuda":
        raise ValueError(f"no fused kernel for device {V.device}")
    from ._build import load_library

    M, K, R = _check_operands(V, H, W)
    lib = load_library("fused_mu")
    if mu_pos is not None:
        mu_pos = mu_pos.reshape(-1)
        if mu_pos.numel() != R or mu_pos.dtype != torch.float32 or \
                mu_pos.device != V.device:
            raise ValueError("mu_pos must hold R float32 values on V's device")
        mu_pos = mu_pos.contiguous()
    V = aligned_rows(V)
    F, G = _factor_rows(*((W, H) if w_side else (H, W)))
    n_f, n_g = F.shape[0], G.shape[0]
    splits = lib.pnt_contract_splits(n_f, n_g, R, _sm_count(V.device))

    # the outputs and, for more than one split, the partial slabs the second
    # pass sums: one allocation (each costs host time a small call feels)
    n_out = 1 + need_pos
    buf = torch.empty((n_out * (1 + (splits > 1) * splits), n_f, R),
                      device=V.device, dtype=torch.float32)
    out_neg, out_pos = buf[0], (buf[1] if need_pos else None)
    part_neg = buf[n_out:n_out + splits] if splits > 1 else None
    part_pos = buf[n_out + splits:] if splits > 1 and need_pos else None
    err = lib.pnt_fused_contractions(
        *(_ptr(x) for x in (V, F, G, mu_pos, out_neg, out_pos, part_neg,
                            part_pos)),
        n_f, n_g, R, V.stride(0), F.stride(0), int(not w_side), splits,
        float(beta), int(need_pos),
        torch.cuda.current_stream(V.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_contractions kernel launch failed: CUDA error {err}")
    fused_contractions.launches += 1
    return out_neg, out_pos


fused_contractions.launches = 0


def fused_beta_loss(V, H, W, beta: float):
    """``Σ β-divergence terms of (H Wᵀ, V)`` as a 0-d tensor; the
    reconstruction never reaches device memory on CUDA."""
    if V.device.type == "cpu":
        return plain_beta_loss(V, H, W, beta)
    if V.device.type != "cuda":
        raise ValueError(f"no fused kernel for device {V.device}")
    from ._build import load_library

    M, K, R = _check_operands(V, H, W)
    V = aligned_rows(V)
    H, W = _factor_rows(H, W)
    lib = load_library("fused_mu")
    splits = lib.pnt_loss_splits(M, K, R, _sm_count(V.device))
    partials = torch.empty(lib.pnt_loss_partials(M, splits), device=V.device,
                           dtype=torch.float32)
    out = torch.empty((), device=V.device, dtype=torch.float32)
    err = lib.pnt_fused_beta_loss(
        V.data_ptr(), H.data_ptr(), W.data_ptr(), partials.data_ptr(),
        out.data_ptr(), M, K, R, V.stride(0), H.stride(0), splits, float(beta),
        torch.cuda.current_stream(V.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_beta_loss kernel launch failed: CUDA error {err}")
    fused_beta_loss.launches += 1
    return out


fused_beta_loss.launches = 0


def w_side_contractions(V, H, W, beta: float, need_pos: bool = True):
    """``(neg_W, pos_W)`` = ``(f_β(V, HWᵀ)ᵀ H, g_β(HWᵀ)ᵀ H)``, each ``(K, R)``."""
    return fused_contractions(V, H, W, beta=beta, need_pos=need_pos, w_side=True)


def h_side_contractions(V, H, W, beta: float, need_pos: bool = True):
    """``(neg_H, pos_H)`` = ``(f_β(V, HWᵀ) W, g_β(HWᵀ) W)``, each ``(M, R)``."""
    return fused_contractions(V, H, W, beta=beta, need_pos=need_pos, w_side=False)

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

V may be float32 or bfloat16 (a target held at half width, which the
kernels upcast exactly as they read it); H, W and every output are float32.

Each wrapper counts its kernel launches in a plain integer attribute,
``fused_contractions.launches`` and ``fused_beta_loss.launches``, and the
launches of its bfloat16-V instance also in ``launches_bf16``.
"""

import functools
from typing import Optional

import torch

from ..constants import eps

__all__ = [
    "aligned_rows",
    "aligned_copy",
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


def _f32(V, like):
    """``V`` in the factors' dtype: a bfloat16 target upcast (exactly) as
    the kernels read it; any other as it is."""
    return V.to(like.dtype) if V.dtype == torch.bfloat16 else V


def plain_contractions(V, H, W, *, beta: float, need_pos: bool, w_side: bool,
                       mu_pos: Optional[torch.Tensor] = None):
    """Plain PyTorch version of :func:`fused_contractions`."""
    c_neg, c_pos = _cotangents(_f32(V, H), H @ W.T, beta, need_pos)
    other = H if w_side else W
    contract = (lambda c: c.T @ other) if w_side else (lambda c: c @ other)
    neg = contract(c_neg)
    if mu_pos is not None:
        factor = W if w_side else H
        return factor * ((torch.relu(neg) + eps) / mu_pos.reshape(1, -1)), None
    return neg, (contract(c_pos) if need_pos else None)


def plain_beta_loss(V, H, W, beta: float):
    """Plain PyTorch version of :func:`fused_beta_loss`."""
    return torch.sum(_loss_terms(_f32(V, H), H @ W.T, beta))


def _row_quantum(dtype) -> int:
    """Values of the float ``dtype`` in the 16 bytes the kernels copy at
    once."""
    return 128 // torch.finfo(dtype).bits


def aligned_rows(x):
    """``x`` (2-D) itself when its rows are contiguous and 16-byte aligned,
    as the kernels copy them, else the same values as a view of a copy whose
    rows are zero-padded to 16 bytes (:func:`aligned_copy`).  CPU tensors
    are returned as they are.  A target that reached the card through
    ``models._common.target_like`` is aligned already; a card tensor the
    caller passed in the fit's dtype with unaligned rows (V = 5168×1025
    float32: 4100-byte rows) is padded here, once per fit
    (``fast_nmf``)."""
    q = _row_quantum(x.dtype)
    if x.device.type == "cpu" or (
            x.stride(1) == 1 and x.stride(0) % q == 0 and
            x.stride(0) >= x.shape[1] and x.data_ptr() % 16 == 0):
        return x
    return _padded(x)


def aligned_copy(x, device, dtype):
    """``x`` (2-D, anywhere) on ``device`` in ``dtype`` as a view of the
    first columns of fresh storage whose rows are zero-padded to 16 bytes.
    A host ``x`` is padded on the host and copied to the card whole: a copy
    into a strided view on the card would stage a second, contiguous copy
    there."""
    n = x.shape[1]
    width = n + -n % _row_quantum(dtype)
    staging = torch.device(device) != x.device and x.device.type == "cpu"
    buf = torch.empty((x.shape[0], width), dtype=dtype,
                      device="cpu" if staging else device)
    buf[:, :n] = x
    buf[:, n:] = 0
    if staging:
        buf = buf.to(device)
    return buf[:, :n]


def _padded(x):
    """A copy of ``x`` whose rows are zero-padded to 16 bytes (fresh
    storage, so 16-byte aligned), as a view of its first columns."""
    return aligned_copy(x, x.device, x.dtype)


def _factor_rows(F, G):
    """``F`` and ``G`` with 16-byte aligned rows and one row stride, which
    the kernels take for both."""
    F, G = aligned_rows(F), aligned_rows(G)
    if F.stride(0) != G.stride(0):
        F, G = _padded(F), _padded(G)
    return F, G


def _check_operands(V, H, W):
    """Raise on any CUDA operand the kernels do not take (V float32 or
    bfloat16, H and W float32); returns M, K, R."""
    for name, x in (("V", V), ("H", H), ("W", W)):
        if x.device != V.device:
            raise ValueError(f"{name} is on {x.device}, V on {V.device}")
        ok = (torch.float32, torch.bfloat16) if name == "V" else (torch.float32,)
        if x.dtype not in ok:
            raise TypeError(f"the fused kernels take a float32 or bfloat16 V "
                            f"and float32 H and W; {name} is {x.dtype}")
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
        float(beta), int(need_pos), int(V.dtype == torch.bfloat16),
        torch.cuda.current_stream(V.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_contractions kernel launch failed: CUDA error {err}")
    fused_contractions.launches += 1
    fused_contractions.launches_bf16 += V.dtype == torch.bfloat16
    return out_neg, out_pos


fused_contractions.launches = 0
fused_contractions.launches_bf16 = 0


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
        int(V.dtype == torch.bfloat16),
        torch.cuda.current_stream(V.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_beta_loss kernel launch failed: CUDA error {err}")
    fused_beta_loss.launches += 1
    fused_beta_loss.launches_bf16 += V.dtype == torch.bfloat16
    return out


fused_beta_loss.launches = 0
fused_beta_loss.launches_bf16 = 0


def w_side_contractions(V, H, W, beta: float, need_pos: bool = True):
    """``(neg_W, pos_W)`` = ``(f_β(V, HWᵀ)ᵀ H, g_β(HWᵀ)ᵀ H)``, each ``(K, R)``."""
    return fused_contractions(V, H, W, beta=beta, need_pos=need_pos, w_side=True)


def h_side_contractions(V, H, W, beta: float, need_pos: bool = True):
    """``(neg_H, pos_H)`` = ``(f_β(V, HWᵀ) W, g_β(HWᵀ) W)``, each ``(M, R)``."""
    return fused_contractions(V, H, W, beta=beta, need_pos=need_pos, w_side=False)

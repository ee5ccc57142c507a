r"""Sparse targets for NMF (counterpart of :mod:`pytorch_nmf_tpu.ops.sparse`).

A sparse target is a coalesced ``torch.sparse_coo_tensor`` (the reference's
own sparse input type, torchnmf/nmf.py:162-170, 602-638).  The β-divergence
against it splits algebraically into

    loss = V_norm(V, β)  +  pos(W, H)  -  neg(W, H, V)

where ``V_norm`` depends only on the stored values, ``pos`` is a function of
the dense reconstruction (computable without materializing it: Gram
matrices, column sums, or row blocks), and ``neg`` touches the
reconstruction only at the non-zeros.  MU numerators and denominators are
the two scalars' gradients (reference ``_sp_double_backward_update``,
nmf.py:95-119), or closed forms of them.

The solver (:func:`~.solver.get_sparse_fit`) has three tiers, chosen at fit
entry (``models/nmf.py``):

* **densify** (:func:`should_densify`): the target fits the byte budget, so
  it is densified once and the dense updaters run;
* **ELL** (:func:`maybe_ell`): the dual padded-row layout, built on the
  target's device; every numerator is a dense reduction over one side's
  padded non-zeros, in blocks sized from the card's free memory;
* **gather**: ``torch.autograd.grad`` through the gathers of
  :func:`nmf_sp_pos_neg`.

Environment switches, as in the JAX package: ``PNT_SPARSE_DENSIFY`` (0/1
forces), ``PNT_SPARSE_DENSIFY_MAX_BYTES``, ``PNT_SPARSE_ELL`` (0 skips the
ELL tier), ``PNT_SPARSE_ELL_MAX_PAD``, ``PNT_SPARSE_ELL_MAX_BYTES``.
"""

import contextlib
import math
import os
import threading
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..constants import eps
from .budget import budget_bytes
from .graphs import _Counted

__all__ = [
    "SparseELL",
    "sparse_from_dense",
    "densify",
    "get_V_norm",
    "should_densify",
    "build_ell",
    "maybe_ell",
    "refresh_ell",
    "stage_bytes",
    "fixed_stage",
    "nmf_sp_pos_neg",
    "ell_neg_grad",
    "nmf_ell_pos_grad",
    "ell_neg_scalar",
    "nmf_ell_pos_scalar",
    "coo_rem_neg_grad",
    "coo_rem_neg_scalar",
]

# a CPU target's block stage; a CUDA target's is an eighth of the card's
# free memory
_CPU_STAGE_BYTES = 64 * 1024**2


def sparse_from_dense(V, threshold: float = 0.0) -> torch.Tensor:
    """The entries of ``V`` (a tensor or numpy array) strictly greater than
    ``threshold``, as a coalesced sparse COO tensor on ``V``'s device."""
    V = torch.as_tensor(V if isinstance(V, torch.Tensor) else np.asarray(V))
    mask = V > threshold
    # nonzero() lists row-major, so the indices come sorted and unique
    return torch.sparse_coo_tensor(mask.nonzero().T, V[mask], V.shape,
                                   is_coalesced=True, check_invariants=False)


def densify(V: torch.Tensor, out: Optional[torch.Tensor] = None):
    """The dense form of the sparse target (the densify tier's one copy);
    ``out``: written into that tensor instead (zeroed, then each non-zero
    added to its zero, as ``to_dense`` forms it), which is returned."""
    if out is None:
        return V.to_dense()
    out.zero_()
    return out.index_put_(tuple(V._indices()), V._values(), accumulate=True)


class SparseELL(NamedTuple):
    """Dual padded-row (ELL) layout of a 2-D sparse target, with COO
    remainders for degree-skewed data (the classic ELL+COO hybrid).

    ``row_idx``/``row_val`` hold, for every row ``i`` of V, the column ids
    and values of its non-zeros padded to the (capped) row width ``Lr``
    (pad entries: id 0, value 0); ``col_idx``/``col_val`` are the same over
    columns.  Each factor update reads its side contiguously.  Entries past
    the cap of a segment spill into ``row_rem``/``col_rem``, ``(seg_ids,
    other_ids, vals)`` triples (empty for near-uniform sparsity).  ``coo``
    is the originating target, which the cadence loss reads.
    ``row_src``/``col_src`` map each side's padded slots, then its spilled
    entries, to the position of their value in ``coo``'s values (``nnz``
    for a pad): :func:`refresh_ell` rewrites the values from them."""

    coo: torch.Tensor
    row_idx: torch.Tensor
    row_val: torch.Tensor
    col_idx: torch.Tensor
    col_val: torch.Tensor
    row_rem: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    col_rem: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    row_src: Optional[torch.Tensor] = None
    col_src: Optional[torch.Tensor] = None

    @property
    def shape(self):
        return self.coo.shape


def _ell_cap(nnz: int, n_seg: int, max_pad_factor=None) -> int:
    """Padded-width cap: ``max_pad_factor`` × the mean segment degree (env
    ``PNT_SPARSE_ELL_MAX_PAD``, default 4.0)."""
    if max_pad_factor is None:
        max_pad_factor = 4.0
    max_pad_factor = float(os.environ.get("PNT_SPARSE_ELL_MAX_PAD",
                                          max_pad_factor))
    return max(int(math.ceil(max_pad_factor * max(nnz, 1) / n_seg)), 1)


def _ell_side(seg_ids, other_ids, v, n_seg: int, cap: Optional[int] = None,
              src=None):
    """Pack one side, sorted by segment, into ``(n_seg, L)`` padded form on
    its device (``bincount``/``cumsum``/scatter).  Entries at in-segment
    positions ``>= cap`` spill into a COO remainder.  ``src`` (optional):
    each entry's position among the target's values.  Returns ``(idx_pad,
    val_pad, remainder, src_all)``: ``src_all`` (``None`` without ``src``)
    the padded slots' positions (the values' count for a pad), then the
    spilled entries'."""
    dev = seg_ids.device
    n_vals = v.numel()
    counts = torch.bincount(seg_ids, minlength=n_seg)
    Lmax = max(int(counts.max()) if seg_ids.numel() else 0, 1)
    pos = (torch.arange(seg_ids.numel(), device=dev)
           - (torch.cumsum(counts, 0) - counts)[seg_ids])
    if cap is not None and Lmax > cap:
        L = int(cap)
        spill = pos >= L
        rem = (seg_ids[spill].int(), other_ids[spill].int(), v[spill])
        rem_src = None if src is None else src[spill]
        keep = ~spill
        seg_ids, other_ids, v, pos = (seg_ids[keep], other_ids[keep], v[keep],
                                      pos[keep])
        src = None if src is None else src[keep]
    else:
        L = Lmax
        empty = torch.zeros(0, dtype=torch.int32, device=dev)
        # not v[:0]: a view of the target's values keeps the target alive
        rem = (empty, empty, v.new_zeros(0))
        rem_src = None if src is None else src.new_zeros(0)
    idx_pad = torch.zeros((n_seg, L), dtype=torch.int32, device=dev)
    val_pad = torch.zeros((n_seg, L), dtype=v.dtype, device=dev)
    idx_pad[seg_ids, pos] = other_ids.int()
    val_pad[seg_ids, pos] = v
    if src is None:
        return idx_pad, val_pad, rem, None
    src_pad = torch.full((n_seg, L), n_vals, dtype=src.dtype, device=dev)
    src_pad[seg_ids, pos] = src
    return idx_pad, val_pad, rem, torch.cat([src_pad.reshape(-1), rem_src])


def build_ell(V: torch.Tensor, max_pad_factor: float = 4.0):
    """The dual ELL(+COO) layout of the 2-D sparse ``V``, built on its
    device, or ``None`` when the padded layout's bytes (both sides, int32
    ids and 4-byte values) exceed the budget (``PNT_SPARSE_ELL_MAX_BYTES``,
    a quarter of the card, 4 GiB on the CPU; the JAX package's rule: the
    sources :func:`refresh_ell` reads add 4 bytes a slot beyond it).  The
    padded width per side is capped at ``max_pad_factor`` × the mean
    degree; uncoalesced input is coalesced (sorted) first."""
    if V.ndim != 2:
        return None
    V = V.coalesce()
    max_bytes = budget_bytes("PNT_SPARSE_ELL_MAX_BYTES", 4 * 1024**3, 0.25,
                             V.device)
    M, K = V.shape
    ii, jj = V.indices()
    vals = V.values()
    nnz = max(vals.numel(), 1)
    cap_r, cap_c = _ell_cap(nnz, M, max_pad_factor), _ell_cap(nnz, K, max_pad_factor)

    def width(ids, n, cap):
        deg = int(torch.bincount(ids, minlength=n).max()) if ids.numel() else 0
        return min(max(deg, 1), cap)

    if 8 * (M * width(ii, M, cap_r) + K * width(jj, K, cap_c)) > max_bytes:
        return None
    # the sources in int32 where the values' count (a pad's source) fits
    src = torch.arange(vals.numel(), device=V.device,
                       dtype=torch.int32 if vals.numel() < 2**31 - 1
                       else torch.int64)
    row_idx, row_val, row_rem, row_src = _ell_side(ii, jj, vals, M, cap_r,
                                                   src)
    order = torch.argsort(jj, stable=True)
    col_idx, col_val, col_rem, col_src = _ell_side(
        jj[order], ii[order], vals[order], K, cap_c, src[order])
    return SparseELL(V, row_idx, row_val, col_idx, col_val, row_rem, col_rem,
                     row_src, col_src)


def refresh_ell(ell: SparseELL) -> SparseELL:
    """Writes the current values of ``ell.coo`` into the layout's padded and
    spilled values, in place (their addresses stay, so a compiled fit that
    reads them stays valid): one gather over the non-zeros.  A layout whose
    target's values were changed in place (through ``_values()`` or
    ``.data``, which no version counter sees) holds the old ones until
    then.  A layout without its sources (``row_src`` ``None``) is left as
    it is."""
    if ell.row_src is None or ell.col_src is None:
        return ell
    vals = ell.coo._values()
    ext = torch.cat([vals, vals.new_zeros(1)])  # a pad's source: the zero
    for val_pad, rem, src in ((ell.row_val, ell.row_rem, ell.row_src),
                              (ell.col_val, ell.col_rem, ell.col_src)):
        got = ext[src]
        n = val_pad.numel()
        val_pad.view(-1).copy_(got[:n])
        rem[2].copy_(got[n:])
    return ell


def maybe_ell(V: torch.Tensor):
    """The ELL tier's entry decision: the built :class:`SparseELL`, or
    ``None`` for the gather tier (``PNT_SPARSE_ELL=0``, or a blown byte
    budget).  The layout is cached on the target tensor, keyed by the env
    configuration and the target's version (a target changed in place is
    laid out again), so repeated fits of one target build it once."""
    env = os.environ.get("PNT_SPARSE_ELL", "")
    if env == "0":
        return None
    key = (env, os.environ.get("PNT_SPARSE_ELL_MAX_PAD", ""),
           os.environ.get("PNT_SPARSE_ELL_MAX_BYTES", ""), V._version,
           V._values()._version, V._values().data_ptr())
    cached = getattr(V, "_pnt_ell_cache", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    ell = build_ell(V)
    V._pnt_ell_cache = (key, ell)
    return ell


def stage_bytes(device) -> int:
    """The bytes a block's stage may take: an eighth of the card's free
    memory (a fixed 64 MiB on the CPU)."""
    if torch.device(device).type == "cuda":
        return torch.cuda.mem_get_info(device)[0] // 8
    return _CPU_STAGE_BYTES


# the stage a fit fixed (fixed_stage), read in place of the card's free
# memory
_STAGE = threading.local()


@contextlib.contextmanager
def fixed_stage(nbytes: int):
    """Inside, the blocks are sized from ``nbytes`` (a fit's, read once at
    its start) rather than the card's free memory at each call: a captured
    chunk asks the card nothing, and every fit of a kept one blocks its
    rows as the chunk's graph does."""
    before = getattr(_STAGE, "nbytes", None)
    _STAGE.nbytes = nbytes
    try:
        yield
    finally:
        _STAGE.nbytes = before


def _block_rows(row_bytes: int, n_rows: int, device) -> int:
    """Rows per block so that a block's stage of ``row_bytes`` per row takes
    at most :func:`stage_bytes` (or the fit's :func:`fixed_stage`): one or
    a few blocks at the sizes a card holds."""
    budget = getattr(_STAGE, "nbytes", None)
    if budget is None:
        budget = stage_bytes(device)
    return max(1, min(n_rows, budget // max(row_bytes, 1)))


def _blocks(n_rows: int, rows: int):
    return ((s, min(s + rows, n_rows)) for s in range(0, n_rows, rows))


def _neg_coef(vals, wh, beta: float):
    """``vals · f'_β(WH)``: the numerator's weight of each non-zero."""
    if beta == 2:
        return vals
    if beta == 1:
        return vals / (wh + eps)
    return vals * (wh + eps) ** (beta - 2)


def _neg_term(wh, beta: float):
    """``f_β(WH)`` of the ``neg`` scalar (reference nmf.py:622-637)."""
    if beta == 2:
        return wh
    if beta == 1:
        return torch.log(wh + eps)
    return (wh + eps) ** (beta - 1) / (beta - 1)


def _ell_blocks(idx_pad, val_pad, self_f, other_f):
    """Yields ``(s0, s1, vals, oth, wh)`` per segment block: the other
    factor's gathered rows ``oth (b, L, R)`` and the reconstruction at the
    padded non-zeros ``wh (b, L)``."""
    n_seg, L = idx_pad.shape
    R = self_f.shape[1]
    rows = _block_rows(L * R * self_f.element_size(), n_seg, self_f.device)
    for s0, s1 in _blocks(n_seg, rows):
        oth = other_f[idx_pad[s0:s1]]
        wh = torch.bmm(oth, self_f[s0:s1, :, None])[..., 0]
        yield s0, s1, val_pad[s0:s1], oth, wh


def ell_neg_grad(idx_pad, val_pad, self_f, other_f, beta: float):
    """Gradient of the ``neg`` scalar with respect to the segment-side
    factor: ``Σ_l vals · f'_β(WH) · other[idx]``, a dense reduction over
    the padded axis (pad entries have value 0 and add nothing).
    ``ell_neg_grad.reductions`` counts its executions (a graphed fit's
    replays included, :mod:`.graphs`)."""
    ell_neg_grad.add("reductions")
    out = torch.empty_like(self_f)
    for s0, s1, vals, oth, wh in _ell_blocks(idx_pad, val_pad, self_f, other_f):
        out[s0:s1] = torch.bmm(_neg_coef(vals, wh, beta)[:, None, :], oth)[:, 0]
    return out


ell_neg_grad = _Counted(ell_neg_grad, on_card=("reductions",), reductions=0)


def ell_neg_scalar(idx_pad, val_pad, self_f, other_f, beta: float):
    """The ``neg`` loss scalar from one ELL side."""
    total = self_f.new_zeros(())
    for _, _, vals, _, wh in _ell_blocks(idx_pad, val_pad, self_f, other_f):
        total = total + torch.sum(vals * _neg_term(wh, beta))
    return total


def _wh_blocks(W, H):
    """Yields ``(i0, i1, WH[i0:i1])``: the dense reconstruction in row
    blocks sized by :func:`_block_rows`."""
    rows = _block_rows(W.shape[0] * H.element_size(), H.shape[0], H.device)
    for i0, i1 in _blocks(H.shape[0], rows):
        yield i0, i1, H[i0:i1] @ W.T


def nmf_ell_pos_grad(W, H, beta: float, want_H: bool):
    """Closed-form gradient of the ``pos`` scalar for ``V ≈ H Wᵀ`` with
    respect to H (``want_H``) or W.  β=2 by the Gram identity; other β (the
    solver handles β=1 analytically) stream row blocks of the dense
    reconstruction."""
    if beta == 2:
        return H @ (W.T @ W) if want_H else W @ (H.T @ H)
    if want_H:
        out = torch.empty_like(H)
        for i0, i1, wh in _wh_blocks(W, H):
            out[i0:i1] = (wh + eps) ** (beta - 1) @ W
        return out
    out = torch.zeros_like(W)
    for i0, i1, wh in _wh_blocks(W, H):
        out += ((wh + eps) ** (beta - 1)).T @ H[i0:i1]
    return out


def nmf_ell_pos_scalar(W, H, beta: float):
    """The ``pos`` loss scalar for ``V ≈ H Wᵀ`` (reference nmf.py:622-637)."""
    if beta == 2:
        return 0.5 * torch.sum((H @ (W.T @ W)) * H)
    if beta == 1:
        return W.sum(0) @ H.sum(0)
    total = H.new_zeros(())
    for _, _, wh in _wh_blocks(W, H):
        total = total + torch.sum((wh + eps) ** beta)
    return total / beta


def coo_rem_neg_grad(rem, self_f, other_f, beta: float):
    """The ``neg`` gradient of an ELL spill remainder (the over-cap tail),
    by gather and ``index_add_``: a ``self_f``-shaped tensor added to the
    ELL side's gradient before the relu/eps clamp."""
    seg_ids, oth_ids, vals = rem
    oth = other_f[oth_ids]
    wh = torch.sum(self_f[seg_ids] * oth, 1)
    return torch.zeros_like(self_f).index_add_(
        0, seg_ids, _neg_coef(vals, wh, beta)[:, None] * oth)


def coo_rem_neg_scalar(rem, self_f, other_f, beta: float):
    """The ``neg`` loss scalar of an ELL spill remainder."""
    seg_ids, oth_ids, vals = rem
    wh = torch.sum(self_f[seg_ids] * other_f[oth_ids], 1)
    return vals @ _neg_term(wh, beta)


def should_densify(V: torch.Tensor) -> bool:
    """Whether the sparse fit runs its densify tier: the dense target's
    bytes fit ``PNT_SPARSE_DENSIFY_MAX_BYTES`` (a quarter of the card, 4 GiB
    on the CPU).  ``PNT_SPARSE_DENSIFY`` 0/1 forces the answer."""
    env = os.environ.get("PNT_SPARSE_DENSIFY", "")
    if env in ("0", "1"):
        return env == "1"
    max_bytes = budget_bytes("PNT_SPARSE_DENSIFY_MAX_BYTES", 4 * 1024**3,
                             0.25, V.device)
    return V.element_size() * math.prod(V.shape) <= max_bytes


def get_V_norm(V: torch.Tensor, beta: float):
    """The V-only constant of the split β-divergence (reference
    ``_get_V_norm``, nmf.py:162-170)."""
    vals = V.values()
    if beta == 2:
        return vals @ vals * 0.5
    if beta == 1:
        return vals @ torch.log(vals) - torch.sum(vals)
    return torch.sum(vals**beta) / beta / (beta - 1)


def _gathered_dots(H, W, indices):
    """The reconstruction at the non-zeros, ``Σ_r H[i, r] W[j, r]``
    (reference ``_nmf_sparse_reconstruct``, nmf.py:602-614)."""
    return torch.sum(H[indices[0]] * W[indices[1]], 1)


def nmf_sp_pos_neg(V: torch.Tensor, H, W, beta: float, row_block: int = 512):
    """The ``(pos, neg)`` scalars of the split β-divergence for ``V ≈ H Wᵀ``,
    differentiable in ``H`` and ``W``: β=2 by the Gram identity, β=1 by
    column sums, other β stream the dense positive term over row blocks of
    ``H`` (reference ``_nmf_sp_recon_beta_pos_neg``, nmf.py:617-638)."""
    vals, indices = V.values(), V.indices()
    if beta == 2:
        pos = 0.5 * torch.sum((H @ (W.T @ W)) * H)
        return pos, vals @ _gathered_dots(H, W, indices)
    wh_vals = _gathered_dots(H, W, indices)
    if beta == 1:
        return W.sum(0) @ H.sum(0), vals @ torch.log(wh_vals + eps)
    pos = sum(torch.sum((H[i0:i0 + row_block] @ W.T + eps) ** beta)
              for i0 in range(0, H.shape[0], row_block))
    return pos / beta, vals @ (wh_vals + eps) ** (beta - 1) / (beta - 1)

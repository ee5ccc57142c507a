r"""MU updaters for the deconvolutional family NMFD/NMF2D/NMF3D
(counterpart of :mod:`pytorch_nmf_tpu.ops.fast_nmfd`'s fused engine,
``_deconv_pallas_updater_factory``), handed to the solver through its
``updater_factory`` argument.

Every heavy product of an update is a contraction over the patch matrix
``P[n, l, j·R + r] = Hpad[n, l - τ_j, r]`` of the activation:

    WH    = P @ W2                      (the reconstruction, τ-chunked GEMMs)
    neg_W = Pᵀ @ f_β(V, WH)             (:func:`~.fused_deconv.wgrad`)
    neg_H = fold(f_β(V, WH) @ W2ᵀ)      (:func:`~.fused_deconv.hgrad`)

with ``W2 = W`` in its flat GEMM layout ``(K·R, C)``.  The reconstruction
streams τ-chunks through ``torch.matmul``, as the JAX package leaves it to
XLA; the two contractions run the hand-written kernels on a CUDA target and
their plain versions elsewhere.  The kernel is carried in the ``W2`` layout
between iterations (``prepare``/``finish``), so the loop never relayouts it.

2-D and 3-D run the same kernels in the flat-offset mode: the activation is
zero-padded to the output widths on every trailing spatial axis and
flattened row-major, after which full N-D convolution is 1-D convolution at
flat offsets ``τ = Σ d_ax · stride_ax`` (:func:`~.fused_deconv.nd_geom`).
``N > 1`` stacks the batch into one sequence with ``T_geo - 1`` zero
separators per segment.

The same contractions are the adjoints of the reconstruction itself:
:func:`kernel_adjoint_deconv` is a ``torch.autograd.Function`` whose
backward runs them, which is what the SIPLCA family's EM E-step
differentiates (:func:`resolve_plca_recon3`), and the Hoyer fit of a deconv
model (:func:`resolve_hoyer_recon2`).

Beside the kernel engine (``"fused"``), the module holds the JAX package's
other MU engines; :mod:`.autotune` picks per fit by timing, on the card
between the kernel engines ``"fused"`` and ``"fused_w"`` (the others are
pinned there), on the CPU among all:

* the unfold engine (``"unfold"``, :func:`deconv_updater_factory_unfold`):
  the same contractions as ``torch.matmul`` GEMMs over the patch matrix,
  fully unrolled for ``K·R ≤ 4096`` and τ-chunked above; shapes past its
  memory budget (:func:`nmfd_unfold_supported`) take the generic engine;
* the hybrid (``"fused_w"``): B4 for the whole W side, the unfold engine's
  streamed fold for the H side, no B3;
* the β=2 autocorrelation engine (``"autocorr"``, 1-D, unrolled regime):
  the W denominator as ``(PᵀP) W2``, ``PᵀP`` built from the activation's
  lag autocorrelation (:func:`_h_autocorr_gram`);
* the FFT β=2 engine (``"fft"``, :mod:`.fft_nmfd`), opt-in.

:func:`unfold_deconv` is the unfold reconstruction as a differentiable
function, the EM and Hoyer tuners' ``"unfold"`` candidate.
"""

import itertools
import os

import torch

from ..constants import eps
from ..metrics import beta_div
from . import fused_deconv
from . import recon as _recon
from .budget import budget_bytes
from .fused_deconv import _CHUNK_COLS, _chunk_tc, _flat_T, nd_geom
from .mu import kl_pos_H, kl_pos_W, mu_cotangents, mu_multiplier, mu_update
from .recon import scaled_kernel

__all__ = [
    "deconv_updater_factory_fused",
    "deconv_updater_factory_fused_w",
    "deconv_updater_factory_plain",
    "deconv_updater_factory_unfold",
    "nmfd_unfold_updater_factory",
    "nmf2d_unfold_updater_factory",
    "nmf3d_unfold_updater_factory",
    "nmfd_autocorr_updater_factory",
    "nmfd_fft_updater_factory",
    "nmfd_unfold_supported",
    "autocorr_supported",
    "unfold_patches",
    "unfold_patches_nd",
    "unfold_deconv",
    "resolve_nmfd_updater_factory",
    "kernel_adjoint_deconv",
    "plain_adjoint_deconv",
    "resolve_plca_recon3",
    "resolve_hoyer_recon2",
]


def _prod(xs):
    out = 1
    for x in xs:
        out *= int(x)
    return out


def _kernel_dims(V_shape, H_shape):
    """Kernel extents from the target/activation shapes
    (``S_out = S_in + kernel - 1`` for every deconv model)."""
    return tuple(int(v) - int(h) + 1 for v, h in zip(V_shape[2:], H_shape[2:]))


def _tau_of_flat(f, kernel):
    """Per-axis τ components of a flat row-major kernel offset ``f``: the
    row-major digits of ``f`` over ``kernel``.  ``f`` may be an integer
    tensor, which gives one tensor of digits per axis."""
    taus, stride = [], _prod(kernel)
    for k in kernel:
        stride //= k
        taus.append((f // stride) % k)
    return tuple(taus)


def _pad_s_out(S_in, kernel):
    """Per-axis output extents of the full convolution."""
    return tuple(s + k - 1 for s, k in zip(S_in, kernel))


def _w2(W):
    """``W (C, R, *k)`` → ``(K·R, C)``, τ-major and rank-minor (a contiguous
    copy)."""
    C, d = W.shape[0], W.ndim - 2
    return W.permute(tuple(range(2, 2 + d)) + (1, 0)).reshape(-1, C).contiguous()


def _w_from_w2(W2, kernel, R: int):
    """Inverse of :func:`_w2`: ``(K·R, C)`` → ``(C, R, *kernel)``."""
    d, C = len(kernel), W2.shape[-1]
    full = W2.reshape(tuple(kernel) + (R, C))
    return full.permute((1 + d, d) + tuple(range(d))).contiguous()


def _kl_pos_w_rows(H, rows: int, sums=None):
    """Analytic β=1 denominator of the W update, tiled over the flat
    τ-major/rank-minor rows: ``(rows, 1)``.  ``sums``: the per-rank sums
    ``(R,)`` in place of ``H``'s own (the halo fits' all-reduced ones)."""
    s = kl_pos_W(H).reshape(-1) if sums is None else sums
    return s.repeat(rows // s.shape[0])[:, None]


def _kl_pos_h_ranks(w, R: int):
    """Analytic β=1 denominator of the H update from the GEMM-layout
    kernel: per-rank sums over every (τ, c) row."""
    return torch.sum(w.reshape(-1, R, w.shape[-1]), dim=(0, 2))


def _patch_chunk_fn(H, kernel, valid_last: bool = False):
    """Closure building the τ-chunk patch matrix of flat offsets
    ``[j0, j1)`` from the channels-last, full-padded activation:
    ``Pc[n, l_vec, (j-j0)·R + r] = H[n, r, l_vec - τ(j)]``.
    ``valid_last``: the trailing axis is not padded (VALID, the halo fits'
    activation, which carries its ``k - 1`` leading frames itself): its
    output extent is ``S_in - k + 1``.

    In 1-D each offset's rows are one contiguous slice, a view, so a chunk is
    one stack.  In N-D the slices are strided, a copy each; there one gather
    per chunk builds it (the flat index of ``l_vec - τ(j)`` in the padded
    grid is a per-position plus a per-offset term)."""
    N, R = H.shape[:2]
    nd = len(kernel)
    valid = [valid_last and ax == nd - 1 for ax in range(nd)]
    S_out = tuple(s - k + 1 if v else s + k - 1
                  for s, k, v in zip(H.shape[2:], kernel, valid))
    Lp, K = _prod(S_out), _prod(kernel)
    pads = []
    for k, v in zip(reversed(kernel), reversed(valid)):
        pads += [0, 0] if v else [k - 1, k - 1]
    Hp2 = torch.nn.functional.pad(H.movedim(1, -1), [0, 0] + pads)
    if len(kernel) == 1:
        T = kernel[0]

        def patch_chunk(j0: int, j1: int):
            return torch.stack([Hp2.narrow(1, T - 1 - j, Lp)
                                for j in range(j0, j1)], dim=2).reshape(N, Lp, -1)

        return patch_chunk
    Hp2 = Hp2.reshape(N, -1, R)  # the padded grid S_out + k - 1, flattened
    strides, acc = [], 1
    for so, k in zip(reversed(S_out), reversed(kernel)):
        strides.insert(0, acc)
        acc *= so + k - 1
    dev = H.device
    base = sum(d * st for d, st in zip(
        _tau_of_flat(torch.arange(Lp, device=dev), S_out), strides))
    shift = sum((k - 1 - t) * st for k, t, st in zip(
        kernel, _tau_of_flat(torch.arange(K, device=dev), kernel), strides))

    def patch_chunk(j0: int, j1: int):
        idx = base[:, None] + shift[None, j0:j1]
        return Hp2[:, idx.reshape(-1)].reshape(N, Lp, -1)

    return patch_chunk


def _stream_recon(w2, H, kernel, valid_last: bool = False):
    """Streaming-τ reconstruction ``WH2 (N, prod(S_out), C)`` from the flat
    kernel ``w2 (K·R, C)``: one GEMM per τ-chunk, accumulated in order
    (``valid_last``: :func:`_patch_chunk_fn`'s)."""
    R = H.shape[1]
    K = _prod(kernel)
    Tc = _chunk_tc(R, K)
    patch_chunk = _patch_chunk_fn(H, kernel, valid_last)
    WH2 = None
    for j0 in range(0, K, Tc):
        j1 = min(j0 + Tc, K)
        part = patch_chunk(j0, j1) @ w2[j0 * R:j1 * R]
        WH2 = part if WH2 is None else WH2 + part
    return WH2


def _v2_flat(V):
    """``V (N, C, *S_out)`` → channels-last ``(N, prod(S_out), C)``, a copy
    in V's dtype (a bfloat16 target's stays bfloat16: the cotangents
    promote it, and a product that reads it upcasts it by row blocks)."""
    return V.movedim(1, -1).reshape(V.shape[0], -1, V.shape[1]).contiguous()


def _flat_geom(V_shape, H_shape):
    """``(kernel, geom, T_geo, L_flat)`` of the flat-offset mode: the
    activation's trailing spatial axes padded to the output widths and
    flattened row-major (``geom=None`` and ``T_geo=T`` in 1-D)."""
    kernel = _kernel_dims(V_shape, H_shape)
    if len(kernel) == 1:
        return kernel, None, kernel[0], int(H_shape[2])
    s_pad = (int(H_shape[2]),) + tuple(
        int(s) + int(k) - 1 for s, k in zip(H_shape[3:], kernel[1:]))
    geom = nd_geom(kernel, s_pad)
    return kernel, geom, _flat_T(geom), _prod(s_pad)


def _h_padded_flat(H, kernel):
    """``(N, R, *S_in)`` → ``(N, L_flat, R)``: trailing spatial axes
    zero-padded to the output widths, row-major flatten."""
    pads = []
    for k in reversed(kernel[1:]):
        pads += [0, int(k) - 1]
    H2 = torch.nn.functional.pad(H.movedim(1, -1), [0, 0] + pads)
    return H2.reshape(H.shape[0], -1, H.shape[1]).contiguous()


def _h_flat_nd(H, kernel):
    """``(1, R, *S_in)`` → ``(L_flat, R)``, the flat-offset activation."""
    return _h_padded_flat(H, kernel)[0]


def _h_unflat_nd(out, H_shape, kernel):
    """``(R, L_flat)`` → ``(1, R, *S_in)``: undo :func:`_h_flat_nd` (crop the
    trailing-axis pads, whose columns carry no real cotangent)."""
    return _h_unflat_batched(out[None], H_shape, kernel)


def _h_unflat_batched(segs, H_shape, kernel):
    """``(N, R, L_flat)`` → ``(N, R, *S_in)``: the per-batch undo."""
    if len(kernel) == 1:
        return segs
    N, R = int(H_shape[0]), int(H_shape[1])
    s_pad = tuple(int(s) + (0 if d == 0 else int(kernel[d]) - 1)
                  for d, s in enumerate(H_shape[2:]))
    full = segs.reshape((N, R) + s_pad)
    for d, s in enumerate(H_shape[2:]):
        if d > 0:
            full = full.narrow(2 + d, 0, int(s))
    return full


def _h_stacked(H, kernel, T_geo: int):
    """Segment-stacked activation of the batched (N > 1) mode: each batch's
    flat-offset layout behind ``T_geo - 1`` zero rows, which absorb every
    cross-batch patch read exactly."""
    flat = torch.nn.functional.pad(_h_padded_flat(H, kernel),
                                   (0, 0, T_geo - 1, 0))
    return flat.reshape(-1, H.shape[1])


def _cot_stacked(cot, seg_stride: int):
    """``(N, Lp_flat, C)`` → ``(N·seg_stride, C)``: each segment zero-padded
    to the stacked activation's stride, so the flat patch relation holds
    across segments."""
    Lp_flat, C = cot.shape[1:]
    return torch.nn.functional.pad(
        cot, (0, 0, 0, seg_stride - Lp_flat)).reshape(-1, C)

# --------------------------------------------------------------------------
# The unfold engine (the JAX package's _deconv_unfold_updater_factory): the
# patch contractions as torch.matmul GEMMs, outside any kernel
# --------------------------------------------------------------------------
_DEFAULT_UNFOLD_MAX_BYTES = 2 * 1024**3
_UNFOLD_HBM_FRACTION = 0.125


def nmfd_unfold_supported(V_shape, W_shape, device=None) -> bool:
    """Whether the patch tensor of ``V (N, C, *S_out)`` and ``W (C, R,
    *kernel)`` (``4·N·prod(S_out)·K·R`` bytes) fits the unfold budget:
    ``PNT_NMFD_UNFOLD_MAX_BYTES``, else an eighth of a CUDA ``device``'s
    memory, else 2 GiB (:func:`~.budget.budget_bytes`).  A one-offset
    kernel is plain NMF and is not taken."""
    if len(V_shape) != len(W_shape) or len(V_shape) < 3:
        return False
    K = _prod(W_shape[2:])
    if K < 2:
        return False
    max_bytes = budget_bytes("PNT_NMFD_UNFOLD_MAX_BYTES",
                             _DEFAULT_UNFOLD_MAX_BYTES, _UNFOLD_HBM_FRACTION,
                             device)
    return 4 * int(V_shape[0]) * _prod(V_shape[2:]) * K * int(W_shape[1]) \
        <= max_bytes


def _unfold_mode(V_shape, H_shape, dtype, device) -> str:
    """``"unrolled"`` (``K·R ≤ 4096``: one patch matrix), ``"stream"``
    (τ-chunked GEMMs) or ``"none"`` (float64, or past the budget: the
    generic engine)."""
    if dtype == torch.float64:
        return "none"
    kernel = _kernel_dims(V_shape, H_shape)
    R = int(H_shape[1])
    if not nmfd_unfold_supported(tuple(V_shape), (int(V_shape[1]), R) + kernel,
                                 device):
        return "none"
    return "unrolled" if _prod(kernel) * R <= _CHUNK_COLS else "stream"


def unfold_patches_nd(H, kernel):
    """The patch matrix ``P[n, l_vec, τ_flat·R + r] = Hpad[n, l_vec - τ, r]``
    of ``H (N, R, *S_in)``: ``(N, prod(S_out), K·R)``."""
    return _patch_chunk_fn(H, tuple(kernel))(0, _prod(kernel))


def unfold_patches(H, T: int):
    """The 1-D patch matrix of ``H (N, R, L)``: ``P (N, L + T - 1, T·R)``
    (:func:`unfold_patches_nd` with ``kernel = (T,)``)."""
    return unfold_patches_nd(H, (T,))


def _fold_into(acc, G, j0: int, j1: int, kernel, R: int):
    """Overlap-add the chunk ``G (N, prod(S_out), (j1-j0)·R)`` of flat
    offsets ``[j0, j1)`` into ``acc (N, *S_in, R)``: ``acc[n, m_vec, r] +=
    Σ_j G[n, m_vec + τ(j), (j-j0)·R + r]``.  In 1-D the whole chunk is one
    strided view (consecutive offsets step by ``(j1-j0)·R + R``), summed
    over its offsets; in N-D one slice per offset."""
    N, S_in = acc.shape[0], acc.shape[1:-1]
    n = (j1 - j0) * R
    Lp = G.shape[1]
    if len(kernel) == 1:
        view = G.as_strided((N, S_in[0], j1 - j0, R), (Lp * n, n, n + R, 1),
                            G.storage_offset() + j0 * n)
        acc += view.sum(2)
        return
    S_out = _pad_s_out(S_in, kernel)
    G5 = G.reshape((N,) + S_out + (j1 - j0, R))
    for j in range(j0, j1):
        sl = G5[(slice(None),) * (1 + len(kernel)) + (j - j0,)]
        for ax, (t, s) in enumerate(zip(_tau_of_flat(j, kernel), S_in)):
            sl = sl.narrow(1 + ax, int(t), int(s))
        acc += sl


def _full_last(cot, S_in, kernel):
    """A cotangent of the VALID-trailing reconstruction of ``S_in`` (``(N,
    prod(S_valid), C)``) zero-padded by ``k - 1`` at both ends of its
    trailing axis: the full reconstruction's grid, on which the fold
    relation holds unchanged."""
    N, C = cot.shape[0], cot.shape[-1]
    kx = int(kernel[-1])
    grid = _pad_s_out(S_in[:-1], kernel[:-1]) + (int(S_in[-1]) - kx + 1,)
    c = cot.reshape((N,) + grid + (C,))
    return torch.nn.functional.pad(c, (0, 0, kx - 1, kx - 1)).reshape(N, -1, C)


def _unfold_h_contract(w2, cots, H, kernel, Tc: int, valid_last: bool = False):
    """The H-side contractions of the cotangents ``cots`` (each ``(N,
    prod(S_out), C)``): per τ-chunk one GEMM ``G = cot @ W2cᵀ``, folded
    (:func:`_fold_into`); ``Tc = K`` is the unrolled form.  Returns one
    ``(N, R, *S_in)`` tensor per cotangent.  ``valid_last``: the cotangents
    are of the VALID-trailing reconstruction (:func:`_patch_chunk_fn`'s), the
    result the contraction with respect to the whole (halo'd) ``H``."""
    N, R = H.shape[:2]
    K = _prod(kernel)
    if valid_last:
        cots = [_full_last(c, H.shape[2:], kernel) for c in cots]
    accs = [H.new_zeros((N,) + tuple(H.shape[2:]) + (R,)) for _ in cots]
    for j0 in range(0, K, Tc):
        j1 = min(j0 + Tc, K)
        w2c = w2[j0 * R:j1 * R]
        for acc, cot in zip(accs, cots):
            _fold_into(acc, cot @ w2c.T, j0, j1, kernel, R)
    return [a.movedim(-1, 1) for a in accs]


def _unfold_upd_h(H, w2, cots, kernel, Tc: int, beta, gamma, l1_reg, l2_reg):
    """The H update from the cotangents ``cots`` (``(neg, pos)``, ``pos``
    ``None`` at β=1) through the streamed fold (:func:`_unfold_h_contract`)."""
    R = H.shape[1]
    outs = _unfold_h_contract(w2, [c for c in cots if c is not None], H,
                              kernel, Tc)
    neg = torch.relu(outs[0]) + eps
    pos = (_kl_pos_h_ranks(w2, R).reshape((1, R) + (1,) * len(kernel))
           if beta == 1 else torch.relu(outs[1]) + eps)
    return H * mu_multiplier(neg, pos, H, gamma, l1_reg, l2_reg)


def _unfold_upd_w(V, w2, H, kernel, Tc: int, beta, gamma, l1_reg, l2_reg,
                  valid_last: bool = False, reduce=None, kl_sums=None):
    """The unfold W update in the ``W2`` layout: the reconstruction, the
    cotangents, then per τ-chunk ``Pcᵀ @ cot`` and the MU multiply of that
    chunk's rows (the numerator never exists whole, as in the JAX package's
    ``_stream_upd_w``).  ``Tc = K``: the unrolled form, one patch matrix
    serving the reconstruction too.

    The halo fits' hooks: ``valid_last`` (:func:`_patch_chunk_fn`'s);
    ``reduce(neg, pos)`` sums each chunk's raw contractions (``pos`` is
    ``None`` at β=1) over the ranks in place, before the clamps (the JAX
    package's ``psum_axis``); ``kl_sums`` the β=1 denominator's per-rank
    sums ``(R,)`` (:func:`_kl_pos_w_rows`)."""
    R, C = H.shape[1], V.shape[1]
    K = _prod(kernel)
    patch_chunk = _patch_chunk_fn(H, kernel, valid_last)
    if Tc >= K:
        P = patch_chunk(0, K)
        WH2 = P @ w2
    else:
        WH2 = _stream_recon(w2, H, kernel, valid_last)
    neg_cot, pos_cot = mu_cotangents(_v2_flat(V), WH2, beta)
    neg_cot = neg_cot.reshape(-1, C)
    pos_cot = None if pos_cot is None else pos_cot.reshape(-1, C)
    outs = []
    for j0 in range(0, K, Tc):
        j1 = min(j0 + Tc, K)
        Pc = (P if Tc >= K else patch_chunk(j0, j1)).reshape(-1, (j1 - j0) * R)
        neg = Pc.T @ neg_cot
        pos = None if beta == 1 else Pc.T @ pos_cot
        if reduce is not None:
            reduce(neg, pos)
        neg = torch.relu(neg) + eps
        pos = (_kl_pos_w_rows(H, (j1 - j0) * R, kl_sums) if beta == 1
               else torch.relu(pos) + eps)
        wc = w2[j0 * R:j1 * R]
        outs.append(wc * mu_multiplier(neg, pos, wc, gamma, l1_reg, l2_reg))
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def _unfold_recon(w2, H, kernel, Tc: int):
    """``WH2 (N, prod(S_out), C)``, unrolled (``Tc ≥ K``) or τ-chunked."""
    if Tc >= _prod(kernel):
        return unfold_patches_nd(H, kernel) @ w2
    return _stream_recon(w2, H, kernel)


def _unfold_updaters(spatial_ndim: int, beta, gamma, l1_reg, l2_reg):
    """The unfold engine's 5-arity updaters.  The kernel is carried in the
    ``W2 (K·R, C)`` layout in both modes; a ``"none"`` shape keeps the model
    layout and the generic autograd engine over ``recon.deconvNd``.  The
    mode is a function of the shapes, dtype and device, found once per
    fit."""
    nd = spatial_ndim
    deconv = getattr(_recon, f"deconv{nd}d")
    modes = {}

    def mode(V, H):
        if V.ndim != nd + 2 or H.ndim != nd + 2:
            raise ValueError(f"a {nd}-D deconv fit takes V (N, C, *S_out) and "
                             f"H (N, R, *S_in); got {tuple(V.shape)} and "
                             f"{tuple(H.shape)}")
        key = (tuple(V.shape), tuple(H.shape), V.dtype, V.device)
        if key not in modes:
            modes[key] = _unfold_mode(V.shape, H.shape, V.dtype, V.device)
        return modes[key]

    def tc(V, H):
        kernel = _kernel_dims(V.shape, H.shape)
        K = _prod(kernel)
        return kernel, (K if mode(V, H) == "unrolled"
                        else _chunk_tc(H.shape[1], K))

    def prepare(V, W, H):
        return (W, H) if mode(V, H) == "none" else (_w2(W), H)

    def finish(V, w, h):
        if mode(V, h) == "none":
            return w, h
        return _w_from_w2(w, _kernel_dims(V.shape, h.shape), h.shape[1]), h

    def upd_W(V, w, H):
        if mode(V, H) == "none":
            return mu_update(lambda x: deconv(H, x), V, w, beta, gamma, l1_reg,
                             l2_reg, kl_pos_W(H) if beta == 1 else None)
        kernel, Tc = tc(V, H)
        return _unfold_upd_w(V, w, H, kernel, Tc, beta, gamma, l1_reg, l2_reg)

    def upd_H(V, w, H):
        if mode(V, H) == "none":
            return mu_update(lambda x: deconv(x, w), V, H, beta, gamma, l1_reg,
                             l2_reg, kl_pos_H(w) if beta == 1 else None)
        kernel, Tc = tc(V, H)
        cots = mu_cotangents(_v2_flat(V), _unfold_recon(w, H, kernel, Tc), beta)
        return _unfold_upd_h(H, w, cots, kernel, Tc, beta, gamma, l1_reg,
                             l2_reg)

    def loss_terms(V, w, H):
        if mode(V, H) == "none":
            return beta_div(deconv(H, w), V, beta)
        kernel, Tc = tc(V, H)
        return beta_div(_unfold_recon(w, H, kernel, Tc), _v2_flat(V), beta)

    return upd_W, upd_H, loss_terms, prepare, finish


def unfold_deconv(H, W):
    """The full-padded deconvolution ``(N, C, *S_out)`` of ``recon.deconvNd``
    through the patch GEMMs (unrolled for ``K·R ≤ 4096``, τ-chunked above),
    as differentiable PyTorch operations: its adjoints are the patch
    contractions, which is what the EM E-step and the Hoyer steps
    differentiate.  float64 and shapes past the unfold budget take
    ``recon.deconvNd`` itself."""
    kernel = tuple(int(k) for k in W.shape[2:])
    N = H.shape[0]
    S_out = _pad_s_out(H.shape[2:], kernel)
    V_like = (N, W.shape[0]) + S_out
    if H.dtype == torch.float64 or W.dtype == torch.float64 or \
            not nmfd_unfold_supported(V_like, tuple(W.shape), H.device):
        return getattr(_recon, f"deconv{len(kernel)}d")(H, W)
    K, R = _prod(kernel), H.shape[1]
    WH2 = _unfold_recon(_w2(W), H, kernel, K if K * R <= _CHUNK_COLS
                        else _chunk_tc(R, K))
    return WH2.reshape((N,) + S_out + (W.shape[0],)).movedim(-1, 1)


# --------------------------------------------------------------------------
# The β=2 autocorrelation engine (the JAX package's
# nmfd_autocorr_updater_factory): 1-D, unrolled regime only
# --------------------------------------------------------------------------
def autocorr_supported(V_shape, H_shape, dtype, device=None) -> bool:
    """Whether the autocorrelation engine takes this fit: a 1-D float32
    problem (its target float32 or bfloat16) in the unfold engine's
    unrolled regime."""
    return (len(V_shape) == 3 and len(H_shape) == 3
            and dtype in (torch.float32, torch.bfloat16)
            and _unfold_mode(V_shape, H_shape, dtype, device) == "unrolled")


def _h_autocorr_gram(H, T: int):
    """The patch Gram ``G = PᵀP`` of the 1-D patch matrix from the
    activation's lag autocorrelation, ``O(R²·T·L)`` operations instead of
    ``O((T·R)²·L)``: ``G[τ·R+r, τ'·R+r'] = A[r, r', τ-τ']`` with ``A[r, r',
    δ] = Σ_{n,u} H[n,r,u]·H[n,r',u+δ]`` (``A[·,·,-δ] = A[·,·,δ]ᵀ``); the
    patch's zero borders make every lag sum run over the whole support, so
    the Gram is block-Toeplitz in the lag.  The lag table is built in blocks
    of shifted windows of at most 64 MB."""
    N, R, L = H.shape
    blk = max(1, min(T, 64 * 1024**2 // max(1, N * R * L * 4)))
    nb = -(-T // blk)
    Hp = torch.nn.functional.pad(H, (0, nb * blk))
    parts = []
    for b in range(nb):
        d0 = b * blk
        S = torch.stack([Hp[:, :, d0 + d:d0 + d + L] for d in range(blk)],
                        dim=2)  # S[n, r', d, u] = Hp[n, r', u + d0 + d]
        parts.append(torch.einsum("nru,nsdu->rsd", H, S))
    A_half = torch.cat(parts, dim=-1)[..., :T]  # (R, R', T), δ ≥ 0
    # the whole lag table at index δ + T - 1; negative lags by symmetry
    A_full = torch.cat([A_half.transpose(0, 1)[..., 1:].flip(-1), A_half],
                       dim=-1)
    lag = torch.arange(T, device=H.device)
    G4 = A_full[:, :, lag[:, None] - lag[None, :] + T - 1]  # (R, R', T, T')
    return G4.permute(2, 0, 3, 1).reshape(T * R, T * R)


def nmfd_autocorr_updater_factory(beta, gamma, l1_reg, l2_reg):
    """β=2 NMFD updaters whose W denominator is ``(PᵀP) W2``
    (:func:`_h_autocorr_gram`) instead of the reconstruction's correlation
    with the patches: ``O(R²·T·L + C·R²·T²)`` against ``O(2·C·R·T·L)``,
    cheaper where ``R·T < L``.  The W numerator, the whole H update, the
    loss and the layout hooks are the unfold engine's, so the trajectories
    differ from it by float32 summation order only.  β=2 only (else
    ``ValueError``); ``upd_W`` raises outside the 1-D float32 unrolled
    regime (:func:`autocorr_supported`)."""
    if beta != 2:
        raise ValueError("the autocorrelation engine is β=2-only")
    _, upd_H, loss_terms, prepare, finish = _unfold_updaters(
        1, beta, gamma, l1_reg, l2_reg)

    def upd_W(V, w, H):
        if not autocorr_supported(V.shape, H.shape, V.dtype, V.device):
            raise ValueError(
                "the autocorrelation engine takes 1-D float32 fits in the "
                "unfold engine's unrolled regime (K·R <= 4096, within the "
                "unfold budget)")
        T = w.shape[0] // H.shape[1]
        P = unfold_patches_nd(H, (T,)).reshape(-1, w.shape[0])
        neg = torch.relu(_recon.matmul(
            P.T, _v2_flat(V).reshape(-1, V.shape[1]))) + eps
        pos = torch.relu(_h_autocorr_gram(H, T) @ w) + eps
        return w * mu_multiplier(neg, pos, w, gamma, l1_reg, l2_reg)

    return upd_W, upd_H, loss_terms, prepare, finish


def nmfd_fft_updater_factory(beta, gamma, l1_reg, l2_reg):
    """NMFD updaters with the opt-in FFT engine at β=2
    (:mod:`.fft_nmfd`); every other β takes the unfold engine."""
    if beta == 2:
        from .fft_nmfd import fft_beta2_updater_factory

        return fft_beta2_updater_factory(gamma, l1_reg, l2_reg)
    return _unfold_updaters(1, beta, gamma, l1_reg, l2_reg)


def _contractions(kernels: str):
    """``(hgrad, wgrad)``: the kernel wrappers (``"fused"``) or their plain
    versions (``"plain"``)."""
    if kernels == "fused":
        return fused_deconv.hgrad, fused_deconv.wgrad
    return fused_deconv.plain_hgrad, fused_deconv.plain_wgrad


def _deconv_updaters(spatial_ndim: int, kernels: str, beta, gamma, l1_reg,
                     l2_reg, h_side: str = "kernel"):
    """The 5-arity ``(upd_W, upd_H, loss_terms, prepare, finish)`` updaters
    of the ``spatial_ndim`` deconv model over the hand-written kernels
    (``kernels="fused"``: the wrappers) or their plain versions.
    ``h_side="stream"`` is the hybrid: the H side runs the unfold engine's
    streamed fold (:func:`_unfold_h_contract`) instead of ``hgrad``."""
    hgrad, wgrad = _contractions(kernels)
    nd = spatial_ndim
    fused_w = beta == 1 and gamma == 1 and l1_reg == 0 and l2_reg == 0

    def _dims(V, H):
        if V.ndim != nd + 2 or H.ndim != nd + 2:
            raise ValueError(f"a {nd}-D deconv fit takes V (N, C, *S_out) and "
                             f"H (N, R, *S_in); got {tuple(V.shape)} and "
                             f"{tuple(H.shape)}")
        return _flat_geom(V.shape, H.shape)

    def prepare(V, W, H):
        _dims(V, H)
        return _w2(W), H

    def finish(V, w, h):
        return _w_from_w2(w, _kernel_dims(V.shape, h.shape), h.shape[1]), h

    def _cots(V, w, H, kernel):
        return mu_cotangents(_v2_flat(V), _stream_recon(w, H, kernel), beta)

    def upd_W(V, w, H):
        kernel, geom, T_geo, L_flat = _dims(V, H)
        R = H.shape[1]
        cots = [c for c in _cots(V, w, H, kernel) if c is not None]
        if H.shape[0] > 1:
            H2, lead = _h_stacked(H, kernel, T_geo), False
            cots = [_cot_stacked(c, T_geo - 1 + L_flat) for c in cots]
        else:
            H2, lead = _h_flat_nd(H, kernel), True
            cots = [c[0] for c in cots]
        if fused_w:
            # fully fused KL update: the kernel applies the MU multiply after
            # its reduction and returns the updated kernel operand
            return wgrad(cots, H2, R, T_geo, mu_w2=w,
                         mu_pos=kl_pos_W(H).reshape(-1), lead_pad=lead,
                         geom=geom)[0]
        # β ≠ 1: the neg/pos pair shares one pass over the patches
        outs = wgrad(cots, H2, R, T_geo, lead_pad=lead, geom=geom)
        neg = torch.relu(outs[0]) + eps
        pos = (_kl_pos_w_rows(H, w.shape[0]) if beta == 1
               else torch.relu(outs[1]) + eps)
        return w * mu_multiplier(neg, pos, w, gamma, l1_reg, l2_reg)

    def upd_H(V, w, H):
        kernel, geom, T_geo, L_flat = _dims(V, H)
        N, R = H.shape[:2]
        neg_cot, pos_cot = _cots(V, w, H, kernel)
        if h_side == "stream":
            return _unfold_upd_h(H, w, (neg_cot, pos_cot), kernel,
                                 _chunk_tc(R, _prod(kernel)), beta, gamma,
                                 l1_reg, l2_reg)
        if N > 1:
            # one hgrad over all N segments; each segment's trailing columns
            # (reads past its real cotangent) are cropped
            seg = T_geo - 1 + L_flat

            def h_contract(cot):
                out = hgrad(_cot_stacked(cot, seg), w, R, N * seg, geom=geom)
                segs = out.reshape(R, N, seg)[:, :, :L_flat].movedim(1, 0)
                return _h_unflat_batched(segs, H.shape, kernel)
        else:
            def h_contract(cot):
                return _h_unflat_nd(hgrad(cot[0], w, R, L_flat, geom=geom),
                                    H.shape, kernel)

        neg = torch.relu(h_contract(neg_cot)) + eps
        if beta == 1:
            pos = _kl_pos_h_ranks(w, R).reshape((1, R) + (1,) * nd)
        else:
            pos = torch.relu(h_contract(pos_cot)) + eps
        return H * mu_multiplier(neg, pos, H, gamma, l1_reg, l2_reg)

    def loss_terms(V, w, H):
        return beta_div(_stream_recon(w, H, _kernel_dims(V.shape, H.shape)),
                        _v2_flat(V), beta)

    return upd_W, upd_H, loss_terms, prepare, finish


def _make_factory(spatial_ndim: int, engine: str):
    def factory(beta, gamma, l1_reg, l2_reg):
        if engine == "unfold":
            return _unfold_updaters(spatial_ndim, beta, gamma, l1_reg, l2_reg)
        if engine == "fused_w":
            return _deconv_updaters(spatial_ndim, "fused", beta, gamma,
                                    l1_reg, l2_reg, h_side="stream")
        return _deconv_updaters(spatial_ndim, engine, beta, gamma, l1_reg,
                                l2_reg)

    factory.__name__ = factory.__qualname__ = (
        f"deconv{spatial_ndim}d_updater_factory_{engine}")
    return factory


_FACTORIES = {
    (nd, engine): _make_factory(nd, engine)
    for nd, engine in itertools.product(
        (1, 2, 3), ("fused", "plain", "fused_w", "unfold"))
}


def deconv_updater_factory_fused(spatial_ndim: int):
    """The ``spatial_ndim`` deconv model's factory over the kernel wrappers
    (the CUDA kernels on a CUDA target)."""
    return _FACTORIES[spatial_ndim, "fused"]


def deconv_updater_factory_plain(spatial_ndim: int):
    """The same updaters through the kernels' plain PyTorch versions on any
    device."""
    return _FACTORIES[spatial_ndim, "plain"]


def deconv_updater_factory_fused_w(spatial_ndim: int):
    """The hybrid: B4 (``wgrad``) for the W side, the streamed fold for the
    H side (no ``hgrad``)."""
    return _FACTORIES[spatial_ndim, "fused_w"]


def deconv_updater_factory_unfold(spatial_ndim: int):
    """The unfold engine (``torch.matmul`` patch GEMMs, no kernel)."""
    return _FACTORIES[spatial_ndim, "unfold"]


nmfd_unfold_updater_factory = _FACTORIES[1, "unfold"]
nmf2d_unfold_updater_factory = _FACTORIES[2, "unfold"]
nmf3d_unfold_updater_factory = _FACTORIES[3, "unfold"]


def _kernels_off() -> bool:
    """``PNT_NMFD_PALLAS=0``: the static choice is the unfold engine."""
    return os.environ.get("PNT_NMFD_PALLAS", "") == "0"


def resolve_nmfd_updater_factory(device, dtype, spatial_ndim: int = 1):
    """The factory for a fit of a ``dtype`` target on ``device``, without
    timing: float64 takes the generic autograd engine (``None``), a CUDA
    float32 or bfloat16 target the kernels (B3/B4 read the float32
    cotangents), and any other target their plain versions; under
    ``PNT_NMFD_PALLAS=0`` the unfold engine."""
    if dtype == torch.float64:
        return None
    if _kernels_off():
        return deconv_updater_factory_unfold(spatial_ndim)
    if torch.device(device).type == "cuda":
        return deconv_updater_factory_fused(spatial_ndim)
    return deconv_updater_factory_plain(spatial_ndim)


def _adjoint_deconv(kernels: str):
    """The full deconvolution ``(H, Wz) → (N, C, *S_out)`` as a
    ``torch.autograd.Function`` (counterpart of the JAX package's
    ``_make_pallas_unfold_deconv``): forward streams the τ-chunked GEMMs
    (:func:`_stream_recon`), backward runs ``dH`` through ``hgrad`` and
    ``dWz`` through ``wgrad`` (one cotangent, no epilogue), in the flat
    layout of the MU updaters (segment-stacked for ``N > 1``), each only
    when its input needs a gradient."""
    hgrad, wgrad = _contractions(kernels)

    class AdjointDeconv(torch.autograd.Function):
        @staticmethod
        def forward(ctx, H, Wz):
            kernel = tuple(int(k) for k in Wz.shape[2:])
            w2 = _w2(Wz)
            ctx.save_for_backward(H, w2)
            ctx.kernel = kernel
            WH2 = _stream_recon(w2, H, kernel)  # (N, prod(S_out), C)
            S_out = _pad_s_out(H.shape[2:], kernel)
            return WH2.movedim(-1, 1).reshape(
                (H.shape[0], Wz.shape[0]) + S_out)

        @staticmethod
        @torch.autograd.function.once_differentiable
        def backward(ctx, ct):
            H, w2 = ctx.saved_tensors
            kernel = ctx.kernel
            N, R = H.shape[:2]
            need_H, need_W = ctx.needs_input_grad
            _, geom, T_geo, L_flat = _flat_geom(ct.shape, H.shape)
            # one channels-last copy of the cotangent per backward; each
            # wrapper pads its channels to a multiple of 4 once per call
            cot = _v2_flat(ct)  # (N, Lp_flat, C)
            seg = T_geo - 1 + L_flat
            cot = _cot_stacked(cot, seg) if N > 1 else cot[0]
            # only the contractions asked for: a one-factor gradient (Hoyer's
            # steps, the MU engine) runs one kernel, the E-step both
            dH = dW = None
            if need_H:
                out = hgrad(cot, w2, R, N * seg if N > 1 else L_flat, geom=geom)
                if N > 1:
                    segs = out.reshape(R, N, seg)[:, :, :L_flat].movedim(1, 0)
                    dH = _h_unflat_batched(segs, H.shape, kernel)
                else:
                    dH = _h_unflat_nd(out, H.shape, kernel)
            if need_W:
                if N > 1:
                    H2, lead = _h_stacked(H, kernel, T_geo), False
                else:
                    H2, lead = _h_flat_nd(H, kernel), True
                dW2 = wgrad([cot], H2, R, T_geo, lead_pad=lead, geom=geom)[0]
                dW = _w_from_w2(dW2, kernel, R)
            return dH, dW

    AdjointDeconv.__name__ = AdjointDeconv.__qualname__ = (
        f"AdjointDeconv_{kernels}")
    return AdjointDeconv


_ADJOINT = {kernels: _adjoint_deconv(kernels) for kernels in ("fused", "plain")}


def kernel_adjoint_deconv(H, Wz):
    """Full N-D deconvolution of ``H (N, R, *S_in)`` by ``Wz (C, R, *k)``
    whose adjoints are the kernel wrappers ``hgrad``/``wgrad`` (the CUDA
    kernels on a CUDA tensor).  float32."""
    return _ADJOINT["fused"].apply(H, Wz)


def plain_adjoint_deconv(H, Wz):
    """:func:`kernel_adjoint_deconv` with the kernels' plain versions as its
    adjoints, on any device."""
    return _ADJOINT["plain"].apply(H, Wz)


def _make_recon3(spatial_ndim: int, kernels: str):
    deconv = {"fused": kernel_adjoint_deconv, "plain": plain_adjoint_deconv,
              "unfold": unfold_deconv}[kernels]

    def recon3(H, W, Z):
        return deconv(H, scaled_kernel(W, Z, spatial_ndim))

    recon3.__name__ = recon3.__qualname__ = (
        f"siplca{spatial_ndim}d_recon3_{kernels}")
    return recon3


_RECON3 = {
    (nd, kernels): _make_recon3(nd, kernels)
    for nd, kernels in itertools.product((1, 2, 3),
                                         ("fused", "plain", "unfold"))
}


def resolve_plca_recon3(cls, device, dtype):
    """The EM reconstruction ``recon3(H, W, Z)`` of a SIPLCA-family fit of a
    ``dtype`` target on ``device`` (the static counterpart of the JAX
    package's autotuned ``resolve_plca_recon3``): float64 takes the model's
    convolution ``cls.reconstruct`` under autograd, a CUDA float32 target
    the kernel-adjoint deconvolution, any other float32 target its plain
    twin; under ``PNT_NMFD_PALLAS=0`` float32 takes the unfold
    deconvolution."""
    if dtype == torch.float64:
        return cls.reconstruct
    if _kernels_off():
        return _RECON3[cls._spatial_ndim, "unfold"]
    kernels = "fused" if torch.device(device).type == "cuda" else "plain"
    return _RECON3[cls._spatial_ndim, kernels]


def resolve_hoyer_recon2(cls, device, dtype):
    """The reconstruction ``recon2(H, W)`` a deconv model's Hoyer fit
    differentiates, for a ``dtype`` target on ``device`` (the static
    counterpart of the JAX package's autotuned ``resolve_hoyer_recon2``):
    float64 takes the model's convolution ``cls.reconstruct`` under
    autograd, a CUDA float32 target :func:`kernel_adjoint_deconv` (B3/B4 as
    its adjoints), any other float32 target its plain twin; under
    ``PNT_NMFD_PALLAS=0`` float32 takes :func:`unfold_deconv`."""
    if dtype == torch.float64:
        return cls.reconstruct
    if _kernels_off():
        return unfold_deconv
    if torch.device(device).type == "cuda":
        return kernel_adjoint_deconv
    return plain_adjoint_deconv

r"""Fused deconvolutional MU contractions (the port of
:mod:`pytorch_nmf_tpu.ops.pallas_deconv`).

The deconv MU engine (:mod:`.fast_nmfd`) keeps the kernel in its flat GEMM
layout ``W2 (K·R, C)`` (row ``j·R + r`` holds ``W[:, r, τ_j]``), the
cotangents channels-last ``(Lp, C)`` and the activation length-major
``(L_h, R)``.  Its two heavy contractions are:

* :func:`hgrad`, the H side: ``out[r, l'] = Σ_{j, c} cot[l'+τ_j, c] ·
  W2[j·R+r, c]`` — the fold of ``G = cot @ W2ᵀ``, written as a correlation;
* :func:`wgrad`, the W side: ``out[j·R+r, c] = Σ_l Hp[l+T-1-τ_j, r] ·
  cot[l, c]`` — ``Pᵀ @ cot`` for the patch matrix ``P`` of ``Hp``, the
  activation with ``T-1`` leading zero rows (``lead_pad``) or carrying them
  already (``lead_pad=False``).

``τ_j = j`` in 1-D; 2-D/3-D run the flat-offset mode (:func:`nd_geom`,
``geom=(kdims, strides)``).  Reads outside the operands are zeros.

On a CUDA tensor each wrapper launches the hand-written kernel of
``csrc/fused_deconv.cu``, which never builds ``P`` or ``G`` in device
memory.  On a CPU tensor it runs the plain PyTorch version beside it
(``plain_*``), which builds them chunk by chunk of τ, as the JAX stream
engine does.  There is no other dispatch: a CUDA tensor the kernel does
not take raises.  Each wrapper counts its kernel launches in an integer
attribute, ``hgrad.launches`` and ``wgrad.launches``;
``hgrad.launches_gemm`` counts those of hgrad's small-rank regime, and
``hgrad.launches_windowed`` those of them that ran in windows along the
output columns (past the slab cap): counts of a
:class:`~.graphs._Counted`, which a replayed fit's device loop keeps on
the card until they are next read.

Unlike the Pallas kernels, the port's kernel operand carries no τ-tile
padding: ``W2`` has exactly ``K·R`` rows, and so do :func:`wgrad`'s outputs.
"""

import functools
from typing import NamedTuple, Optional, Sequence

import torch

from ..constants import eps
from .fused_mu import _sm_count, aligned_rows
from .graphs import _Counted

__all__ = [
    "hgrad",
    "wgrad",
    "plain_hgrad",
    "plain_wgrad",
    "nd_geom",
]

# a chunk of the plain versions' P or G holds at most this many columns (and
# at most _CHUNK_TAUS offsets): the flagship's whole P or G is ~0.7 GB each
_CHUNK_COLS = 4096
_CHUNK_TAUS = 64


def _chunk_tc(R: int, K: int) -> int:
    """τ offsets per chunk (``fast_nmfd._chunk_tc`` of the JAX package)."""
    return min(max(min(_CHUNK_COLS // R, _CHUNK_TAUS), 1), K)


def _flat_tau(flat: int, geom) -> int:
    """Flat kernel-offset index → flattened-activation offset: the row-major
    mixed-radix digits of ``flat`` over ``kdims`` dotted with ``strides``.
    ``None`` is the 1-D identity."""
    if geom is None:
        return flat
    kdims, strides = geom
    tau, rem = 0, flat
    for k, s in zip(reversed(kdims), reversed(strides)):
        tau += (rem % k) * s
        rem //= k
    return tau


def nd_geom(kernel, s_pad):
    """``(kdims, strides)`` for an N-D problem whose activation is padded to
    the output widths on every trailing spatial axis and flattened
    row-major: full N-D convolution then equals 1-D convolution at flat
    offsets ``τ = Σ d_ax · stride_ax``, the wrap-around reads landing in the
    zero-pad columns.  ``s_pad``: the padded activation's spatial extents."""
    strides, acc = [], 1
    for s in reversed(tuple(s_pad)):
        strides.append(acc)
        acc *= int(s)
    return tuple(int(k) for k in kernel), tuple(reversed(strides))


def _flat_T(geom) -> int:
    """Geometric kernel extent on the flattened axis: ``max real τ + 1``."""
    kdims, strides = geom
    return sum((k - 1) * s for k, s in zip(kdims, strides)) + 1


def _taus(K: int, geom):
    return [_flat_tau(j, geom) for j in range(K)]


def _kernel_rows(T: int, geom) -> int:
    """K, the flat kernel rows: ``T`` in 1-D, ``prod(kdims)`` in N-D."""
    if geom is None:
        return int(T)
    K = 1
    for k in geom[0]:
        K *= int(k)
    return K


def plain_hgrad(cot2, W2, R: int, L_in: int, geom=None):
    """Plain PyTorch version of :func:`hgrad`: per τ-chunk one GEMM
    ``G = cot @ W2cᵀ``, overlap-added into the ``(L_in, R)`` accumulator
    (``fast_nmfd._stream_h_contract`` of the JAX package)."""
    Lp, C = cot2.shape
    K = W2.shape[0] // R
    taus = _taus(K, geom)
    rows = max(Lp, max(taus) + L_in)
    cotp = torch.nn.functional.pad(cot2, (0, 0, 0, rows - Lp))
    out = torch.zeros(L_in, R, dtype=cot2.dtype, device=cot2.device)
    Tc = _chunk_tc(R, K)
    for j0 in range(0, K, Tc):
        j1 = min(j0 + Tc, K)
        G = cotp @ W2[j0 * R:j1 * R].T  # (rows, (j1-j0)·R), contiguous
        n = (j1 - j0) * R
        # offsets of consecutive τ fold as one strided view each: G[τ_a+i+l,
        # a+i, r] steps by n+R over i
        a = j0
        while a < j1:
            b = a + 1
            while b < j1 and taus[b] == taus[b - 1] + 1:
                b += 1
            view = G.as_strided((L_in, b - a, R), (n, n + R, 1),
                                G.storage_offset() + taus[a] * n + (a - j0) * R)
            out += view.sum(1)
            a = b
    return out.T.contiguous()


def plain_wgrad(cots2: Sequence[torch.Tensor], H2, R: int, T: int,
                mu_w2: Optional[torch.Tensor] = None,
                mu_pos: Optional[torch.Tensor] = None,
                lead_pad: bool = True, geom=None):
    """Plain PyTorch version of :func:`wgrad`: per τ-chunk the patch matrix
    ``Pc`` is stacked from slices of the padded activation (contiguous views
    in every rank, the layout being flat) and contracted, ``Pcᵀ @ cot`` (the
    patch einsum of ``fast_nmfd._stream_upd_w``)."""
    Lp = cots2[0].shape[0]
    K = _kernel_rows(T, geom)
    taus = _taus(K, geom)
    lead = T - 1 if lead_pad else 0
    Hp = torch.nn.functional.pad(
        H2, (0, 0, lead, max(0, Lp + T - 1 - lead - H2.shape[0])))
    Tc = _chunk_tc(R, K)
    parts = [[] for _ in cots2]
    for j0 in range(0, K, Tc):
        j1 = min(j0 + Tc, K)
        Pc = torch.stack([Hp[T - 1 - taus[j]:T - 1 - taus[j] + Lp]
                          for j in range(j0, j1)], dim=1).reshape(Lp, -1)
        for part, cot in zip(parts, cots2):
            part.append(Pc.T @ cot)
    outs = [torch.cat(p, dim=0) for p in parts]
    if mu_w2 is not None:
        pos = mu_pos.reshape(-1).repeat(K)[:, None]
        return [mu_w2 * ((torch.relu(outs[0]) + eps) / pos)]
    return outs


def _check(name, x, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != torch.float32:
        raise TypeError(f"the fused kernels take float32; {name} is {x.dtype}")
    if x.ndim != 2 or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 2-D tensor")


def _geom_args(K: int, geom):
    """``(k0, k1, k2, s0, s1, s2)``: the kernel's three-digit offset map
    ``τ_j = Σ ((j / (k_{d+1}·…)) mod k_d)·s_d``; 1-D is ``(1, 1, K)``."""
    if geom is None:
        return (1, 1, K, 0, 0, 1)
    kdims, strides = (tuple(int(v) for v in x) for x in geom)
    if not 1 <= len(kdims) <= 3 or len(kdims) != len(strides):
        raise ValueError(f"geom {geom}: 1 to 3 kernel dims with one stride each")
    pad = 3 - len(kdims)
    return (1,) * pad + kdims + (0,) * pad + strides


def _check_int32(**sizes):
    for name, n in sizes.items():
        if n >= 2**31:
            raise ValueError(f"{name} spans {n} elements; the kernels index "
                             "with int32")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# hgrad's launch geometry (csrc/fused_deconv.cu):
# * "gemm", ranks ≤ 16: G rows a block (two warpgroups of two m64 tiles),
#   the wgmma widths N it instantiates, channels a stage, and the most
#   stages one block sums in one accumulator (a run of 17·12 wgmmas: the
#   tensor cores' truncation stays under 2.5e-5 of the value; C = 1028 is
#   two runs);
# * "tc", the tensor-core kernel of larger ranks: l' rows, reduction depth
#   and ranks of a block.
_GEMM_ROWS = 256
_GEMM_WIDTHS = (32, 64, 96, 128)
_GEMM_DEPTH = 32
_GEMM_CHAIN = 17
_GEMM_MIN_RUN = 4  # fewest stages a split, where more splits fill the card
_TC_ROWS, _TC_DEPTH, _TC_RANKS = 128, 32, 128
_MAX_SLAB_FLOATS = 1 << 26  # the partial slabs stay under 256 MB
_REGIMES = {"tc": 0, "gemm": 1}
# the gemm regime's cost model of one block's channel: its tensor-core
# cycles (GM·N·6 TF32 operations at 2048 an SM a cycle, the H100's 495
# TFLOP/s) or its L2 bytes (the cotangent rows, the hi/lo W2 tiles) at
# about 24 an SM a cycle, whichever is longer
_SM_TF32_PER_CYCLE = 2048
_SM_L2_BYTES_PER_CYCLE = 24


class HgradPlan(NamedTuple):
    """One :func:`hgrad` launch: ``regime`` "gemm" (ranks ≤ 16: groups of
    ``group`` offsets consecutive along the kernel's innermost axis, ``bm``
    output columns a block, N = 8·``nt`` (offset, rank) columns) or "tc"
    (the tensor-core kernel of larger ranks, ``nt`` rank tiles of 8);
    ``splits`` of ``sper`` steps each (gemm: 32-channel stages; tc: 32-deep
    steps of k = j·C + c); ``groups·splits`` partial slabs of ``(R,
    window)`` when above 1, summed by a second pass in a fixed order;
    ``wsplit``: the floats of the gemm regime's hi/lo W2 tiles; ``window``:
    the output columns one launch of the kernel covers (a multiple of
    ``bm`` below ``L_in``; 0: all of them), window after window
    (:func:`_hgrad_windows`), the slabs under the cap."""
    regime: str
    nt: int
    group: int
    bm: int
    groups: int
    splits: int
    sper: int
    wsplit: int
    window: int = 0

    @property
    def slabs(self) -> int:
        return self.groups * self.splits


def _tc_nt(R: int) -> int:
    """The tensor-core kernel's instance covering a block of ``R`` ranks
    (wgmma widths 8·NT: 16, 32, 64, 88, 96, 128)."""
    nt = _cdiv(min(R, _TC_RANKS), 8)
    return next(n for n in (2, 4, 8, 11, 12, 16) if nt <= n)


def _tc_plan(R, L_in, C, K, num_sms):
    """Splits of the tensor-core kernel's reduction: about four waves of two
    blocks an SM, at least 8 steps a split, slabs under the cap."""
    steps = _cdiv(K * C, _TC_DEPTH)
    tiles = _cdiv(L_in, _TC_ROWS) * _cdiv(R, _TC_RANKS)
    s = min(_cdiv(8 * num_sms, tiles), max(1, steps // 8))
    if s * R * L_in > _MAX_SLAB_FLOATS:
        s = _MAX_SLAB_FLOATS // (R * L_in)
    sper = _cdiv(steps, max(s, 1))
    return HgradPlan("tc", _tc_nt(R), 1, _TC_ROWS, 1, _cdiv(steps, sper),
                     sper, 0, L_in)


def _gemm_plans(R, L_in, C, K, g, num_sms):
    """Every launch of the gemm regime this shape takes, with its modelled
    cost: for each wgmma width, the most offsets whose (offset, rank)
    columns fit it, within one run of the innermost kernel axis and with a
    span that leaves a block at least half its rows of output.  The channel
    stages split into runs of at most _GEMM_CHAIN, and into more (of at
    least _GEMM_MIN_RUN) while the blocks would fill the card's SMs less
    than twice.  Where the slabs of the whole length would pass
    _MAX_SLAB_FLOATS, the launch runs in windows of whole blocks along
    ``L_in``, each window's slabs under the cap."""
    k0, k1, k2, s0, s1, s2 = g
    stages = _cdiv(C, _GEMM_DEPTH)
    plans = {}
    for width in _GEMM_WIDTHS:
        J = min(width // R, k2)
        if s2 > 0:
            J = min(J, (_GEMM_ROWS // 2) // s2 + 1)
        if J < 1:
            continue
        N = next(w for w in _GEMM_WIDTHS if w >= J * R)
        bm = _GEMM_ROWS - (J - 1) * s2
        groups = k0 * k1 * _cdiv(k2, J)
        blocks = _cdiv(L_in, bm) * groups
        splits = max(_cdiv(stages, _GEMM_CHAIN),
                     min(_cdiv(2 * num_sms, blocks),
                         _cdiv(stages, _GEMM_MIN_RUN)))
        sper = _cdiv(stages, splits)
        splits = _cdiv(stages, sper)
        window = L_in
        if groups * splits * R * L_in > _MAX_SLAB_FLOATS:
            window = _MAX_SLAB_FLOATS // (groups * splits * R) // bm * bm
            if window < bm:
                continue
        cycles = max(6 * _GEMM_ROWS * N / _SM_TF32_PER_CYCLE,
                     (4 * _GEMM_ROWS + 8 * N) / _SM_L2_BYTES_PER_CYCLE)
        cost = blocks * cycles
        plans[J] = (cost, HgradPlan("gemm", N // 8, J, bm, groups, splits,
                                    sper, groups * stages * 2 * N *
                                    _GEMM_DEPTH, window))
    return [plans[J] for J in sorted(plans, reverse=True)]


def _hgrad_windows(p: HgradPlan, L_in: int):
    """``[(l0, l1)]``: the output columns of each launch of the plan ``p``,
    in order.  Window ``[l0, l1)`` reads the cotangent from row ``l0`` on
    (its rows ``[l0, l1 + max τ)``) and writes output columns ``[l0,
    l1)``.  A gemm window starts at a multiple of ``bm``, so each output
    column falls in the same block row, offset group and channel split as
    in one launch over all of ``L_in``: the same sums in the same order,
    bit for bit."""
    w = p.window or L_in
    return [(l0, min(l0 + w, L_in)) for l0 in range(0, L_in, w)]


@functools.lru_cache(maxsize=256)
def _hgrad_plan(R: int, L_in: int, C: int, K: int, g, num_sms: int) -> HgradPlan:
    """The launch of :func:`hgrad` for ``R`` ranks, ``L_in`` output columns,
    ``C`` channels (the padded row stride), ``K`` offsets and the offset map
    ``g = (k0, k1, k2, s0, s1, s2)`` (:func:`_geom_args`) on a card of
    ``num_sms`` SMs.  Ranks ≤ 16 take the "gemm" regime at its cheapest
    modelled group (the largest on ties), in windows along ``L_in`` where
    the slabs of the whole length would pass the cap; larger ranks the
    "tc" kernel."""
    if R <= 16:
        plans = _gemm_plans(R, L_in, C, K, g, num_sms)
        if plans:
            return min(plans, key=lambda cp: cp[0])[1]
    return _tc_plan(R, L_in, C, K, num_sms)


def hgrad(cot2, W2, R: int, L_in: int, geom=None, plan=None):
    """``out (R, L_in)``: ``out[r, l'] = Σ_{j, c} cot2[l'+τ_j, c] ·
    W2[j·R+r, c]``, with ``cot2 (Lp, C)`` read as zero past row ``Lp`` and
    ``W2 (K·R, C)``.  ``geom``: the N-D flat-offset map (:func:`nd_geom`).
    ``plan`` forces a launch (:class:`HgradPlan`; a measurement's knob),
    else :func:`_hgrad_plan` chooses; a plan with windows launches the
    kernel once a window (:func:`_hgrad_windows`), reusing one buffer of
    partial slabs."""
    if cot2.device.type == "cpu":
        return plain_hgrad(cot2, W2, R, L_in, geom)
    if cot2.device.type != "cuda":
        raise ValueError(f"no fused kernel for device {cot2.device}")
    from ._build import load_library

    dev = cot2.device
    _check("cot2", cot2, dev)
    _check("W2", W2, dev)
    Lp, C = cot2.shape
    if W2.shape[1] != C or W2.shape[0] % R or W2.shape[0] == 0 or L_in < 1:
        raise ValueError(f"W2 {tuple(W2.shape)} is not (K·{R}, {C})")
    K = W2.shape[0] // R
    g = _geom_args(K, geom)
    if g[0] * g[1] * g[2] != K:
        raise ValueError(f"geom {geom} does not have {K} kernel offsets")
    # the kernels copy 16 bytes at a time: channels padded with zeros to a
    # multiple of 4 (C = 1025 costs two ~20 µs copies), which join the
    # reduction as zeros; both operands get the same row stride
    cot2, W2 = aligned_rows(cot2), aligned_rows(W2)
    C = cot2.stride(0)
    _check_int32(W2=K * R * C, cot2=Lp * C)
    lib = load_library("fused_deconv")
    p = plan or _hgrad_plan(R, L_in, C, K, g, _sm_count(dev))
    windows = _hgrad_windows(p, L_in)
    span = windows[0][1]  # the widest window's columns
    if len(windows) > 1 and (p.regime != "gemm" or span % p.bm):
        raise ValueError(f"plan {p}: windows are whole gemm blocks")
    _check_int32(slabs=p.slabs * R * span, wsplit=p.wsplit)

    def empty(*shape):
        return torch.empty(shape, device=dev, dtype=torch.float32)

    out = empty(R, L_in)
    part = empty(p.slabs, R, span) if p.slabs > 1 else None
    wsplit = empty(p.wsplit) if p.wsplit else None
    for i, (l0, l1) in enumerate(windows):
        if l0 >= Lp:  # every cotangent row it reads is past Lp: zeros
            out[:, l0:l1] = 0
            continue
        # the window's cotangent rows from l0, its output columns from l0
        err = lib.pnt_hgrad(cot2.data_ptr() + 4 * l0 * C, W2.data_ptr(),
                            out.data_ptr() + 4 * l0,
                            None if part is None else part.data_ptr(),
                            None if wsplit is None else wsplit.data_ptr(),
                            Lp - l0, C, R, K, l1 - l0, L_in, *g,
                            _REGIMES[p.regime], p.nt, p.group, p.bm, p.groups,
                            p.splits, p.sper, int(i == 0), _stream(dev))
        if err != 0:
            raise RuntimeError(f"hgrad kernel launch failed: CUDA error {err}")
    hgrad.add("launches")
    hgrad.add("launches_gemm", int(p.regime == "gemm"))
    hgrad.add("launches_windowed", int(len(windows) > 1))
    return out


# launches_gemm: of them, the gemm regime's (ranks ≤ 16); launches_windowed:
# of those, the ones in windows along L_in
hgrad = _Counted(hgrad, on_card=("launches", "launches_gemm",
                                 "launches_windowed"),
                 launches=0, launches_gemm=0, launches_windowed=0)


def wgrad(cots2: Sequence[torch.Tensor], H2, R: int, T: int,
          mu_w2: Optional[torch.Tensor] = None,
          mu_pos: Optional[torch.Tensor] = None,
          lead_pad: bool = True, geom=None):
    """``outs``, one ``(K·R, C)`` per cotangent: ``out[j·R+r, c] = Σ_l
    Hp[l+T-1-τ_j, r] · cot[l, c]`` for each of the one or two ``(Lp, C)``
    cotangents, which share every patch load.  ``H2 (L_h, R)`` is the
    length-major activation, ``Hp`` it with ``T-1`` leading zero rows
    (``lead_pad``) or as it is (``lead_pad=False``, the segment-stacked
    layout that carries its own separators), zero past its end.  ``T`` is the
    kernel's (geometric, in N-D) flat extent.

    ``mu_w2 (K·R, C)`` + ``mu_pos (R,)``: the β=1 epilogue (one cotangent);
    the output is then the updated kernel ``mu_w2·(relu(neg)+eps)/pos``.
    """
    if mu_w2 is not None and len(cots2) != 1:
        raise ValueError("mu_w2 (the β=1 epilogue) takes one cotangent")
    if not 1 <= len(cots2) <= 2:
        raise ValueError("wgrad takes one or two cotangents")
    if H2.device.type == "cpu":
        return plain_wgrad(cots2, H2, R, T, mu_w2, mu_pos, lead_pad, geom)
    if H2.device.type != "cuda":
        raise ValueError(f"no fused kernel for device {H2.device}")
    from ._build import load_library

    dev = H2.device
    _check("H2", H2, dev)
    for i, c in enumerate(cots2):
        _check(f"cots2[{i}]", c, dev)
    Lp, C = cots2[0].shape
    if any(c.shape != (Lp, C) for c in cots2) or H2.shape[1] != R:
        raise ValueError("cotangents must share one (Lp, C) shape and H2 be (L, R)")
    K = _kernel_rows(T, geom)
    g = _geom_args(K, geom)
    # the largest offset, without listing all K (host time a small call feels)
    if (K if geom is None else _flat_T(geom)) > T:
        raise ValueError(f"geom {geom} reaches past the flat extent T={T}")
    if mu_w2 is not None:
        _check("mu_w2", mu_w2, dev)
        if mu_w2.shape != (K * R, C):
            raise ValueError(f"mu_w2 {tuple(mu_w2.shape)} is not ({K * R}, {C})")
        if mu_pos is None or mu_pos.numel() != R or \
                mu_pos.dtype != torch.float32 or mu_pos.device != dev:
            raise ValueError("mu_pos must hold R float32 values on H2's device")
        mu_pos = mu_pos.reshape(-1).contiguous()
    L_h = H2.shape[0]
    # the cotangents' rows are copied 16 bytes at a time (channels padded as
    # hgrad's); the kernel reads only the first C of each
    cots2 = [aligned_rows(c) for c in cots2]
    ldc = cots2[0].stride(0)
    _check_int32(out=K * R * C, cots2=Lp * ldc, H2=L_h * R)
    lib = load_library("fused_deconv")
    n = len(cots2)
    splits = lib.pnt_wgrad_splits(K * R, C, Lp, n, _sm_count(dev))
    _check_int32(slabs=splits * K * R * C)

    def empty(*shape):
        return torch.empty(shape, device=dev, dtype=torch.float32)

    outs = [empty(K * R, C) for _ in cots2]
    parts = [empty(splits, K * R, C) if splits > 1 else None for _ in cots2]

    def ptr(xs, i):
        return xs[i].data_ptr() if i < len(xs) and xs[i] is not None else None

    err = lib.pnt_wgrad(
        H2.data_ptr(), ptr(cots2, 0), ptr(cots2, 1),
        None if mu_w2 is None else mu_w2.data_ptr(),
        None if mu_w2 is None else mu_pos.data_ptr(),
        ptr(outs, 0), ptr(outs, 1), ptr(parts, 0), ptr(parts, 1),
        L_h, Lp, C, ldc, R, K, 0 if lead_pad else T - 1, *g, splits,
        _stream(dev),
    )
    if err != 0:
        raise RuntimeError(f"wgrad kernel launch failed: CUDA error {err}")
    wgrad.add("launches")
    return outs


wgrad = _Counted(wgrad, on_card=("launches",), launches=0)

r"""Sequence-parallel deconvolutional NMF and SIPLCA by halo exchange
(counterpart of :mod:`pytorch_nmf_tpu.parallel.halo`).

The trailing spatial axis (time, for NMFD) is sharded over a ``seq`` mesh
dimension.  ``H`` is zero-padded from ``L_in`` to ``L_pad = n · chunk``
and ``V`` from ``L_out`` to ``L_pad``, with ``chunk = max(ceil(L_out /
n), T - 1)``, so every rank holds one chunk of both and its left
neighbour's last ``T - 1`` frames suffice (padded H entries are MU and EM
fixed points; at fractional β the padded cells' constant loss is
subtracted from the cadence loss).

Per rank and iteration one halo exchange to the right, shared by both
updates (the W update reads the old H): :func:`left_halo` prepends the
left neighbour's last ``T - 1`` activation frames, or :func:`halo_recv`
returns them alone (the split conv form).  The reconstruction is VALID
along the halo'd axis and full along the leading spatial axes, which stay
local.  Every W-side contraction is a partial sum over the rank's chunk:
it is all-reduced raw, before the ``relu``/``eps`` clamps (the relu of a
partial sum is not the relu of the sum).  The H-side contraction's first
``T - 1`` frames belong to the left neighbour: :func:`halo_adjoint` (or
:func:`halo_adjoint_strip`) sends them back, one exchange to the left per
contraction.  The per-shard modes (the JAX package's names in brackets):

* ``"fused"`` (``"pallas"``): the W side is B4 (``wgrad``) with
  ``lead_pad=False`` on the halo'd activation, no β=1 epilogue (it would
  clamp a partial sum), the neg/pos pair in one call at β ≠ 1; the H side
  B3 (``hgrad``).  2-D/3-D run both kernels in their flat-offset mode
  (:class:`_Layout`), ``N > 1`` stacks the batches along the flat axis;
* ``"fused_w"`` (``"pallas_w"``): B4 for the W side as in ``"fused"``, the
  unfold engine's τ-chunked fold (``torch.matmul`` GEMMs) for the H side:
  no B3;
* ``"stream"``: both sides τ-chunked ``torch.matmul`` GEMMs, each chunk's
  W contractions all-reduced before its clamps (long kernels, ``K·R >
  4096``);
* ``"unrolled"``: the reconstruction as one patch GEMM
  (:func:`_unfold_halo_nd`), both sides by ``torch.autograd.grad``;
* ``"conv"``: the reconstruction as ``F.convNd`` in the split form
  (:func:`_conv_halo_split_nd`: the activation at its shard width, the
  received frames through a strip GEMM; the concat form
  :func:`_conv_halo_nd` where ``T = 1``), both sides by
  ``torch.autograd.grad``.

The library modes (``stream``, ``unrolled``, ``conv``) launch no kernel.
How a fit picks its mode (:func:`_resolve_halo_mode`, the JAX package's
rules): ``PNT_NMFD_PALLAS=1`` takes ``"fused"``; on a CUDA float32 mesh
(the kernel path) ``"fused"``, timed against ``"fused_w"`` above
``PNT_AUTOTUNE_MIN_FLOPS``; on the CPU or under ``PNT_NMFD_PALLAS=0`` the
memory heuristic :func:`_halo_unfold_mode` (``PNT_HALO_UNFOLD``,
``PNT_NMFD_UNFOLD_MAX_BYTES``), with ``"unrolled"`` timed against
``"conv"`` above the threshold; ``PNT_NMFD_AUTOTUNE=0`` times nothing.
Rank 0 of the ``seq`` dimension alone resolves (and times, on its own
local problem without collectives:
:func:`~..ops.autotune.autotune_halo_mode`) and broadcasts the name, so
every rank runs the same collectives.

The SIPLCA family's EM differentiates the reconstruction behind
:func:`left_halo`, whose backward is :func:`halo_adjoint`: ``"fused"`` is
a ``torch.autograd.Function`` whose backward is B3 and B4 in the
:class:`_Layout` layout (the only mode on the card), ``"unrolled"`` and
``"conv"`` (concat form) differentiate :func:`_unfold_halo_nd` and
:func:`_conv_halo_nd`; the EM has no streamed form, so where the
heuristic says ``"stream"`` it runs ``"conv"``, as the JAX package's
does.  The W and Z gradients are partial sums,
all-reduced after ``autograd.grad``.  On CPU tensors the kernels' plain
versions run in place of B3/B4.
"""

import os

import numpy as np
import torch
import torch.nn.functional as F

from ..constants import eps
from ..metrics import beta_div, kl_div
from ..models._common import host_tensor, target_dtype
from ..ops import autotune, fused_deconv
from ..ops.budget import budget_bytes
from ..ops.fast_nmfd import (_DEFAULT_UNFOLD_MAX_BYTES, _UNFOLD_HBM_FRACTION,
                             _kl_pos_h_ranks, _patch_chunk_fn, _prod,
                             _stream_recon, _unfold_h_contract, _unfold_upd_w,
                             _v2_flat, _w2, _w_from_w2)
from ..ops.fused_deconv import _CHUNK_COLS, _chunk_tc, _flat_T, nd_geom
from ..ops.mu import gamma_from_beta, mu_cotangents
from ..ops.recon import matmul, scaled_kernel
from ..ops.solver import (_converging_loop, _plca_e_step, _plca_m_step,
                          _plca_marginal_sum, alpha_is_active)
from .comm import comm_for
from .sharded import (_alpha, _mu_step, _reporter, as_dtensor, mesh_device,
                      placements)

__all__ = [
    "left_halo",
    "halo_adjoint",
    "halo_recv",
    "halo_adjoint_strip",
    "sharded_nmfd_fit",
    "sharded_nmf2d_fit",
    "sharded_nmf3d_fit",
    "sharded_siplca_fit",
    "sharded_siplca2_fit",
    "sharded_siplca3_fit",
]

# the per-shard modes of the MU fits and of the SIPLCA family's EM
MU_MODES = ("fused", "fused_w", "stream", "unrolled", "conv")
EM_MODES = ("fused", "unrolled", "conv")


def _strip_adjoint(gh, gr, halo: int, comm):
    """``gh`` plus, on its last ``halo`` frames, the ``gr`` that the next
    rank sends back (the last rank receives zeros); this rank's ``gr`` goes
    to the previous one."""
    out = gh.clone()
    L = out.shape[-1]
    out[..., L - halo:] += comm.shift_left(gr)
    return out


def _adjoint(g, halo: int, comm):
    return _strip_adjoint(g[..., halo:], g[..., :halo], halo, comm)


class _LeftHalo(torch.autograd.Function):
    """``cat([left neighbour's last halo frames, x])`` along the trailing
    axis; backward :func:`halo_adjoint`."""

    @staticmethod
    def forward(ctx, x, halo, comm):
        ctx.halo, ctx.comm = halo, comm
        return torch.cat([comm.shift_right(x[..., x.shape[-1] - halo:]), x],
                         dim=-1)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return _adjoint(g, ctx.halo, ctx.comm), None, None


class _HaloRecv(torch.autograd.Function):
    """The left neighbour's last ``halo`` frames of ``x`` (zeros on rank
    0); backward :func:`halo_adjoint_strip` with a zero ``gh``."""

    @staticmethod
    def forward(ctx, x, halo, comm):
        ctx.halo, ctx.comm, ctx.shape = halo, comm, x.shape
        return comm.shift_right(x[..., x.shape[-1] - halo:])

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return (_strip_adjoint(g.new_zeros(ctx.shape), g, ctx.halo, ctx.comm),
                None, None)


def left_halo(x, halo: int, mesh, axis_name: str):
    """Prepend the last ``halo`` frames of the left neighbour along
    ``axis_name`` to ``x``'s trailing axis (rank 0 receives zeros).
    Differentiable: the backward is :func:`halo_adjoint`."""
    if halo == 0:
        return x
    return _LeftHalo.apply(x, int(halo), comm_for(mesh, axis_name))


def halo_adjoint(g, halo: int, mesh, axis_name: str):
    """Adjoint of :func:`left_halo`: the cotangent's first ``halo`` frames
    belong to the left neighbour's trailing frames; they are sent there and
    added (the last rank receives zeros), and the rest is returned."""
    if halo == 0:
        return g
    return _adjoint(g, int(halo), comm_for(mesh, axis_name))


def halo_recv(x, halo: int, mesh, axis_name: str):
    """The frames :func:`left_halo` prepends, without the concatenation:
    the left neighbour's last ``halo`` frames along ``axis_name`` (zeros on
    rank 0), for the split conv form, which keeps ``x`` at its shard width.
    Differentiable: the backward sends the cotangent back as
    :func:`halo_adjoint_strip` does."""
    if halo == 0:
        return x[..., :0]
    return _HaloRecv.apply(x, int(halo), comm_for(mesh, axis_name))


def halo_adjoint_strip(gh, gr, halo: int, mesh, axis_name: str):
    """Adjoint of the split form's halo path: ``gh`` is the cotangent at the
    local activation's shard width, ``gr`` that of the received frames
    (:func:`halo_recv`), which belong to the left neighbour's last ``halo``
    frames: sent there and added (the last rank receives zeros).  Equal to
    :func:`halo_adjoint` of ``cat([gr, gh])``."""
    if halo == 0:
        return gh
    return _strip_adjoint(gh, gr, int(halo), comm_for(mesh, axis_name))


class _Layout:
    """The flat layouts of one rank's halo'd problem for B3/B4 (the JAX
    package's ``pallas_local_fit``/``pallas_nd_local_fit``).

    The halo'd activation ``hh (N, R, *lead_in, Xa)``, ``Xa = chunk + kx -
    1``, is VALID along the trailing axis: the reconstruction is ``(N, C,
    *lead_out, chunk)``, ``lead_out = lead_in + k - 1``.  Flattened
    row-major over ``(*act_lead, Xa)`` (the leading axes zero-padded to
    their output widths, the first left unpadded at ``N = 1``: offsets never
    involve the outermost extent, and reads past the end are zeros), full
    N-D convolution is 1-D convolution at the flat offsets of
    ``geom = nd_geom(kernel, lead_out + (Xa,))``; the trailing axis needs no
    padding (``x + kx - 1 - dx < Xa``).  The W side's activation carries
    ``lead_mid = T_flat - kx`` leading zero rows per segment (the lead of
    the leading axes), its cotangent ``kx - 1`` trailing zeros per row (to
    the stride ``Xa``) and ``lead_mid`` per segment; the H side's cotangent
    ``kx - 1`` leading zeros per row, whose reads past a row's end land in
    the next row's leading zeros.  Segments (``N > 1``) stack at one stride
    in both operands; every read outside a segment is a zero or lands in a
    cropped output row.  In 1-D the leading axes are empty: the segments
    are the halo'd chunks."""

    def __init__(self, N, R, lead_in, chunk, kernel):
        self.N, self.R, self.kernel = N, R, tuple(kernel)
        self.lead_in, self.chunk = tuple(lead_in), chunk
        kx = self.kx = kernel[-1]
        self.Xa = chunk + kx - 1
        self.lead_out = tuple(s + k - 1 for s, k in zip(lead_in, kernel[:-1]))
        if len(kernel) == 1:
            self.geom, self.T, self.act_lead = None, kx, ()
        else:
            self.geom = nd_geom(kernel, self.lead_out + (self.Xa,))
            self.T = _flat_T(self.geom)
            self.act_lead = (self.lead_out if N > 1 else
                             (self.lead_in[0],) + self.lead_out[1:])
        self.lead_mid = self.T - kx
        self.La = _prod(self.act_lead) * self.Xa

    def act_w(self, hh):
        """``hh`` → the W side's stacked activation ``(N·(lead_mid+La),
        R)``."""
        H2 = hh.movedim(1, -1)  # (N, *lead_in, Xa, R)
        pads = [0, 0, 0, 0]
        for s, a in zip(reversed(self.lead_in), reversed(self.act_lead)):
            pads += [0, a - s]
        flat = torch.nn.functional.pad(H2, pads).reshape(self.N, -1, self.R)
        flat = torch.nn.functional.pad(flat, (0, 0, self.lead_mid, 0))
        return flat.reshape(-1, self.R).contiguous()

    def _cot_rows(self, cot, lead: int):
        """``cot (N, prod(lead_out)·chunk, C)`` with ``kx - 1`` zero columns
        before (``lead``) or after each row of the trailing axis."""
        C = cot.shape[-1]
        c = cot.reshape((self.N,) + self.lead_out + (self.chunk, C))
        pad = (self.kx - 1, 0) if lead else (0, self.kx - 1)
        return torch.nn.functional.pad(c, (0, 0) + pad).reshape(self.N, -1, C)

    def cot_w(self, cot):
        """The W side's stacked cotangent ``(N·(rows+lead_mid), C)``."""
        c = self._cot_rows(cot, lead=False)
        c = torch.nn.functional.pad(c, (0, 0, 0, self.lead_mid))
        return c.reshape(-1, cot.shape[-1]).contiguous()

    def cot_h(self, cot):
        """The H side's stacked cotangent ``(N·prod(lead_out)·Xa, C)``."""
        return self._cot_rows(cot, lead=True).reshape(
            -1, cot.shape[-1]).contiguous()

    def wgrad(self, cots, hh):
        """B4: the raw W-side contractions of the cotangents ``cots`` (one
        or two), ``(K·R, C)`` each."""
        return fused_deconv.wgrad([self.cot_w(c) for c in cots],
                                  self.act_w(hh), self.R, self.T,
                                  lead_pad=False, geom=self.geom)

    def hgrad(self, cot, w2):
        """B3: the H-side contraction of ``cot`` with respect to the halo'd
        activation, ``(N, R, *lead_in, Xa)``."""
        out = fused_deconv.hgrad(self.cot_h(cot), w2, self.R,
                                 self.N * self.La, geom=self.geom)
        full = out.reshape((self.R, self.N) + self.act_lead + (self.Xa,))
        for d, s in enumerate(self.lead_in):
            full = full.narrow(2 + d, 0, s)
        return full.movedim(1, 0)

    def recon(self, w2, hh):
        """The VALID reconstruction ``(N, prod(lead_out)·chunk, C)``."""
        return _stream_recon(w2, hh, self.kernel, valid_last=True)


class _HaloDeconv(torch.autograd.Function):
    """The VALID reconstruction ``(N, C, *lead_out, chunk)`` of the halo'd
    ``hh`` by ``Wz (C, R, *k)``, whose backward runs B3 (``dhh``) and B4
    (``dWz``) in :class:`_Layout`, each only when its input needs it."""

    @staticmethod
    def forward(ctx, hh, Wz):
        kernel = tuple(int(k) for k in Wz.shape[2:])
        lay = _Layout(hh.shape[0], hh.shape[1], tuple(hh.shape[2:-1]),
                      hh.shape[-1] - kernel[-1] + 1, kernel)
        w2 = _w2(Wz)
        ctx.save_for_backward(hh, w2)
        ctx.lay = lay
        WH2 = lay.recon(w2, hh)
        return WH2.reshape((lay.N,) + lay.lead_out + (lay.chunk, -1)).movedim(
            -1, 1)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, ct):
        hh, w2 = ctx.saved_tensors
        lay = ctx.lay
        need_H, need_W = ctx.needs_input_grad
        cot = _v2_flat(ct)
        dH = lay.hgrad(cot, w2) if need_H else None
        dW = (_w_from_w2(lay.wgrad([cot], hh)[0], lay.kernel, lay.R)
              if need_W else None)
        return dH, dW


_CONV = (F.conv1d, F.conv2d, F.conv3d)


def _unfold_halo_nd(hh, W, spatial_ndim: int):
    """The VALID-trailing reconstruction ``(N, C, *lead_out, chunk)`` of
    the halo'd ``hh (N, R, *lead_in, chunk + T - 1)`` as one patch GEMM
    (full on the leading axes, VALID on the trailing one:
    :func:`~..ops.fast_nmfd._patch_chunk_fn`), differentiable."""
    kernel = tuple(int(k) for k in W.shape[2:])
    N, C = hh.shape[0], W.shape[0]
    S_out = tuple(s + k - 1 for s, k in zip(hh.shape[2:-1], kernel[:-1])) + (
        hh.shape[-1] - kernel[-1] + 1,)
    P = _patch_chunk_fn(hh, kernel, valid_last=True)(0, _prod(kernel))
    return (P @ _w2(W)).reshape((N,) + S_out + (C,)).movedim(-1, 1)


def _conv_halo_nd(hh, W, spatial_ndim: int):
    """The same reconstruction as a true convolution: ``F.convNd`` on the
    flipped kernel, padded ``k - 1`` on each leading axis and not at all on
    the trailing one."""
    nd = spatial_ndim
    pads = tuple(int(k) - 1 for k in W.shape[2:-1]) + (0,)
    return _CONV[nd - 1](hh, W.flip(tuple(range(2, 2 + nd))), padding=pads)


def _conv_halo_split_nd(hp, recv, W, spatial_ndim: int):
    """Split form of ``_conv_halo_nd(cat([recv, hp]), W)``: the main
    convolution runs on ``hp`` at its shard width, and the received frames
    ``recv (N, R, *lead_in, T - 1)`` add their share to the first ``T -
    1`` output frames through a strip patch GEMM (:func:`_unfold_halo_nd`
    of ``recv`` right-padded by ``T - 1``).  PyTorch's convolution pads
    symmetrically, so the trailing axis is padded ``T - 1`` on both sides
    and the first ``chunk`` outputs are kept (the right pad's ``T - 1``
    extra outputs are computed and dropped; the activation is not copied).
    Equal to the concat form within float32 summation order."""
    nd = spatial_ndim
    T = int(W.shape[-1])
    pads = tuple(int(k) - 1 for k in W.shape[2:])
    out = _CONV[nd - 1](hp, W.flip(tuple(range(2, 2 + nd))), padding=pads)
    out = out[..., :hp.shape[-1]]
    if T == 1:
        return out
    strip = _unfold_halo_nd(F.pad(recv, (0, T - 1)), W, nd)
    return torch.cat([out[..., :T - 1] + strip, out[..., T - 1:]], dim=-1)


def _halo_unfold_mode(n_batch, lead_shapes, chunk, kernel, R,
                      device=None) -> str:
    """The library per-shard mode by the memory heuristic (the JAX
    package's ``_halo_unfold_mode``): ``"conv"`` under
    ``PNT_HALO_UNFOLD=0`` or for a one-offset kernel; ``"unrolled"`` for
    ``K·R ≤ 4096`` whose patch matrix, counted twice (``8·N·Lp·K·R``
    bytes), fits the unfold budget (``PNT_NMFD_UNFOLD_MAX_BYTES``, else an
    eighth of a CUDA ``device``'s memory, else 2 GiB); ``"stream"`` above
    that when one τ-chunk does; ``"conv"`` otherwise."""
    if os.environ.get("PNT_HALO_UNFOLD", "") == "0":
        return "conv"
    K = _prod(kernel)
    if K < 2:
        return "conv"
    Lp = int(chunk)
    for s, k in zip(lead_shapes, kernel[:-1]):
        Lp *= int(s) + int(k) - 1
    max_bytes = budget_bytes("PNT_NMFD_UNFOLD_MAX_BYTES",
                             _DEFAULT_UNFOLD_MAX_BYTES, _UNFOLD_HBM_FRACTION,
                             device)
    if K * R <= _CHUNK_COLS:
        return "unrolled" if 8 * n_batch * Lp * K * R <= max_bytes else "conv"
    Tc = _chunk_tc(R, K)
    return "stream" if 8 * n_batch * Lp * Tc * R <= max_bytes else "conv"


class _NoComm:
    """A ``seq`` dimension of one rank with no process group: nothing is
    reduced and the halo is zeros.  One rank's work without collectives,
    which the mode tuner times."""

    size, rank = 1, 0

    def all_reduce(self, *tensors) -> None:
        pass

    def shift_right(self, x):
        return torch.zeros_like(x)

    shift_left = shift_right


class _MuShard:
    """One rank's MU iteration of a halo fit in the per-shard ``mode``
    (see the module docstring) over ``comm``: its target chunk ``Vl (N, C,
    *lead_out, chunk)``, the kernel extents and the rank ``R``.  The kernel
    is carried in the model layout ``(C, R, *k)`` by the autograd modes
    (``unrolled``, ``conv``) and as ``W2 (K·R, C)`` by the others."""

    def __init__(self, mode, Vl, kernel, R, beta, gamma, l1_reg, l2_reg,
                 comm):
        self.mode, self.comm = mode, comm
        self.kernel, self.R, self.nd = tuple(kernel), int(R), len(kernel)
        self.beta, self.gamma, self.l1, self.l2 = beta, gamma, l1_reg, l2_reg
        self.halo = self.kernel[-1] - 1
        self.K = _prod(self.kernel)
        self.Tc = _chunk_tc(self.R, self.K)
        self.autograd = mode in ("unrolled", "conv")
        self.split = mode == "conv" and self.halo > 0
        lead_in = tuple(s - k + 1 for s, k in zip(Vl.shape[2:-1],
                                                 self.kernel[:-1]))
        self.lay = _Layout(Vl.shape[0], self.R, lead_in, Vl.shape[-1],
                           self.kernel)
        self.Vl = Vl
        # the target in the reconstruction's layout
        self.target = Vl if self.autograd else _v2_flat(Vl)
        self.sum_axes = (0,) + tuple(range(2, 2 + self.nd))

    def start(self, W):
        return W if self.autograd else _w2(W)

    def finish(self, w):
        return w if self.autograd else _w_from_w2(w, self.kernel, self.R)

    def exchange(self, hp):
        """This iteration's halo: ``recv`` in the split form, else the
        halo'd activation."""
        if self.halo == 0:
            return hp
        cls = _HaloRecv if self.split else _LeftHalo
        return cls.apply(hp, self.halo, self.comm)

    def recon(self, w, hp, x):
        if self.split:
            return _conv_halo_split_nd(hp, x, w, self.nd)
        if self.mode == "conv":
            return _conv_halo_nd(x, w, self.nd)
        if self.mode == "unrolled":
            return _unfold_halo_nd(x, w, self.nd)
        return self.lay.recon(w, x)

    def loss_part(self, w, hp):
        """This rank's share of the divergence."""
        return beta_div(self.recon(w, hp, self.exchange(hp)), self.target,
                        self.beta)

    def step(self, w, hp, update_W=True, update_H=True):
        x = self.exchange(hp)  # one exchange, shared by both updates
        if update_W:
            w = self._upd_w(w, hp, x)
        if update_H:
            hp = self._upd_h(w, hp, x)
        return w, hp

    def _cots(self, WH):
        return [c for c in mu_cotangents(self.target, WH, self.beta)
                if c is not None]

    def _grads(self, f, xs):
        """``torch.autograd.grad`` of ``f(*xs)`` with respect to ``xs``, once
        per cotangent (neg, then pos at β ≠ 1), on fresh leaves: no graph
        outlives the call."""
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_(True) for x in xs]
            out = f(*leaves)
            cots = self._cots(out.detach())
            return [torch.autograd.grad(out, leaves, c,
                                        retain_graph=i + 1 < len(cots))
                    for i, c in enumerate(cots)]

    def _adjoint(self, g):
        return g if self.halo == 0 else _adjoint(g, self.halo, self.comm)

    def _upd_w(self, w, hp, x):
        beta = self.beta
        # β=1: the analytic denominator, H's per-rank sums over every rank
        kl = torch.sum(hp, dim=self.sum_axes) if beta == 1 else None
        if self.mode == "stream":
            # each τ-chunk's raw contractions all-reduced before its clamps
            self.comm.all_reduce(kl)
            return _unfold_upd_w(self.Vl, w, x, self.kernel, self.Tc, beta,
                                 self.gamma, self.l1, self.l2,
                                 valid_last=True,
                                 reduce=self.comm.all_reduce, kl_sums=kl)
        if self.autograd:
            outs = [g[0] for g in self._grads(
                lambda ww: self.recon(ww, hp, x), [w])]
        else:  # B4, the neg/pos pair in one call
            outs = self.lay.wgrad(self._cots(self.lay.recon(w, x)), x)
        neg, pos = outs[0], (kl if beta == 1 else outs[1])
        self.comm.all_reduce(neg, pos)  # the raw sums, before the clamps
        if beta != 1:
            pos = torch.relu(pos) + eps
        elif self.autograd:
            pos = pos.reshape((1, -1) + (1,) * self.nd)
        else:
            pos = pos.repeat(self.K)[:, None]
        return _mu_step(w, neg, pos, self.gamma, self.l1, self.l2)

    def _upd_h(self, w, hp, x):
        if self.split:
            grads = [_strip_adjoint(gh, gr, self.halo, self.comm)
                     for gh, gr in self._grads(
                         lambda h, r: self.recon(w, h, r), [hp, x])]
        elif self.autograd:
            grads = [self._adjoint(g[0]) for g in self._grads(
                lambda hh: self.recon(w, None, hh), [x])]
        else:
            cots = self._cots(self.lay.recon(w, x))
            if self.mode == "fused":
                raw = [self.lay.hgrad(c, w) for c in cots]
            else:  # the τ-chunked fold onto the halo'd width
                raw = _unfold_h_contract(w, cots, x, self.kernel, self.Tc,
                                         valid_last=True)
            grads = [self._adjoint(g) for g in raw]
        if self.beta == 1:
            s = (torch.sum(w, dim=self.sum_axes) if self.autograd
                 else _kl_pos_h_ranks(w, self.R))
            pos = s.reshape((1, self.R) + (1,) * self.nd)
        else:
            pos = torch.relu(grads[1]) + eps
        return _mu_step(hp, grads[0], pos, self.gamma, self.l1, self.l2)


def _local_run(mode, Vl, W, hp, beta: float):
    """``run(n)``: ``n`` iterations of one rank's MU step in ``mode`` on its
    local problem, without collectives (:class:`_NoComm`): what the mode
    tuner times."""
    shard = _MuShard(mode, Vl, tuple(int(k) for k in W.shape[2:]),
                     W.shape[1], float(beta), gamma_from_beta(beta), 0.0, 0.0,
                     _NoComm())
    w0 = shard.start(W)

    @torch.no_grad()
    def run(n):
        w, h = w0, hp
        for _ in range(n):
            w, h = shard.step(w, h)
        return h

    return run


def _resolve_halo_mode(mode, em, N, C, lead_in, chunk, kernel, R, beta,
                       comm, device):
    """The per-shard mode of a halo fit: ``mode`` when it is given (one of
    :data:`MU_MODES`, or :data:`EM_MODES` for the EM fits, ``em``), else
    rank 0's resolution (:func:`~..ops.autotune.autotune_halo_mode` on the
    heuristic :func:`_halo_unfold_mode`), broadcast over ``comm``.  The EM
    has no streamed form: as in the JAX package, every resolved mode but
    ``"fused"`` and ``"unrolled"`` runs as ``"conv"`` there."""
    modes = EM_MODES if em else MU_MODES
    if mode is not None:
        if mode not in modes:
            raise ValueError(f"per-shard mode {mode!r}: one of {modes}")
        return mode
    heuristic = _halo_unfold_mode(N, lead_in, chunk, kernel, R, device)
    mode = autotune.autotune_halo_mode(
        N, C, lead_in, chunk, kernel, R, beta, heuristic, not em,
        device=device, comm=comm)
    return mode if not em or mode in EM_MODES else "conv"


def _halo_split(V, W, H, mesh, spatial_ndim, seq_axis):
    """Checks the shapes, pads and splits the trailing axis: ``(comm, dev,
    Vl, W, Hl, chunk, L_in, pad_v)`` with this rank's chunks of the padded
    ``V`` and ``H`` (and ``W``) on the mesh's device."""
    V = _full(V)
    W = _full(W)
    H = _full(H)
    T = W.shape[-1]
    L_out, L_in = V.shape[-1], H.shape[-1]
    if V.ndim != spatial_ndim + 2 or H.ndim != V.ndim or W.ndim != V.ndim:
        raise ValueError(f"a {spatial_ndim}-D fit takes V (N, C, *S_out), W "
                         "(C, R, *k) and H (N, R, *S_in)")
    if L_in != L_out - T + 1:
        raise ValueError("H trailing length must be L_out - T + 1")
    for d in range(2, 1 + spatial_ndim):
        if H.shape[d] != V.shape[d] - W.shape[d] + 1:
            raise ValueError(
                f"H spatial dim {d} must be V - kernel + 1: got {H.shape[d]} "
                f"vs {V.shape[d]} - {W.shape[d]} + 1")
    comm = comm_for(mesh, seq_axis)
    n, r = comm.size, comm.rank
    chunk = max(-(-L_out // n), T - 1)
    dev = mesh_device(mesh)

    def piece(x, L, dtype=torch.float32):
        x = x[..., min(r * chunk, L):min((r + 1) * chunk, L)]
        x = torch.nn.functional.pad(x, (0, chunk - x.shape[-1]))
        return x.to(device=dev, dtype=dtype).contiguous()

    # a bfloat16 V stays bfloat16 on its rank (models._common.target_dtype)
    return (comm, dev, piece(V, L_out, target_dtype(V.dtype, torch.float32)),
            W.to(device=dev, dtype=torch.float32), piece(H, L_in), chunk,
            L_in, chunk * n - L_out)


def _full(x):
    return host_tensor(x).detach()


def _h_out(hp, comm, mesh, seq_axis, L_in, shape):
    """The fitted ``H`` as a DTensor sharded over ``seq_axis`` the way
    DTensor splits the unpadded ``L_in`` frames (one gather of the chunks,
    which the padding laid out differently)."""
    full = torch.cat(comm.all_gather(hp), dim=-1)[..., :L_in]
    pls = placements(mesh, {hp.ndim - 1: seq_axis})
    c = -(-L_in // comm.size)
    start = min(comm.rank * c, L_in)
    local = full[..., start:min(start + c, L_in)].contiguous()
    return as_dtensor(local, mesh, pls, shape)


def _sharded_deconv_fit(V, W, H, mesh, spatial_ndim, beta=1, tol=1e-4,
                        max_iter=200, l1_reg=0.0, l2_reg=0.0, seq_axis="seq",
                        update_W=True, update_H=True, verbose=False,
                        mode=None):
    """The MU halo fits; ``mode`` forces a per-shard mode (:data:`MU_MODES`),
    ``None`` resolves it (:func:`_resolve_halo_mode`)."""
    beta, tol, max_iter = float(beta), float(tol), int(max_iter)
    l1_reg, l2_reg = float(l1_reg), float(l2_reg)
    gamma = gamma_from_beta(beta)
    h_shape = tuple(H.shape)
    comm, dev, Vl, W, hp, chunk, L_in, pad_v = _halo_split(
        V, W, H, mesh, spatial_ndim, seq_axis)
    kernel = tuple(int(k) for k in W.shape[2:])
    N, R = Vl.shape[0], W.shape[1]
    # the padded cells' constant divergence (zero for β ∈ {1, 2}), taken
    # off the cadence loss so it is the unpadded problem's
    loss_offset = 0.0
    if pad_v:
        per_cell = float(beta_div(torch.zeros(()), torch.zeros(()), beta))
        loss_offset = per_cell * pad_v * int(np.prod(V.shape[:-1]))
        if not np.isfinite(loss_offset):
            loss_offset = 0.0
    mode = _resolve_halo_mode(mode, False, N, Vl.shape[1],
                              tuple(hp.shape[2:-1]), chunk, kernel, R, beta,
                              comm, dev)
    shard = _MuShard(mode, Vl, kernel, R, beta, gamma, l1_reg, l2_reg, comm)

    def loss_of(state):
        part = shard.loss_part(*state).reshape(1)
        comm.all_reduce(part)
        return torch.sqrt(2.0 * torch.clamp(part[0] - loss_offset, min=0.0))

    def one_iter(state):
        return shard.step(*state, update_W, update_H)

    with torch.no_grad(), _reporter(mesh, verbose, max_iter) as report:
        (w, hp), k, conv = _converging_loop(one_iter, loss_of,
                                            (shard.start(W), hp), tol,
                                            max_iter, report)
        W_out = shard.finish(w)
        H_out = _h_out(hp, comm, mesh, seq_axis, L_in, h_shape)
    return (as_dtensor(W_out, mesh, placements(mesh, {}), tuple(W_out.shape)),
            H_out, k * 10 if conv else max_iter)


def sharded_nmfd_fit(V, W, H, mesh, beta: float = 1, tol: float = 1e-4,
                     max_iter: int = 200, l1_reg: float = 0.0,
                     l2_reg: float = 0.0, seq_axis: str = "seq",
                     update_W: bool = True, update_H: bool = True,
                     verbose: bool = False):
    """Fit NMFD with the time axis sharded over ``mesh``'s ``seq_axis``.

    ``V (N, C, L_out)``, ``W (C, R, T)``, ``H (N, R, L_in)`` with ``L_in =
    L_out - T + 1``: full arrays, the same on every rank.  The trailing
    axis is zero-padded so it divides evenly with chunks of at least ``T -
    1`` frames (exact; the loss offset of the padded cells is corrected).
    Returns ``(W, H, n_iter)``: ``W`` a replicated DTensor, ``H`` a DTensor
    sharded along its trailing axis, ``n_iter`` an int, matching the
    single-card trajectory.  ``verbose`` reports the cadence loss from
    rank 0."""
    return _sharded_deconv_fit(V, W, H, mesh, 1, beta, tol, max_iter, l1_reg,
                               l2_reg, seq_axis, update_W, update_H, verbose)


def sharded_nmf2d_fit(V, W, H, mesh, beta: float = 1, tol: float = 1e-4,
                      max_iter: int = 200, l1_reg: float = 0.0,
                      l2_reg: float = 0.0, seq_axis: str = "seq",
                      update_W: bool = True, update_H: bool = True,
                      verbose: bool = False):
    """Fit NMF2D with the trailing spatial axis sharded (the leading one
    stays local); the rules of :func:`sharded_nmfd_fit`."""
    return _sharded_deconv_fit(V, W, H, mesh, 2, beta, tol, max_iter, l1_reg,
                               l2_reg, seq_axis, update_W, update_H, verbose)


def sharded_nmf3d_fit(V, W, H, mesh, beta: float = 1, tol: float = 1e-4,
                      max_iter: int = 200, l1_reg: float = 0.0,
                      l2_reg: float = 0.0, seq_axis: str = "seq",
                      update_W: bool = True, update_H: bool = True,
                      verbose: bool = False):
    """Fit NMF3D with the trailing spatial axis sharded; the rules of
    :func:`sharded_nmfd_fit`."""
    return _sharded_deconv_fit(V, W, H, mesh, 3, beta, tol, max_iter, l1_reg,
                               l2_reg, seq_axis, update_W, update_H, verbose)


def _sharded_siplca_fit(V, W, H, Z, mesh, spatial_ndim, tol=1e-4,
                        max_iter=200, W_alpha=1.0, H_alpha=1.0, Z_alpha=1.0,
                        update_W=True, update_H=True, update_Z=True,
                        seq_axis="seq", verbose=False, mode=None):
    """The EM halo fits; ``mode`` forces a per-shard mode (:data:`EM_MODES`),
    ``None`` resolves it (:func:`_resolve_halo_mode`)."""
    tol, max_iter = float(tol), int(max_iter)
    Wa, Ha, Za = (alpha_is_active(a) for a in (W_alpha, H_alpha, Z_alpha))
    h_shape = tuple(H.shape)
    comm, dev, Vl, W, hp, chunk, L_in, _ = _halo_split(
        V, W, H, mesh, spatial_ndim, seq_axis)
    Z = _full(Z).to(device=dev, dtype=torch.float32)
    W_alpha, H_alpha, Z_alpha = (_alpha(a, dev)
                                 for a in (W_alpha, H_alpha, Z_alpha))
    nd = spatial_ndim
    kernel = tuple(int(k) for k in W.shape[2:])
    halo = kernel[-1] - 1
    n_pad_h = chunk * comm.size - L_in
    # the EM E-step's cotangents are KL-shaped: the modes are timed at β=1
    mode = _resolve_halo_mode(mode, True, Vl.shape[0], Vl.shape[1],
                              tuple(hp.shape[2:-1]), chunk, kernel,
                              W.shape[1], 1.0, comm, dev)
    recon_hh = {"fused": _HaloDeconv.apply,
                "unrolled": lambda hh, Wz: _unfold_halo_nd(hh, Wz, nd),
                "conv": lambda hh, Wz: _conv_halo_nd(hh, Wz, nd)}[mode]
    # the padded H positions must stay exactly zero through the prior's
    # h + (alpha - 1)
    h_mask = None
    if n_pad_h and Ha:
        gpos = comm.rank * chunk + torch.arange(chunk, device=dev)
        h_mask = (gpos < chunk * comm.size - n_pad_h).to(hp.dtype).reshape(
            (1, 1) + (1,) * (nd - 1) + (chunk,))

    def summed(x):
        x = x.reshape(1).clone() if x.ndim == 0 else x.clone()
        comm.all_reduce(x)
        return x

    def recon3(hp, w, z):
        return recon_hh(left_halo(hp, halo, mesh, seq_axis),
                        scaled_kernel(w, z, nd))

    def h_marginal(h):
        return summed(_plca_marginal_sum(h))

    with torch.no_grad():
        # the sum in float32 over the ranks, then in V's dtype (as
        # sharded.sharded_plca_fit)
        norm = summed(Vl.sum(dtype=torch.float32))[0].to(Vl.dtype)
        Vn = Vl / norm

        def loss_of(state):
            w, hp, z = state
            part = kl_div(recon3(hp, w, z) * norm, Vn * norm)
            return torch.sqrt(2.0 * summed(part)[0])

        def log_probability(state):
            # the padded H entries (exact zeros) would each add
            # log(eps)·(Hα-1) against the unpadded problem: taken off
            w, hp, z = state
            WZH = recon3(hp, w, z)
            lp = summed(matmul(Vn.reshape(-1),
                               torch.log(WZH + eps).reshape(-1)))[0]
            lp = lp + torch.sum(torch.log(w + eps) * (W_alpha - 1.0))
            lp = lp + summed(torch.sum(torch.log(hp + eps)
                                       * (H_alpha - 1.0)))[0]
            if n_pad_h:
                rows = hp.numel() // hp.shape[-1]
                lp = lp - rows * n_pad_h * np.log(np.float32(eps)) * (
                    H_alpha - 1.0)
            return lp + torch.sum(torch.log(z + eps) * (Z_alpha - 1.0))

        def one_iter(state):
            w, hp, z = state
            # the halo cotangent goes back through left_halo's backward,
            # the W and Z gradients are partial sums
            gH, gW, gZ = _plca_e_step(recon3, Vn, w, hp, z)
            comm.all_reduce(gW if update_W else None,
                            gZ if update_Z else None)
            return _plca_m_step(update_W, update_H, update_Z, Wa, Ha, Za, w,
                                hp, z, gH, gW, gZ, W_alpha, H_alpha, Z_alpha,
                                h_marginal=h_marginal, h_mask=h_mask)

        with _reporter(mesh, verbose, max_iter) as report:
            (W, hp, Z), k, conv = _converging_loop(
                one_iter, loss_of, (W, hp, Z), tol, max_iter, report,
                extra_of=log_probability)
        H_out = _h_out(hp, comm, mesh, seq_axis, L_in, h_shape)
    rep = placements(mesh, {})
    return (as_dtensor(W, mesh, rep, tuple(W.shape)), H_out,
            as_dtensor(Z, mesh, rep, tuple(Z.shape)),
            k * 10 - 1 if conv else max_iter - 1, float(norm))


def sharded_siplca_fit(V, W, H, Z, mesh, tol: float = 1e-4,
                       max_iter: int = 200, W_alpha=1.0, H_alpha=1.0,
                       Z_alpha=1.0, update_W: bool = True,
                       update_H: bool = True, update_Z: bool = True,
                       seq_axis: str = "seq", verbose: bool = False):
    """EM-fit SIPLCA with the time axis sharded over ``mesh``'s
    ``seq_axis``.  ``V (N, C, L_out)``, ``W (C, R, T)``, ``H (N, R, L_out -
    T + 1)``, ``Z (R,)``: full arrays, probability-normalized (as the
    :class:`~..plca.SIPLCA` constructor leaves them).  Per iteration one
    exchange each way and one all-reduce of the W and Z gradients; the
    padding rules of :func:`sharded_nmfd_fit` (the all-zero cells' KL
    divergence is exactly 0: no loss offset).  Returns ``(W, H, Z, n_iter,
    norm)``: DTensors (``H`` sharded on its trailing axis), the reference's
    raw loop index and a float."""
    return _sharded_siplca_fit(V, W, H, Z, mesh, 1, tol, max_iter, W_alpha,
                               H_alpha, Z_alpha, update_W, update_H, update_Z,
                               seq_axis, verbose)


def sharded_siplca2_fit(V, W, H, Z, mesh, tol: float = 1e-4,
                        max_iter: int = 200, W_alpha=1.0, H_alpha=1.0,
                        Z_alpha=1.0, update_W: bool = True,
                        update_H: bool = True, update_Z: bool = True,
                        seq_axis: str = "seq", verbose: bool = False):
    """EM-fit SIPLCA2 with the trailing spatial axis sharded."""
    return _sharded_siplca_fit(V, W, H, Z, mesh, 2, tol, max_iter, W_alpha,
                               H_alpha, Z_alpha, update_W, update_H, update_Z,
                               seq_axis, verbose)


def sharded_siplca3_fit(V, W, H, Z, mesh, tol: float = 1e-4,
                        max_iter: int = 200, W_alpha=1.0, H_alpha=1.0,
                        Z_alpha=1.0, update_W: bool = True,
                        update_H: bool = True, update_Z: bool = True,
                        seq_axis: str = "seq", verbose: bool = False):
    """EM-fit SIPLCA3 with the trailing spatial axis sharded."""
    return _sharded_siplca_fit(V, W, H, Z, mesh, 3, tol, max_iter, W_alpha,
                               H_alpha, Z_alpha, update_W, update_H, update_Z,
                               seq_axis, verbose)

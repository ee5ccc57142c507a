r"""Sequence-parallel deconvolutional NMF and SIPLCA by halo exchange
(counterpart of :mod:`pytorch_nmf_tpu.parallel.halo`, its fused per-shard
mode, the JAX package's ``"pallas"``).

The trailing spatial axis (time, for NMFD) is sharded over a ``seq`` mesh
dimension.  ``H`` is zero-padded from ``L_in`` to ``L_pad = n · chunk``
and ``V`` from ``L_out`` to ``L_pad``, with ``chunk = max(ceil(L_out /
n), T - 1)``, so every rank holds one chunk of both and its left
neighbour's last ``T - 1`` frames suffice (padded H entries are MU and EM
fixed points; at fractional β the padded cells' constant loss is
subtracted from the cadence loss).

Per rank and iteration: :func:`left_halo` prepends the left neighbour's
last ``T - 1`` activation frames (one exchange to the right); the
reconstruction is VALID along the halo'd axis (full along the leading
spatial axes, which stay local); the two contractions are the kernels:

* the W side is B4 (``wgrad``) with ``lead_pad=False`` on the halo'd
  activation, its raw sums all-reduced before the clamps (so no β=1
  epilogue here: it would clamp a partial sum), the neg/pos pair in one
  call at β ≠ 1;
* the H side is B3 (``hgrad``) on the cotangent, whose first ``T - 1``
  frames belong to the left neighbour: :func:`halo_adjoint` sends them
  back (one exchange to the left per contraction).

2-D/3-D run both kernels in their flat-offset mode (:class:`_Layout`).
``N > 1`` stacks the batches along the flat axis.  On CPU tensors the
kernels' plain versions run instead.

The SIPLCA family differentiates the same reconstruction: a
``torch.autograd.Function`` whose backward is B3 and B4 in this layout,
behind :func:`left_halo`, whose backward is :func:`halo_adjoint`.  The W
and Z gradients are partial sums, all-reduced after ``autograd.grad``.
"""

import numpy as np
import torch

from ..constants import eps
from ..metrics import beta_div, kl_div
from ..ops import fused_deconv
from ..ops.fast_nmfd import (_kl_pos_h_ranks, _prod, _stream_recon, _v2_flat,
                             _w2, _w_from_w2)
from ..ops.fused_deconv import _flat_T, nd_geom
from ..ops.mu import gamma_from_beta, mu_cotangents
from ..ops.recon import scaled_kernel
from ..ops.solver import (_converging_loop, _plca_e_step, _plca_m_step,
                          _plca_marginal_sum, alpha_is_active)
from .comm import comm_for
from .sharded import (_alpha, _mu_step, _reporter, as_dtensor, mesh_device,
                      placements)

__all__ = [
    "left_halo",
    "halo_adjoint",
    "sharded_nmfd_fit",
    "sharded_nmf2d_fit",
    "sharded_nmf3d_fit",
    "sharded_siplca_fit",
    "sharded_siplca2_fit",
    "sharded_siplca3_fit",
]


def _adjoint(g, halo: int, comm):
    gx = g[..., halo:].clone()
    L = gx.shape[-1]
    gx[..., L - halo:] += comm.shift_left(g[..., :halo])
    return gx


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

    def piece(x, L):
        x = x[..., min(r * chunk, L):min((r + 1) * chunk, L)]
        x = torch.nn.functional.pad(x, (0, chunk - x.shape[-1]))
        return x.to(device=dev, dtype=torch.float32).contiguous()

    return (comm, dev, piece(V, L_out), W.to(device=dev, dtype=torch.float32),
            piece(H, L_in), chunk, L_in, chunk * n - L_out)


def _full(x):
    if isinstance(x, torch.Tensor):
        return x.detach()
    return torch.from_numpy(np.ascontiguousarray(x))


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


def _sharded_deconv_fit(V, W, H, mesh, spatial_ndim, beta, tol, max_iter,
                        l1_reg, l2_reg, seq_axis, update_W=True, update_H=True,
                        verbose=False):
    beta, tol, max_iter = float(beta), float(tol), int(max_iter)
    l1_reg, l2_reg = float(l1_reg), float(l2_reg)
    gamma = gamma_from_beta(beta)
    h_shape = tuple(H.shape)
    comm, _, Vl, W, hp, chunk, L_in, pad_v = _halo_split(
        V, W, H, mesh, spatial_ndim, seq_axis)
    kernel = tuple(int(k) for k in W.shape[2:])
    N, R = Vl.shape[0], W.shape[1]
    halo = kernel[-1] - 1
    # the padded cells' constant divergence (zero for β ∈ {1, 2}), taken
    # off the cadence loss so it is the unpadded problem's
    loss_offset = 0.0
    if pad_v:
        per_cell = float(beta_div(torch.zeros(()), torch.zeros(()), beta))
        loss_offset = per_cell * pad_v * int(np.prod(V.shape[:-1]))
        if not np.isfinite(loss_offset):
            loss_offset = 0.0
    lay = _Layout(N, R, tuple(hp.shape[2:-1]), chunk, kernel)
    V2 = _v2_flat(Vl)
    K = _prod(kernel)
    sum_axes = tuple(d for d in range(hp.ndim) if d != 1)

    def hh_of(hp):
        return left_halo(hp, halo, mesh, seq_axis)

    def loss_of(state):
        w2, hp = state
        part = beta_div(lay.recon(w2, hh_of(hp)), V2, beta).reshape(1)
        comm.all_reduce(part)
        return torch.sqrt(2.0 * torch.clamp(part[0] - loss_offset, min=0.0))

    def one_iter(state):
        w2, hp = state
        hh = hh_of(hp)  # one exchange, shared by both updates
        if update_W:
            neg_cot, pos_cot = mu_cotangents(V2, lay.recon(w2, hh), beta)
            if beta == 1:
                neg = lay.wgrad([neg_cot], hh)[0]
                pos = torch.sum(hp, dim=sum_axes)
            else:
                neg, pos = lay.wgrad([neg_cot, pos_cot], hh)
            comm.all_reduce(neg, pos)  # the raw sums, before the clamps
            pos = (pos.repeat(K)[:, None] if beta == 1
                   else torch.relu(pos) + eps)
            w2 = _mu_step(w2, neg, pos, gamma, l1_reg, l2_reg)
        if update_H:
            neg_cot, pos_cot = mu_cotangents(V2, lay.recon(w2, hh), beta)
            neg = halo_adjoint(lay.hgrad(neg_cot, w2), halo, mesh, seq_axis)
            if beta == 1:
                pos = _kl_pos_h_ranks(w2, R).reshape((1, R) + (1,) * len(kernel))
            else:
                pos = torch.relu(halo_adjoint(lay.hgrad(pos_cot, w2), halo,
                                              mesh, seq_axis)) + eps
            hp = _mu_step(hp, neg, pos, gamma, l1_reg, l2_reg)
        return w2, hp

    with torch.no_grad(), _reporter(mesh, verbose, max_iter) as report:
        (w2, hp), k, conv = _converging_loop(one_iter, loss_of, (_w2(W), hp),
                                             tol, max_iter, report)
        W_out = _w_from_w2(w2, kernel, R)
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


def _sharded_siplca_fit(V, W, H, Z, mesh, spatial_ndim, tol, max_iter,
                        W_alpha, H_alpha, Z_alpha, update_W, update_H,
                        update_Z, seq_axis, verbose=False):
    tol, max_iter = float(tol), int(max_iter)
    Wa, Ha, Za = (alpha_is_active(a) for a in (W_alpha, H_alpha, Z_alpha))
    h_shape = tuple(H.shape)
    comm, dev, Vl, W, hp, chunk, L_in, _ = _halo_split(
        V, W, H, mesh, spatial_ndim, seq_axis)
    Z = _full(Z).to(device=dev, dtype=torch.float32)
    W_alpha, H_alpha, Z_alpha = (_alpha(a, dev)
                                 for a in (W_alpha, H_alpha, Z_alpha))
    nd = spatial_ndim
    halo = W.shape[-1] - 1
    n_pad_h = chunk * comm.size - L_in
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
        return _HaloDeconv.apply(left_halo(hp, halo, mesh, seq_axis),
                                 scaled_kernel(w, z, nd))

    def h_marginal(h):
        return summed(_plca_marginal_sum(h))

    with torch.no_grad():
        norm = summed(Vl.sum())[0]
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
            lp = summed(Vn.reshape(-1) @ torch.log(WZH + eps).reshape(-1))[0]
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
            # B3/B4 behind autograd; the halo cotangent goes back through
            # left_halo's backward, the W and Z gradients are partial sums
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

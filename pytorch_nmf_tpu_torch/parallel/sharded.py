r"""Sharded NMF and PLCA fits on ``torch.distributed`` (counterpart of
:mod:`pytorch_nmf_tpu.parallel.sharded`'s explicit ``shard_map`` solvers).

One process per rank; each runs the whole loop on its own block.  For
``V ≈ H Wᵀ`` with the rows (samples) sharded over a ``data`` mesh
dimension and, optionally, the feature columns over a ``model`` one, the
MU numerators and denominators are partial sums over the local blocks:

* the W update contracts the rows, so its raw numerator (and denominator)
  is all-reduced over ``data`` before the ``relu``/``eps`` clamps;
* the H update contracts the columns: all-reduced over ``model`` when
  there is one, local otherwise;
* the cadence loss is the all-reduced sum of the local divergences.

At β ≠ 2 each local contraction is B1 (:mod:`..ops.fused_mu`: the CUDA
kernel on a card tensor, its plain version on a CPU one) and the cadence
loss at β ∉ {1, 2} is B2.  B1's β=1 epilogue, which clamps and multiplies
inside the kernel, runs only on a side that is not all-reduced (the H side
without a ``model`` dimension): on a partial sum it would clamp before the
reduction.  β=2 keeps the Gram GEMMs.

Every rank takes the same decisions: the stop test reads the all-reduced
loss, so all leave the loop at the same chunk.  The factors come in as
full arrays (the same on every rank, e.g. made from one seed) or as
:class:`~torch.distributed.tensor.DTensor`\ s, and go out as ``DTensor``\ s
(:func:`shard_target`); inside the loop they are plain local tensors and
the collectives explicit (:mod:`.comm`).
"""

import contextlib
from typing import Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..constants import eps
from ..metrics import kl_div
from ..models._common import host_tensor, target_dtype
from ..ops import fused_mu
from ..ops.fast_nmf import _blocked_loss
from ..ops.mu import gamma_from_beta, mu_multiplier
from ..ops.recon import matmul, target_mm, target_tmm
from ..ops.solver import (_converging_loop, _plca_e_step, _plca_m_step,
                          _plca_marginal_sum, _progress, alpha_is_active)
from .comm import comm_for

__all__ = ["shard_target", "sharded_nmf_fit", "sharded_plca_fit"]


def mesh_device(mesh) -> torch.device:
    """The device of this rank's blocks: its current card on a ``"cuda"``
    mesh, the CPU on a ``"cpu"`` one."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def placements(mesh, dims) -> list:
    """DTensor placements of a tensor whose dimension ``d`` is sharded over
    the mesh dimension named ``dims[d]`` (``None``: not sharded)."""
    out = [Replicate()] * mesh.ndim
    for d, axis in dims.items():
        if axis is not None:
            out[mesh.mesh_dim_names.index(axis)] = Shard(d)
    return out


def _block(x, mesh, pls):
    """This rank's block of the full ``x`` under ``pls`` (DTensor's uneven
    split: ``ceil(n / size)`` per rank, the last ones shorter or empty)."""
    coord = mesh.get_coordinate()
    for i, p in enumerate(pls):
        if isinstance(p, Shard):
            n, size = x.shape[p.dim], mesh.size(i)
            c = -(-n // size)
            start = min(coord[i] * c, n)
            x = x.narrow(p.dim, start, min(c, n - start))
    return x


def local_block(x, mesh, pls, device=None, target=False):
    """This rank's block of ``x`` on ``device`` (the mesh's by default), in
    float32 or, for a ``target``, in the dtype a fit holds it in (a
    bfloat16 target stays bfloat16; ``models._common.target_dtype``): ``x``
    is a full array (numpy or tensor, the same on every rank), or a
    ``DTensor`` with placements ``pls``, whose local tensor is taken.  A
    2-D target block copied to the card gets 16-byte aligned rows
    (``fused_mu.aligned_copy``), as B1/B2 read them."""
    device = mesh_device(mesh) if device is None else device
    if isinstance(x, DTensor):
        if x.device_mesh != mesh or list(x.placements) != list(pls):
            raise ValueError(f"DTensor placed {x.placements} on "
                             f"{x.device_mesh}; the fit takes {pls} on {mesh}")
        x = x.to_local()
    else:
        x = host_tensor(x).detach()
    x = _block(x, mesh, pls)
    dtype = target_dtype(x.dtype, torch.float32) if target else torch.float32
    if target and x.ndim == 2 and torch.device(device).type == "cuda" and \
            x.device != torch.device(device):
        return fused_mu.aligned_copy(x, device, dtype)
    return x.to(device=device, dtype=dtype).contiguous()


def as_dtensor(local, mesh, pls, shape) -> DTensor:
    """The DTensor of the local blocks ``local`` of a global ``shape``."""
    shape = torch.Size(shape)
    stride = tuple(int(s) for s in torch.empty(shape, device="meta").stride())
    return DTensor.from_local(local, mesh, pls, run_check=False, shape=shape,
                              stride=stride)


def shard_target(x, mesh, pls) -> DTensor:
    """Place the full ``x`` (the same on every rank) on ``mesh`` under the
    DTensor placements ``pls`` (one per mesh dimension): each rank keeps its
    own block, no communication; a bfloat16 ``x`` stays bfloat16."""
    shape = x.shape
    return as_dtensor(local_block(x, mesh, pls, target=True), mesh, pls,
                      shape)


def _reporter(mesh, verbose: bool, max_iter: int):
    """A context yielding the loop's ``report`` on every rank when
    ``verbose``: each rank computes the reported values (their collectives
    need all ranks), rank 0 alone shows them and feeds the progress
    handlers."""
    @contextlib.contextmanager
    def ctx():
        if not verbose:
            yield None
            return
        first = all(c == 0 for c in mesh.get_coordinate())
        with _progress(first, max_iter) as report:
            def each(k, loss, extra=None):
                if report is not None:
                    report(k, loss, extra)

            yield each

    return ctx()


def _mu_step(p, neg_raw, pos, gamma, l1_reg, l2_reg):
    """``p · ((relu(neg_raw) + eps) / pos) ** γ`` with the regularizers
    (the clamps on the already reduced numerator)."""
    return p * mu_multiplier(torch.relu(neg_raw) + eps, pos, p, gamma,
                             l1_reg, l2_reg)


def sharded_nmf_fit(V, W, H, mesh, beta: float = 1, tol: float = 1e-4,
                    max_iter: int = 200, l1_reg: float = 0.0,
                    l2_reg: float = 0.0, data_axis: str = "data",
                    model_axis: Optional[str] = None, use_pallas=None):
    """Fit ``V ≈ H Wᵀ`` on ``mesh`` with explicit collectives.

    ``V (M, K)`` is sharded over ``data_axis`` (rows) and ``model_axis``
    (columns, when given), ``H (M, R)`` over ``data_axis``, ``W (K, R)``
    over ``model_axis`` (replicated without one).  Every rank calls it with
    the full arrays or with DTensors so placed.  Returns ``(W, H,
    n_iter)``: ``W`` and ``H`` DTensors with those placements, ``n_iter``
    an int (``10·k`` when chunk ``k`` converged, else ``max_iter``), the
    same on every rank.

    ``use_pallas`` is the JAX package's switch, kept for its signature:
    the wrappers of B1/B2 choose by device (the kernels on a card tensor,
    their plain versions on a CPU one), so ``False`` changes nothing on a
    ``"cpu"`` mesh and is refused on a ``"cuda"`` one."""
    if use_pallas is not None and not use_pallas and mesh.device_type == "cuda":
        raise ValueError("use_pallas=False: the port has no unfused card "
                         "path (B1/B2 run on card tensors)")
    beta, tol, max_iter = float(beta), float(tol), int(max_iter)
    l1_reg, l2_reg = float(l1_reg), float(l2_reg)
    gamma = gamma_from_beta(beta)
    need_pos = beta not in (1, 2)
    v_pl = placements(mesh, {0: data_axis, 1: model_axis})
    w_pl = placements(mesh, {0: model_axis})
    h_pl = placements(mesh, {0: data_axis})
    shapes = {"W": tuple(W.shape), "H": tuple(H.shape)}
    Vl = local_block(V, mesh, v_pl, target=True)
    Wl = local_block(W, mesh, w_pl)
    Hl = local_block(H, mesh, h_pl)
    if Vl.shape != (Hl.shape[0], Wl.shape[0]):
        raise ValueError(f"local blocks V {tuple(Vl.shape)}, W "
                         f"{tuple(Wl.shape)}, H {tuple(Hl.shape)} do not form "
                         "V ~ H Wᵀ: the sharded axes must divide evenly")
    data = comm_for(mesh, data_axis)
    model = comm_for(mesh, model_axis) if model_axis else None
    if beta != 2:
        Vl = fused_mu.aligned_rows(Vl)
    # B1's β=1 epilogue only where the numerator stays local
    epilogue_H = (beta == 1 and gamma == 1 and l1_reg == 0
                  and l2_reg == 0 and model is None)

    def reduce_model(*xs):
        if model is not None:
            model.all_reduce(*xs)

    def upd_W(w, h):
        if beta == 2:  # Gram: (Vᵀ h, w (hᵀh)), both summed over the rows
            neg, G = target_tmm(Vl, h), h.T @ h
            data.all_reduce(neg, G)
            return _mu_step(w, neg, torch.relu(w @ G) + eps, gamma, l1_reg,
                            l2_reg)
        neg, pos = fused_mu.w_side_contractions(Vl, h, w, beta, need_pos)
        if beta == 1:
            pos = torch.sum(h, dim=0, keepdim=True)
        data.all_reduce(neg, pos)
        pos = pos if beta == 1 else torch.relu(pos) + eps
        return _mu_step(w, neg, pos, gamma, l1_reg, l2_reg)

    def upd_H(w, h):
        if beta == 2:  # Gram: (V w, h (wᵀw)), summed over the columns
            neg, G = target_mm(Vl, w), w.T @ w
            reduce_model(neg, G)
            return _mu_step(h, neg, torch.relu(h @ G) + eps, gamma, l1_reg,
                            l2_reg)
        if epilogue_H:
            out, _ = fused_mu.fused_contractions(
                Vl, h, w, beta=1.0, need_pos=False, w_side=False,
                mu_pos=torch.sum(w, dim=0, keepdim=True))
            return out
        neg, pos = fused_mu.h_side_contractions(Vl, h, w, beta, need_pos)
        if beta == 1:
            pos = torch.sum(w, dim=0, keepdim=True)
        reduce_model(neg, pos)
        pos = pos if beta == 1 else torch.relu(pos) + eps
        return _mu_step(h, neg, pos, gamma, l1_reg, l2_reg)

    def loss_of(state):
        w, h = state
        if need_pos:
            part = fused_mu.fused_beta_loss(Vl, h, w, beta)
        else:  # the dense fit's, over row blocks of the local V
            part = _blocked_loss(beta)(Vl, w, h)
        part = part.reshape(1).clone()
        data.all_reduce(part)
        reduce_model(part)
        return torch.sqrt(2.0 * part[0])

    def one_iter(state):
        w, h = state
        w = upd_W(w, h)
        return w, upd_H(w, h)

    with torch.no_grad():
        (Wl, Hl), k, conv = _converging_loop(one_iter, loss_of, (Wl, Hl), tol,
                                             max_iter)
    return (as_dtensor(Wl, mesh, w_pl, shapes["W"]),
            as_dtensor(Hl, mesh, h_pl, shapes["H"]),
            k * 10 if conv else max_iter)


def _alpha(a, device):
    return torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor)
                           else a, dtype=torch.float32, device=device)


def sharded_plca_fit(V, W, H, Z, mesh, tol: float = 1e-4, max_iter: int = 200,
                     W_alpha=1.0, H_alpha=1.0, Z_alpha=1.0,
                     update_W: bool = True, update_H: bool = True,
                     update_Z: bool = True, data_axis: str = "data",
                     verbose: bool = False):
    """EM-fit plain PLCA with the samples (rows of ``V (M, K)`` and ``H (M,
    R)``) sharded over ``data_axis``; ``W (K, R)`` and ``Z (R,)`` are
    replicated.  The inputs must be probability-normalized, as the
    :class:`~..plca.PLCA` constructor leaves them.

    Per iteration one E-step (the backward pass of the local
    reconstruction), whose W and Z gradients are all-reduced, then the
    M-step, whose H marginal is all-reduced; ``norm`` (``V``'s sum) is
    all-reduced once.  Returns ``(W, H, Z, n_iter, norm)``: DTensors (``H``
    sharded, ``W``/``Z`` replicated), the reference's raw loop index
    (``10·k - 1`` when chunk ``k`` converged, else ``max_iter - 1``) and a
    float.  ``verbose`` reports the cadence loss and log-probability from
    rank 0."""
    tol, max_iter = float(tol), int(max_iter)
    Wa, Ha, Za = (alpha_is_active(a) for a in (W_alpha, H_alpha, Z_alpha))
    rows, rep = placements(mesh, {0: data_axis}), placements(mesh, {})
    shapes = (tuple(W.shape), tuple(H.shape), tuple(Z.shape))
    Vl = local_block(V, mesh, rows, target=True)
    Hl = local_block(H, mesh, rows)
    Wl, Zl = local_block(W, mesh, rep), local_block(Z, mesh, rep)
    dev = Vl.device
    W_alpha, H_alpha, Z_alpha = (_alpha(a, dev)
                                 for a in (W_alpha, H_alpha, Z_alpha))
    data = comm_for(mesh, data_axis)

    def summed(x):
        x = x.reshape(-1).clone() if x.ndim == 0 else x.clone()
        data.all_reduce(x)
        return x

    def recon3(h, w, z):
        return h @ (w * z).T

    def h_marginal(h):
        return summed(_plca_marginal_sum(h))

    with torch.no_grad():
        # the sum in float32 over the ranks (every collective carries
        # float32), then in V's dtype, as the single-card fit's V.sum()
        norm = summed(Vl.sum(dtype=torch.float32))[0].to(Vl.dtype)
        Vn = Vl / norm

        def loss_of(state):
            w, h, z = state
            part = kl_div(recon3(h, w, z) * norm, Vn * norm)
            return torch.sqrt(2.0 * summed(part)[0])

        def log_probability(state):
            w, h, z = state
            WZH = recon3(h, w, z)
            lp = summed(matmul(Vn.reshape(-1),
                               torch.log(WZH + eps).reshape(-1)))[0]
            lp = lp + torch.sum(torch.log(w + eps) * (W_alpha - 1.0))
            lp = lp + summed(torch.sum(torch.log(h + eps)
                                       * (H_alpha - 1.0)))[0]
            return lp + torch.sum(torch.log(z + eps) * (Z_alpha - 1.0))

        def one_iter(state):
            w, h, z = state
            gH, gW, gZ = _plca_e_step(recon3, Vn, w, h, z)
            data.all_reduce(gW if update_W else None,
                            gZ if update_Z else None)
            return _plca_m_step(update_W, update_H, update_Z, Wa, Ha, Za, w,
                                h, z, gH, gW, gZ, W_alpha, H_alpha, Z_alpha,
                                h_marginal=h_marginal)

        with _reporter(mesh, verbose, max_iter) as report:
            (Wl, Hl, Zl), k, conv = _converging_loop(
                one_iter, loss_of, (Wl, Hl, Zl), tol, max_iter, report,
                extra_of=log_probability)
    return (as_dtensor(Wl, mesh, rep, shapes[0]),
            as_dtensor(Hl, mesh, rows, shapes[1]),
            as_dtensor(Zl, mesh, rep, shapes[2]),
            k * 10 - 1 if conv else max_iter - 1, float(norm))

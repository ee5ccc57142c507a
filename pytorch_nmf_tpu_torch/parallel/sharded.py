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
the collectives explicit (:mod:`.comm`).  A DTensor's local tensor is this
rank's block as it is.

The fits are compiled once per configuration, as the JAX package jits its
``shard_map`` fits (:func:`_run_fit`): their chunk loop runs on the fits'
cache of ``ops/solver.py`` (``_graphed_loop``), over NCCL as one CUDA-graph
WHILE node whose body holds the chunk's all-reduces (across ranks with
NCCL's graph mixing support off, :func:`_compiles`), on a ``"cpu"`` mesh
eagerly as every CPU fit runs it; over ``"gloo-staged"`` the eager loop.
The ranks agree on the loop's path before its first chunk
(``solver._agree_path``), so that they capture together.  The halo fits
(:mod:`.halo`) run on the same machinery.
"""

import contextlib
import functools
import os
from types import SimpleNamespace
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
from ..ops.solver import (_CACHE, _converging_loop, _graphed_loop, _keep,
                          _load, _plca_e_step, _plca_m_step,
                          _plca_marginal_sum, _progress, alpha_is_active)
from .comm import agree_min, comm_for, drop_entries_on_destroy

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
    is a full array (numpy or tensor, the same on every rank), cut to this
    rank's block, or a ``DTensor`` with placements ``pls``, whose local
    tensor is this rank's block as it is (not cut again: C9; a DTensor
    placed otherwise, or on another mesh, is gathered whole and cut).  A
    2-D target on a card has 16-byte aligned rows, as B1/B2 read them: kept
    where it has them, a copy where not (``fused_mu.aligned_copy``)."""
    device = torch.device(mesh_device(mesh) if device is None else device)
    if isinstance(x, DTensor) and (x.device_mesh != mesh
                                   or list(x.placements) != list(pls)):
        # placed otherwise (e.g. a declined fit's replicated factors):
        # gathered whole, then cut
        x = _block(full_array(x), mesh, pls)
    elif isinstance(x, DTensor):
        with torch.no_grad():  # the local tensor itself, not a view of it
            x = x.to_local()
    else:
        x = _block(host_tensor(x).detach(), mesh, pls)
    dtype = target_dtype(x.dtype, torch.float32) if target else torch.float32
    if target and x.ndim == 2 and device.type == "cuda":
        if x.device != device or x.dtype != dtype:
            return fused_mu.aligned_copy(x, device, dtype)
        return fused_mu.aligned_rows(x)
    return x.to(device=device, dtype=dtype).contiguous()


def full_array(x):
    """``x`` whole on this rank: a ``DTensor`` gathered from its ranks'
    blocks (one :meth:`~.comm.Comm.all_gather` a sharded mesh dimension of
    more than one rank; every rank calls it; where there is none, the local
    tensor itself), anything else as a tensor
    (``models._common.host_tensor``)."""
    if not isinstance(x, DTensor):
        return host_tensor(x).detach()
    mesh = x.device_mesh
    with torch.no_grad():
        out = local = x.to_local()
    dims = [p.dim for p in x.placements if isinstance(p, Shard)]
    if len(set(dims)) != len(dims) or not all(
            isinstance(p, (Shard, Replicate)) for p in x.placements):
        raise ValueError(f"a DTensor placed {x.placements}: the fits take "
                         "each dimension sharded over one mesh dimension")
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and mesh.size(i) > 1:
            comm = comm_for(mesh, mesh.mesh_dim_names[i])
            n = x.shape[p.dim]
            pad = list(out.shape)
            pad[p.dim] = -(-n // comm.size) - out.shape[p.dim]
            out = torch.cat([out, out.new_zeros(pad)], dim=p.dim)
            out = torch.cat(comm.all_gather(out), dim=p.dim).narrow(p.dim, 0, n)
    # the local tensor itself where nothing was gathered: a fit's target
    # keeps its identity, which keys the fits' cache
    return out if out is local and not out.requires_grad else out.detach()


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


def _compiles(comms) -> bool:
    """Whether a sharded fit's chunk loop runs on the fits' cache (the
    choice is made up front, from the transports): over gloo on the CPU
    (the same workload, run eagerly) and over NCCL, captured on the card,
    where a WHILE node's body can hold the all-reduces and the halo
    shifts' sends and receives: on one rank, or with NCCL's graph mixing
    support off (``NCCL_GRAPH_MIXING_SUPPORT=0``, which
    :func:`.distributed.initialize` sets; with it on, NCCL records event
    nodes that a body refuses: ``chip_tools/while_capture_probe.py``
    ``body_nccl_all_reduce_mixing_cards``,
    ``body_nccl_shift_mixing_cards``).  Not over ``"gloo-staged"``,
    whose collectives synchronize the host inside each call, which no
    graph holds."""
    mixing = os.environ.get("NCCL_GRAPH_MIXING_SUPPORT", "1") != "0"
    return all(c.transport == "gloo" or (
        c.transport == "nccl" and (c.size == 1 or not mixing))
        for c in comms if c is not None)


def _run_fit(mesh, comms, chunk, targets, args, state0, fns_of, tol,
             max_iter, graph, report=None):
    """The chunk loop of a sharded fit: ``(state, k, converged)``.
    ``fns_of(entry)`` derives what the fit reads from the target into the
    entry (at every fit) and makes its closures (``one_iter``, ``loss_of``,
    ``extra_of``; once an entry).  Where :func:`_compiles`, on the fits'
    cache (``ops/solver.py``; ``chunk`` and ``args`` key it, ``targets``
    identify it, or none where the entry keeps its own copy of the
    target, the halo fits') through ``_graphed_loop``, the ranks agreeing
    on its path first (:func:`.comm.agree_min`); otherwise, or with
    ``graph`` false
    (the eager twin), ``_converging_loop``.  No retry out of memory: the
    other ranks would not retry with it."""
    cached = graph and _compiles(comms)
    with _CACHE.use(chunk, targets, args, cached) as e:
        if cached:  # the entry goes when one of its groups is destroyed
            e.groups.update(c.group for c in comms if c is not None)
            drop_entries_on_destroy()
        f = fns_of(e)
        if not cached:
            return _converging_loop(f.one_iter, f.loss_of, state0, tol,
                                    max_iter, report, f.extra_of)
        return _graphed_loop(f.one_iter, f.loss_of, state0, tol, max_iter,
                             report, f.extra_of, entry=e,
                             agree=functools.partial(agree_min, mesh))


def _nmf_fns(e, beta, gamma, l1_reg, l2_reg, data, model, epilogue_H,
             need_pos, update_W, update_H):
    """The sharded MU fit's closures on the entry's target ``e.V``."""
    def reduce_model(*xs):
        if model is not None:
            model.all_reduce(*xs)

    def upd_W(w, h):
        V = e.V
        if beta == 2:  # Gram: (Vᵀ h, w (hᵀh)), both summed over the rows
            neg, G = target_tmm(V, h), h.T @ h
            data.all_reduce(neg, G)
            return _mu_step(w, neg, torch.relu(w @ G) + eps, gamma, l1_reg,
                            l2_reg)
        neg, pos = fused_mu.w_side_contractions(V, h, w, beta, need_pos)
        if beta == 1:
            pos = torch.sum(h, dim=0, keepdim=True)
        data.all_reduce(neg, pos)
        pos = pos if beta == 1 else torch.relu(pos) + eps
        return _mu_step(w, neg, pos, gamma, l1_reg, l2_reg)

    def upd_H(w, h):
        V = e.V
        if beta == 2:  # Gram: (V w, h (wᵀw)), summed over the columns
            neg, G = target_mm(V, w), w.T @ w
            reduce_model(neg, G)
            return _mu_step(h, neg, torch.relu(h @ G) + eps, gamma, l1_reg,
                            l2_reg)
        if epilogue_H:
            out, _ = fused_mu.fused_contractions(
                V, h, w, beta=1.0, need_pos=False, w_side=False,
                mu_pos=torch.sum(w, dim=0, keepdim=True))
            return out
        neg, pos = fused_mu.h_side_contractions(V, h, w, beta, need_pos)
        if beta == 1:
            pos = torch.sum(w, dim=0, keepdim=True)
        reduce_model(neg, pos)
        pos = pos if beta == 1 else torch.relu(pos) + eps
        return _mu_step(h, neg, pos, gamma, l1_reg, l2_reg)

    def loss_of(state):
        w, h = state
        if need_pos:
            part = fused_mu.fused_beta_loss(e.V, h, w, beta)
        else:  # the dense fit's, over row blocks of the local V
            part = _blocked_loss(beta)(e.V, w, h)
        part = part.reshape(1).clone()
        data.all_reduce(part)
        reduce_model(part)
        return torch.sqrt(2.0 * part[0])

    def one_iter(state):
        w, h = state
        if update_W:
            w = upd_W(w, h)
        if update_H:
            h = upd_H(w, h)
        return w, h

    return SimpleNamespace(one_iter=one_iter, loss_of=loss_of, extra_of=None)


def sharded_nmf_fit(V, W, H, mesh, beta: float = 1, tol: float = 1e-4,
                    max_iter: int = 200, l1_reg: float = 0.0,
                    l2_reg: float = 0.0, data_axis: str = "data",
                    model_axis: Optional[str] = None, use_pallas=None,
                    _graph: bool = True, _update_W: bool = True,
                    _update_H: bool = True, _verbose: bool = False):
    """Fit ``V ≈ H Wᵀ`` on ``mesh`` with explicit collectives.

    ``V (M, K)`` is sharded over ``data_axis`` (rows) and ``model_axis``
    (columns, when given), ``H (M, R)`` over ``data_axis``, ``W (K, R)``
    over ``model_axis`` (replicated without one).  Every rank calls it with
    the full arrays or with DTensors so placed (the fit's own outputs, or
    :func:`shard_target`'s).  Returns ``(W, H, n_iter)``: ``W`` and ``H``
    DTensors with those placements, ``n_iter`` an int (``10·k`` when chunk
    ``k`` converged, else ``max_iter``), the same on every rank.

    Compiled once per configuration, as the JAX package jits its
    ``shard_map`` fit: over NCCL (across ranks with
    ``NCCL_GRAPH_MIXING_SUPPORT=0``, as :func:`.distributed.initialize`
    sets it) the chunk loop is one CUDA-graph WHILE node with the
    all-reduces captured, kept on the fits' cache
    (``ops/solver.py``) per configuration and target block; a fit on a
    ``shard_target`` DTensor made once replays it (one replay and one host
    read a rank), while full arrays make a new local block, a new target,
    each call (one capture).  On a ``"cpu"`` mesh (gloo) the same workload
    runs eagerly; over ``"gloo-staged"`` (ranks sharing a card) the eager
    loop runs, as does ``_graph=False`` (private: the eager twin of the
    checks).  ``torch.distributed.destroy_process_group`` drops the
    entries of the groups it destroys first (their graphs hold captured
    NCCL kernels of those groups: :func:`.comm.drop_entries_on_destroy`),
    so no cache clear is needed before it; ``ops.solver.
    compiled_cache_clear()`` empties the whole cache at any time.

    ``_update_W``, ``_update_H`` and ``_verbose`` (private, so that the
    signature stays the JAX package's) are what the model API's route
    passes (``models/nmf.py``: ``NMF.fit`` on a DTensor target): the
    factors' ``requires_grad`` and the progress reports, from rank 0.

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
    # B1's β=1 epilogue only where the numerator stays local
    epilogue_H = (beta == 1 and gamma == 1 and l1_reg == 0
                  and l2_reg == 0 and model is None)

    def fns_of(e):
        if e.fns is None:
            e.fns = _nmf_fns(e, beta, gamma, l1_reg, l2_reg, data, model,
                             epilogue_H, need_pos, update_W, update_H)
        return e.fns

    # what the chunk reads: every argument but max_iter and verbose (the
    # groups through their Comm); the blocks' signatures join the key in
    # the cache
    update_W, update_H = bool(_update_W), bool(_update_H)
    chunk = ("sharded_nmf", beta, tol, l1_reg, l2_reg, data, model, update_W,
             update_H)
    with torch.no_grad(), _reporter(mesh, _verbose, max_iter) as report:
        (Wl, Hl), k, conv = _run_fit(mesh, (data, model), chunk, (Vl,),
                                     (Vl, Wl, Hl), (Wl, Hl), fns_of, tol,
                                     max_iter, _graph, report)
    return (as_dtensor(Wl, mesh, w_pl, shapes["W"]),
            as_dtensor(Hl, mesh, h_pl, shapes["H"]),
            k * 10 if conv else max_iter)


def _alpha(a, device):
    return torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor)
                           else a, dtype=torch.float32, device=device)


def _plca_fns(e, data, update_W, update_H, update_Z, Wa, Ha, Za):
    """The sharded EM fit's closures on the entry's ``Vn``, ``norm`` and
    priors (``e.derived``)."""
    d = e.derived
    norm, Vn, (W_alpha, H_alpha, Z_alpha) = d["norm"], d["Vn"], d["alphas"]

    def summed(x):
        x = x.reshape(-1).clone() if x.ndim == 0 else x.clone()
        data.all_reduce(x)
        return x

    def recon3(h, w, z):
        return h @ (w * z).T

    def h_marginal(h):
        return summed(_plca_marginal_sum(h))

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
        lp = lp + summed(torch.sum(torch.log(h + eps) * (H_alpha - 1.0)))[0]
        return lp + torch.sum(torch.log(z + eps) * (Z_alpha - 1.0))

    def one_iter(state):
        w, h, z = state
        gH, gW, gZ = _plca_e_step(recon3, Vn, w, h, z)
        data.all_reduce(gW if update_W else None, gZ if update_Z else None)
        return _plca_m_step(update_W, update_H, update_Z, Wa, Ha, Za, w, h, z,
                            gH, gW, gZ, W_alpha, H_alpha, Z_alpha,
                            h_marginal=h_marginal)

    return SimpleNamespace(one_iter=one_iter, loss_of=loss_of,
                           extra_of=log_probability)


def sharded_plca_fit(V, W, H, Z, mesh, tol: float = 1e-4, max_iter: int = 200,
                     W_alpha=1.0, H_alpha=1.0, Z_alpha=1.0,
                     update_W: bool = True, update_H: bool = True,
                     update_Z: bool = True, data_axis: str = "data",
                     verbose: bool = False, _graph: bool = True):
    """EM-fit plain PLCA with the samples (rows of ``V (M, K)`` and ``H (M,
    R)``) sharded over ``data_axis``; ``W (K, R)`` and ``Z (R,)`` are
    replicated.  The inputs (full arrays or DTensors so placed) must be
    probability-normalized, as the :class:`~..plca.PLCA` constructor
    leaves them.

    Per iteration one E-step (the backward pass of the local
    reconstruction), whose W and Z gradients are all-reduced, then the
    M-step, whose H marginal is all-reduced; ``norm`` (``V``'s sum) is
    all-reduced once a fit.  Returns ``(W, H, Z, n_iter, norm)``: DTensors
    (``H`` sharded, ``W``/``Z`` replicated), the reference's raw loop index
    (``10·k - 1`` when chunk ``k`` converged, else ``max_iter - 1``) and a
    float.  ``verbose`` reports the cadence loss and log-probability from
    rank 0 (every rank computes them: one chunk a call, each rank reading
    them).  Compiled as :func:`sharded_nmf_fit` is (``_graph`` likewise);
    an entry keeps ``norm``, ``Vn`` and the priors, recomputed from the
    target's block and copied in at every fit."""
    tol, max_iter = float(tol), int(max_iter)
    Wa, Ha, Za = (alpha_is_active(a) for a in (W_alpha, H_alpha, Z_alpha))
    rows, rep = placements(mesh, {0: data_axis}), placements(mesh, {})
    shapes = (tuple(W.shape), tuple(H.shape), tuple(Z.shape))
    Vl = local_block(V, mesh, rows, target=True)
    Hl = local_block(H, mesh, rows)
    Wl, Zl = local_block(W, mesh, rep), local_block(Z, mesh, rep)
    dev = Vl.device
    alphas = tuple(_alpha(a, dev) for a in (W_alpha, H_alpha, Z_alpha))
    data = comm_for(mesh, data_axis)

    got = {}

    def fns_of(e):
        d, V = e.derived, e.V
        # the sum in float32 over the ranks (every collective carries
        # float32), then in V's dtype, as the single-card fit's V.sum()
        part = V.sum(dtype=torch.float32).reshape(1)
        data.all_reduce(part)
        _keep(d, "norm", part[0].to(V.dtype))
        if "Vn" in d:
            torch.div(V, d["norm"], out=d["Vn"])
            _load(d["alphas"], alphas)
        else:
            d["Vn"] = V / d["norm"]
            d["alphas"] = tuple(a.clone() for a in alphas)
        if e.fns is None:
            e.fns = _plca_fns(e, data, update_W, update_H, update_Z, Wa, Ha,
                              Za)
        got["norm"] = d["norm"]
        return e.fns

    # a reporting chunk also computes the log-probability
    chunk = ("sharded_plca", tol, update_W, update_H, update_Z, Wa, Ha, Za,
             bool(verbose), data)
    with torch.no_grad(), _reporter(mesh, verbose, max_iter) as report:
        (Wl, Hl, Zl), k, conv = _run_fit(
            mesh, (data,), chunk, (Vl,), (Vl, Wl, Hl, Zl) + alphas,
            (Wl, Hl, Zl), fns_of, tol, max_iter, _graph, report)
    return (as_dtensor(Wl, mesh, rep, shapes[0]),
            as_dtensor(Hl, mesh, rows, shapes[1]),
            as_dtensor(Zl, mesh, rep, shapes[2]),
            k * 10 - 1 if conv else max_iter - 1, float(got["norm"]))

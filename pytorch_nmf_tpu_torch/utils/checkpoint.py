"""Checkpoint and resume (counterpart of
:mod:`pytorch_nmf_tpu.utils.checkpoint`).

The reference's checkpoint story is ``nn.Module.state_dict()`` /
``load_state_dict()``; resuming is re-entering ``fit``, since a fit starts
from the model's factors.  This module adds durable files on disk:

* :func:`save` / :func:`load` — single-file ``.npz`` checkpoints;
* :func:`save_sharded` / :func:`load_sharded` — checkpoints of DTensor
  factors in which each rank writes its own blocks, over
  ``torch.distributed.checkpoint`` (the counterparts of the JAX package's
  orbax pair, ``save_orbax``/``load_orbax``);
* :func:`checkpointed_fit` / :func:`checkpointed_plca_fit` — a long fit run
  in segments, with the factors and the convergence bookkeeping written
  after each, and an exact resume.

The ``.npz`` files are the JAX package's: the same layout, the same
``__ckpt_`` metadata keys and the same run identity, so either package
resumes a directory the other wrote.  The sharded pair's files are DCP's,
not orbax's: neither package reads the other's.

A :class:`~torch.distributed.tensor.DTensor` target (a fit across ranks,
``model.fit`` routed to the sharded or halo fits) and DTensor factors go
through every function here; every rank of the mesh calls it.  ``save``
and the segments' files gather each DTensor whole on every rank and rank 0
of the mesh alone writes (the whole array, as the JAX package writes it),
the others waiting for it; every rank reads a file, and a DTensor factor
takes its own block of each value (``load_state_dict``,
``models._common.load_placed``).  The losses at the boundaries are the
metrics' block sums over the ranks (:mod:`..metrics`).
"""

import os
from collections import OrderedDict

import numpy as np
import torch

from ..models._common import gather_whole, is_dtensor

__all__ = ["save", "load", "save_sharded", "load_sharded",
           "checkpointed_fit", "checkpointed_plca_fit"]


def _as_state(obj):
    """A module's ``state_dict`` or a plain mapping."""
    if hasattr(obj, "state_dict"):
        return obj.state_dict()
    return OrderedDict(obj)


def _numpy(v):
    """A value as a numpy array; a DTensor gathered whole (every rank of
    its mesh calls it)."""
    if isinstance(v, torch.Tensor):
        return gather_whole(v.detach()).cpu().numpy()
    return np.asarray(v)


def _mesh_of(values):
    """The mesh of the first DTensor among ``values``, or ``None``."""
    return next((v.device_mesh for v in values if is_dtensor(v)), None)


def _writes(mesh) -> bool:
    """Whether this rank writes the files of a run on ``mesh``: rank 0 of
    the mesh (any rank where there is no mesh)."""
    return mesh is None or all(c == 0 for c in mesh.get_coordinate())


def _barrier(mesh) -> None:
    """Every rank of ``mesh`` waits here for the others (after rank 0's
    write): one agreement over the mesh's ranks through the default
    group's store (``parallel/comm.py::agree_min``)."""
    if mesh is not None:
        from ..parallel.comm import agree_min

        agree_min(mesh, 0)


def save(path: str, obj) -> None:
    """Save a model's (or a mapping's) tensors to one ``.npz`` file.  With
    DTensor values every rank of their mesh calls it: each gathers them
    whole, rank 0 of the mesh writes, the others wait for it."""
    state = _as_state(obj)
    mesh = _mesh_of(state.values())
    arrays = {k: _numpy(v) for k, v in state.items()}
    if _writes(mesh):
        np.savez(path, **arrays)
    _barrier(mesh)


def load(path: str, model=None):
    """Load an ``.npz`` checkpoint: into ``model`` when given (returned;
    into DTensor factors each rank's block of each value), else as a
    mapping of CPU tensors."""
    with np.load(path) as data:
        state = OrderedDict((k, torch.from_numpy(data[k])) for k in data.files)
    if model is not None:
        model.load_state_dict(state)
        return model
    return state


_META_PREFIX = "__ckpt_"


def _run_id(model, V, tag: str, fit_kwargs) -> str:
    """The run's identity: the model class, the target's shape, every
    factor's shape and trainability, and the whole fit configuration (the
    JAX package's string, so the two packages' runs recognize each
    other)."""
    shapes = ";".join(
        f"{k}{tuple(v.shape)}" for k, v in model.state_dict().items())
    trainable = ",".join(str(int(p.requires_grad)) for p in model.parameters())
    cfg = ",".join(f"{k}={fit_kwargs[k]!r}" for k in sorted(fit_kwargs))
    return (f"{type(model).__name__}|V{tuple(V.shape)}|{shapes}"
            f"|tr={trainable}|{tag}|{cfg}")


def _ckpt_files(directory: str):
    try:
        names = sorted(n for n in os.listdir(directory)
                       if n.startswith("ckpt_") and n.endswith(".npz"))
    except FileNotFoundError:
        return []
    return [os.path.join(directory, n) for n in names]


def checkpointed_fit(
    model, V, beta: float = 1, tol: float = 1e-4, max_iter: int = 200,
    every: int = 50, directory: str = "checkpoints", resume: bool = True,
    keep: int = 2, **fit_kwargs,
):
    """A long β-MU ``model.fit`` in segments of ``every`` iterations, with
    the factors and the convergence bookkeeping (iterations done, the run's
    initial loss, the loss at the last boundary) written after each.

    A killed job re-enters with ``resume=True`` and continues from the last
    checkpoint against the same baseline: the reference's stop rule
    ``(prev - loss) / loss_init < tol`` (nmf.py:405) is evaluated at segment
    boundaries against the original ``loss_init`` (each segment runs with
    the in-fit stop off, so the iteration count stays exact).  The
    checkpoint records the run identity and a converged flag: resuming a
    converged run with the same ``tol`` does nothing, and a directory of
    another run raises ``ValueError``.

    Works for every β-MU model (``NMF`` and the deconvolutional family) on
    dense targets, and for ``NMF`` on a sparse COO tensor.  ``V`` moves to
    the model's device once; a DTensor ``V`` stays where it is (every rank
    of its mesh calls this; each segment's ``model.fit`` routes it, the
    module docstring).  Returns the iterations run over all sessions."""
    from ..metrics import beta_div
    from ..models._common import target_like
    from ..ops.sparse import get_V_norm

    if every < 1:
        raise ValueError("every must be >= 1")
    os.makedirs(directory, exist_ok=True)
    beta = float(beta)
    if not is_dtensor(V):
        V = target_like(V, model.W, model.H)
    is_sp = V.layout != torch.strided
    if is_sp:
        if type(model)._sp_pos_neg is None:
            raise NotImplementedError(
                f"{type(model).__name__} does not support sparse targets.")
        V = V.coalesce()
        V_norm = get_V_norm(V, beta)
    run_id = _run_id(model, V, f"beta={beta}", fit_kwargs)

    @torch.no_grad()
    def current_loss():
        if is_sp:
            pos, neg = type(model)._sp_pos_neg(V, model.H, model.W, beta)
            return float(torch.sqrt(2.0 * (V_norm + pos - neg)))
        return float(torch.sqrt(2.0 * beta_div(model(), V, beta)))

    def run_segment(seg):
        model.fit(V, beta, float("-inf"), seg, **fit_kwargs)

    return _checkpoint_loop(model, run_id, current_loss, run_segment, tol,
                            max_iter, every, directory, resume, keep,
                            _mesh_of([V]))


def _checkpoint_loop(model, run_id, current_loss, run_segment, tol, max_iter,
                     every, directory, resume, keep, mesh=None):
    """The segmented loop shared by both fits: resume (identity and
    converged-flag checks), run the segments, write each checkpoint
    atomically, prune to ``keep`` files, stop on the reference rule against
    the original baseline.  On a ``mesh`` (a DTensor target) every rank
    reads the last file, rank 0 alone writes and prunes, and the ranks
    wait for each other after the read and after each write; the losses
    are the same on every rank, and so are the decisions."""
    done = 0
    loss_init = prev_loss = None
    files = _ckpt_files(directory) if resume else []
    if files:
        with np.load(files[-1]) as data:
            keys = set(data.files)
            if _META_PREFIX + "run_id" in keys:
                stored_id = str(data[_META_PREFIX + "run_id"])
                if stored_id != run_id:
                    raise ValueError(
                        f"checkpoint directory {directory!r} belongs to a "
                        f"different run ({stored_id} != {run_id}); point "
                        "each fit at its own directory or pass resume=False")
            missing = [k for k in ("iter", "loss_init", "prev_loss")
                       if _META_PREFIX + k not in keys]
            if missing:
                raise ValueError(
                    f"checkpoint {files[-1]!r} lacks resume metadata "
                    f"({missing}); it was not written by checkpointed_fit "
                    "— pass resume=False or point at a segmented-fit "
                    "directory")
            state = OrderedDict((k, torch.from_numpy(data[k]))
                                for k in data.files
                                if not k.startswith(_META_PREFIX))
            done = int(data[_META_PREFIX + "iter"])
            loss_init = float(data[_META_PREFIX + "loss_init"])
            prev_loss = float(data[_META_PREFIX + "prev_loss"])
            converged = (bool(data[_META_PREFIX + "converged"])
                         if _META_PREFIX + "converged" in keys else False)
            stored_tol = (float(data[_META_PREFIX + "tol"])
                          if _META_PREFIX + "tol" in keys else None)
        model.load_state_dict(state)
        _barrier(mesh)  # every rank has read the file rank 0 will replace
        # a converged run resumes as a no-op, for the same tolerance only: a
        # tighter one goes on to the next boundary
        if converged and stored_tol == tol:
            return done

    if loss_init is None:
        loss_init = prev_loss = current_loss()

    while done < max_iter:
        seg = min(every, max_iter - done)
        run_segment(seg)
        done += seg
        loss = current_loss()
        conv = (prev_loss - loss) / loss_init < tol
        state = {k: _numpy(v) for k, v in model.state_dict().items()}
        state[_META_PREFIX + "iter"] = np.int64(done)
        state[_META_PREFIX + "loss_init"] = np.float64(loss_init)
        state[_META_PREFIX + "prev_loss"] = np.float64(loss)
        state[_META_PREFIX + "converged"] = np.bool_(conv)
        state[_META_PREFIX + "tol"] = np.float64(tol)
        state[_META_PREFIX + "run_id"] = np.str_(run_id)
        path = os.path.join(directory, f"ckpt_{done:08d}.npz")
        # the temporary name must not match _ckpt_files' pattern: a crash
        # mid-write must not leave a truncated checkpoint to resume from
        tmp = os.path.join(directory, f".tmp_ckpt_{done:08d}.npz")
        if _writes(mesh):
            np.savez(tmp, **state)
            os.replace(tmp, path)
            for old in _ckpt_files(directory)[:-keep]:
                os.remove(old)
        _barrier(mesh)
        if conv:
            break
        prev_loss = loss
    return done


def checkpointed_plca_fit(
    model, V, tol: float = 1e-4, max_iter: int = 200, every: int = 50,
    directory: str = "checkpoints", resume: bool = True, keep: int = 2,
    **fit_kwargs,
):
    """:func:`checkpointed_fit` for the PLCA family's EM ``fit``: the same
    segments and resume; the stop metric is the reference's
    ``sqrt(2 * kl_div(WZH * norm, V))`` (plca.py:291-301) at the segment
    boundaries.  Re-entering ``fit`` resumes exactly: the factors stay
    normalized between calls.  Returns ``(iterations, norm)``, ``norm =
    V.sum()`` (of a DTensor ``V``, its blocks' sums summed over the ranks:
    a plain scalar on every rank)."""
    from ..metrics import kl_div
    from ..models._common import target_like

    if every < 1:
        raise ValueError("every must be >= 1")
    os.makedirs(directory, exist_ok=True)
    if is_dtensor(V):
        from ..parallel.sharded import sharded_sum

        norm = sharded_sum(V)
    else:
        V = target_like(V, model.W, model.H, model.Z)
        norm = V.sum()
    run_id = _run_id(model, V, "plca", fit_kwargs)

    @torch.no_grad()
    def current_loss():
        return float(torch.sqrt(2.0 * kl_div(model() * norm, V)))

    def run_segment(seg):
        model.fit(V, float("-inf"), seg, **fit_kwargs)

    done = _checkpoint_loop(model, run_id, current_loss, run_segment, tol,
                            max_iter, every, directory, resume, keep,
                            _mesh_of([V]))
    return done, norm


def _no_dist() -> bool:
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized())


def save_sharded(path: str, obj) -> None:
    """Save a model's (or a mapping's) tensors as a
    ``torch.distributed.checkpoint`` directory (the counterpart of the JAX
    package's ``save_orbax``): each rank writes its own blocks of a DTensor
    value, a plain value is written once (by one rank), and the
    coordinator writes the metadata.  With a process group every rank of it
    calls this; without one it runs in this process alone, as the JAX pair
    runs on one device."""
    import torch.distributed.checkpoint as dcp

    dcp.save(dict(_as_state(obj)),
             storage_writer=dcp.FileSystemWriter(os.path.abspath(path)),
             no_dist=_no_dist())


def load_sharded(path: str, model=None):
    """Load a :func:`save_sharded` directory (the counterpart of
    ``load_orbax``): into ``model`` in place when given (returned), each
    rank reading the blocks its DTensor factors hold, with their
    placements, and a plain factor whole; without a model, the mapping of
    whole CPU tensors, made from the checkpoint's metadata, read in this
    process alone."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    reader = dcp.FileSystemReader(os.path.abspath(path))
    if model is not None:  # into the parameters' own storage
        dcp.load(model.state_dict(), storage_reader=reader,
                 no_dist=_no_dist())
        return model
    state = OrderedDict(
        (k, torch.empty(tuple(m.size), dtype=m.properties.dtype))
        for k, m in reader.read_metadata().state_dict_metadata.items()
        if isinstance(m, TensorStorageMetadata))
    dcp.load(state, storage_reader=reader, no_dist=True)
    return state

"""Checkpoint and resume (counterpart of
:mod:`pytorch_nmf_tpu.utils.checkpoint`).

The reference's checkpoint story is ``nn.Module.state_dict()`` /
``load_state_dict()``; resuming is re-entering ``fit``, since a fit starts
from the model's factors.  This module adds durable files on disk:

* :func:`save` / :func:`load` — single-file ``.npz`` checkpoints;
* :func:`checkpointed_fit` / :func:`checkpointed_plca_fit` — a long fit run
  in segments, with the factors and the convergence bookkeeping written
  after each, and an exact resume.

The files are the JAX package's: the same ``.npz`` layout, the same
``__ckpt_`` metadata keys and the same run identity, so either package
resumes a directory the other wrote.  (The JAX package's orbax variants
have no counterpart: orbax persists JAX arrays.)
"""

import os
from collections import OrderedDict

import numpy as np
import torch

__all__ = ["save", "load", "checkpointed_fit", "checkpointed_plca_fit"]


def _as_state(obj):
    """A module's ``state_dict`` or a plain mapping."""
    if hasattr(obj, "state_dict"):
        return obj.state_dict()
    return OrderedDict(obj)


def _numpy(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def save(path: str, obj) -> None:
    """Save a model's (or a mapping's) tensors to one ``.npz`` file."""
    np.savez(path, **{k: _numpy(v) for k, v in _as_state(obj).items()})


def load(path: str, model=None):
    """Load an ``.npz`` checkpoint: into ``model`` when given (returned),
    else as a mapping of CPU tensors."""
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
    the model's device once.  Returns the iterations run over all
    sessions."""
    from ..metrics import beta_div
    from ..models._common import target_like
    from ..ops.sparse import get_V_norm

    if every < 1:
        raise ValueError("every must be >= 1")
    os.makedirs(directory, exist_ok=True)
    beta = float(beta)
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
                            max_iter, every, directory, resume, keep)


def _checkpoint_loop(model, run_id, current_loss, run_segment, tol, max_iter,
                     every, directory, resume, keep):
    """The segmented loop shared by both fits: resume (identity and
    converged-flag checks), run the segments, write each checkpoint
    atomically, prune to ``keep`` files, stop on the reference rule against
    the original baseline."""
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
        np.savez(tmp, **state)
        os.replace(tmp, path)
        for old in _ckpt_files(directory)[:-keep]:
            os.remove(old)
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
    V.sum()``."""
    from ..metrics import kl_div
    from ..models._common import target_like

    if every < 1:
        raise ValueError("every must be >= 1")
    os.makedirs(directory, exist_ok=True)
    V = target_like(V, model.W, model.H, model.Z)
    norm = V.sum()
    run_id = _run_id(model, V, "plca", fit_kwargs)

    @torch.no_grad()
    def current_loss():
        return float(torch.sqrt(2.0 * kl_div(model() * norm, V)))

    def run_segment(seg):
        model.fit(V, float("-inf"), seg, **fit_kwargs)

    done = _checkpoint_loop(model, run_id, current_loss, run_segment, tol,
                            max_iter, every, directory, resume, keep)
    return done, norm

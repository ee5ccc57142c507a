r"""Training loops (counterpart of :mod:`pytorch_nmf_tpu.ops.solver`): the
dense and sparse-target β-divergence MU fits, the Hoyer sparseness-
constrained fit and the PLCA EM fit, and batched forms of the dense, Hoyer
and EM fits (a leading batch axis of independent problems).

The semantics are those of the reference ``BaseComponent.fit``
(``torchnmf/nmf.py:355-409``) as the JAX package compiles them:

* the loss is checked every 10 iterations, with the stop rule
  ``(prev - loss) / loss_init < tol``;
* ``n_iter = 10·k`` when the check of chunk ``k`` converged, else
  ``max_iter``; the ``max_iter % 10`` remainder iterations are skipped once
  converged;
* W updates against the old H, then H against the new W.

The loop is a Python loop over 10-iteration chunks; the host reads the
device once a chunk, for the stop rule (``_read.reads`` counts the loop's
reads).  The single-card dense and EM fits (:func:`get_dense_fit`,
:func:`get_plca_fit`) run each chunk (ten iterations, the loss, the stop
test on the device, the new state copied into static tensors) as one
in-place workload (:class:`~.graphs._Graphs`): on a CUDA device chunks 1-2
run eagerly, the second with synchronizing operations raising, and from
chunk 3 on the fit replays a CUDA graph of the chunk, captured once per
fit and freed when it returns; on the CPU the same workload is called
directly.  A chunk that cannot be captured raises.  The other fits (sparse,
Hoyer, batched; the sharded ones of :mod:`..parallel`) run the eager loop.
"""

import contextlib
import threading
from typing import Callable, Optional

import numpy as np
import torch

from ..constants import eps
from ..metrics import beta_div, kl_div
from . import sparse as _sparse
from .graphs import _Graphs
from .mu import (gamma_from_beta, kl_pos_H, kl_pos_W, mu_multiplier, mu_update,
                 renorm)
from .projection import hoyer_l1_target, proj_columns, proj_columns_explicit
from .recon import matmul

__all__ = ["get_dense_fit", "get_batched_dense_fit", "get_sparse_fit",
           "get_hoyer_fit", "get_batched_hoyer_fit", "get_plca_fit",
           "get_batched_plca_fit", "alpha_is_active", "push_progress_handler",
           "pop_progress_handler"]


def _default_updaters(recon2, beta, gamma, l1_reg, l2_reg, pos_W=kl_pos_W,
                      pos_H=kl_pos_H):
    """Per-factor updaters on the generic autograd MU engine; ``pos_W`` and
    ``pos_H`` are the analytic β=1 denominators (batched ones for a batched
    ``recon2``)."""
    def upd_W(V, W, H):
        pos_pre = pos_W(H) if beta == 1 else None
        return mu_update(
            lambda w: recon2(H, w), V, W, beta, gamma, l1_reg, l2_reg, pos_pre
        )

    def upd_H(V, W, H):
        pos_pre = pos_H(W) if beta == 1 else None
        return mu_update(
            lambda h: recon2(h, W), V, H, beta, gamma, l1_reg, l2_reg, pos_pre
        )

    return upd_W, upd_H


def _normalize_updaters(updaters):
    """Factory return values come in three arities:

    * ``(upd_W, upd_H)``
    * ``(upd_W, upd_H, loss_terms)``
    * ``(upd_W, upd_H, loss_terms, prepare, finish)`` — ``prepare(V, W, H)
      -> (w_state, h_state)`` converts the factors into the updaters'
      preferred layout once at fit entry, ``finish(V, w_state, h_state) ->
      (W, H)`` converts back at exit.

    Any other arity is rejected: a prepare without its inverse would leak
    the internal layout to the caller.
    """
    if len(updaters) not in (2, 3, 5):
        raise ValueError(
            f"updater factory returned {len(updaters)} elements; expected "
            "(upd_W, upd_H[, loss_terms[, prepare, finish]])"
        )
    return (tuple(updaters) + (None,) * 5)[:5]


# --------------------------------------------------------------------------
# Progress reporting: a verbose fit reports ``(chunk_index, loss, extra)``
# once per 10-iteration chunk to its own tqdm bar (or a printed line) and to
# every handler on a process-global stack, so a user's recorder
# (``utils.LossHistory``) coexists with the fit's bar.  The stack is guarded
# by a lock: a handler may be pushed or popped from another thread while a
# fit reports.
# --------------------------------------------------------------------------
_PROGRESS_HANDLERS = []
_PROGRESS_LOCK = threading.Lock()


def push_progress_handler(fn) -> None:
    """Register ``fn(chunk_idx, loss, extra)`` for every verbose fit's
    reports until :func:`pop_progress_handler`."""
    with _PROGRESS_LOCK:
        _PROGRESS_HANDLERS.append(fn)


def pop_progress_handler() -> None:
    """Remove the handler pushed last (no-op on an empty stack)."""
    with _PROGRESS_LOCK:
        if _PROGRESS_HANDLERS:
            _PROGRESS_HANDLERS.pop()


def _emit_progress(chunk_idx, loss, extra=None):
    with _PROGRESS_LOCK:  # a snapshot: a handler may pop itself
        handlers = list(_PROGRESS_HANDLERS)
    for handler in handlers:
        handler(int(chunk_idx), float(loss),
                None if extra is None else float(extra))


@contextlib.contextmanager
def _progress(verbose: bool, max_iter: int):
    """Yields ``report(chunk_idx, loss, extra=None)`` (or ``None``): a tqdm
    bar when tqdm is installed, else one printed line per 10-iteration
    chunk, and every registered progress handler.  ``extra`` is PLCA's
    log-probability."""
    if not verbose:
        yield None
        return
    try:
        from tqdm import tqdm
    except ImportError:
        def report(k, loss, extra=None):
            tail = "" if extra is None else f", log_prob={extra:.6g}"
            print(f"iter {k * 10}: loss={loss:.6g}{tail}")
            _emit_progress(k, loss, extra)

        yield report
        return
    with tqdm(total=max_iter) as bar:
        def report(k, loss, extra=None):
            if extra is None:
                bar.set_postfix(loss=loss)
            else:
                bar.set_postfix(loss=loss, log_prob=extra)
            bar.n = min(k * 10, max_iter)
            bar.refresh()
            _emit_progress(k, loss, extra)

        yield report


def _read(x, cast=float):
    """A host read of the device value ``x``, counted in ``_read.reads``:
    the chunked loops' only reads (the stop flag, and when verbose the
    reported values)."""
    _read.reads += 1
    return cast(x)


_read.reads = 0


def _converging_loop(
    one_iter: Callable,
    loss_of: Callable,
    state0,
    tol: float,
    max_iter: int,
    report: Optional[Callable] = None,
    extra_of: Optional[Callable] = None,
):
    """The chunked convergence loop: ``one_iter(state) -> state``,
    ``loss_of(state) -> 0-d tensor`` (on the reference's
    ``sqrt(2·divergence)`` scale); ``extra_of(state)``, read only when
    reporting, is a second value shown beside the loss.  Returns
    ``(state, n_chunks, converged)``."""
    loss_init = loss_of(state0)
    n_chunks, rem = divmod(max_iter, 10)
    state, prev, k, conv = state0, loss_init, 0, False
    while not conv and k < n_chunks:
        for _ in range(10):
            state = one_iter(state)
        loss = loss_of(state)
        # the one host sync per chunk; NaN compares False, as on the device
        conv = _read((prev - loss) / loss_init < tol, bool)
        prev, k = loss, k + 1
        if report is not None:
            report(k, _read(loss),
                   None if extra_of is None else _read(extra_of(state)))
    if rem and not conv:
        for _ in range(rem):
            state = one_iter(state)
    return state, k, conv


_CHUNK_NOT_CAPTURABLE = (
    "the fit's 10-iteration chunk cannot be captured in a CUDA graph: its "
    "updaters or loss read the card's values on the host (.item(), float(), "
    "bool() of a tensor, a copy from or to host memory) or do something "
    "else a graph cannot hold")


def _graphed_loop(
    one_iter: Callable,
    loss_of: Callable,
    state0,
    tol: float,
    max_iter: int,
    report: Optional[Callable] = None,
    extra_of: Optional[Callable] = None,
):
    """:func:`_converging_loop` with each chunk one in-place workload of
    :class:`~.graphs._Graphs` (own warm-ups: chunks 1-2 eager, the capture
    right after chunk 2 is enqueued when a third chunk may follow, then
    graph replays on a CUDA device; called directly on the CPU): ten iterations
    from static state tensors, the loss, the stop flag ``(prev - loss) /
    loss_init < tol`` on the device (NaN compares False), ``prev ← loss``
    and the new state copied into the static tensors.  The host reads the
    flag once a chunk (and the reported values when verbose).  The
    ``max_iter % 10`` remainder runs eagerly.  The same operations as
    :func:`_converging_loop`, so the same results bit for bit."""
    loss_init = loss_of(state0)
    n_chunks, rem = divmod(max_iter, 10)
    state, k, conv = state0, 0, False
    if n_chunks:
        st = tuple(x.clone() for x in state0)
        prev = loss_init.clone()
        stop = torch.zeros((), dtype=torch.bool, device=loss_init.device)
        extra = (torch.empty_like(loss_init)
                 if report is not None and extra_of is not None else None)

        def chunk():
            s = st
            for _ in range(10):
                s = one_iter(s)
            loss = loss_of(s)
            stop.copy_((prev - loss) / loss_init < tol)
            prev.copy_(loss)
            if extra is not None:
                extra.copy_(extra_of(s))
            for dst, x in zip(st, s):
                dst.copy_(x)

        graphs = _Graphs([chunk], None, loss_init.device,
                         _CHUNK_NOT_CAPTURABLE)
        while not conv and k < n_chunks:
            graphs()
            k += 1
            if k == 2 < n_chunks:  # the capture's host time overlaps chunk 2
                graphs.capture()
            conv = _read(stop, bool)
            if report is not None:
                report(k, _read(prev), None if extra is None else _read(extra))
        del graphs  # the graph and its pool go now
        state = st
    if rem and not conv:
        for _ in range(rem):
            state = one_iter(state)
    return state, k, conv


def get_dense_fit(
    recon2: Callable,
    beta: float,
    tol: float,
    max_iter: int,
    update_W: bool,
    update_H: bool,
    l1_reg: float,
    l2_reg: float,
    verbose: bool = False,
    updater_factory: Optional[Callable] = None,
    _graph: bool = True,
):
    """Returns ``fit(V, W, H) -> (W, H, n_iter)`` for the dense β-divergence
    MU fit.  ``updater_factory(beta, gamma, l1_reg, l2_reg)`` supplies the
    updaters (``None``, or a factory returning ``None``, selects the
    generic engine over ``recon2``).  The chunks run through
    :func:`_graphed_loop`; ``_graph=False`` (private: the eager reference
    of the card's checks) runs :func:`_converging_loop`."""
    loop = _graphed_loop if _graph else _converging_loop
    gamma = gamma_from_beta(beta)
    updaters = (
        updater_factory(beta, gamma, l1_reg, l2_reg) if updater_factory else None
    )
    if updaters is None:
        updaters = _default_updaters(recon2, beta, gamma, l1_reg, l2_reg)
    upd_W, upd_H, loss_terms, prepare, finish = _normalize_updaters(updaters)

    @torch.no_grad()
    def fit(V, W, H):
        def loss_of(state):
            w, h = state
            if loss_terms is not None:
                return torch.sqrt(2.0 * loss_terms(V, w, h))
            return torch.sqrt(2.0 * beta_div(recon2(h, w), V, beta))

        def one_iter(state):
            w, h = state
            if update_W:
                w = upd_W(V, w, h)
            if update_H:
                h = upd_H(V, w, h)
            return w, h

        state0 = (W, H) if prepare is None else prepare(V, W, H)
        with _progress(verbose, max_iter) as report:
            state, k, conv = loop(one_iter, loss_of, state0, tol, max_iter,
                                  report)
        W, H = state if finish is None else finish(V, *state)
        return W, H, (k * 10 if conv else max_iter)

    return fit


# --------------------------------------------------------------------------
# Batched dense fit: many factorizations at once, each with its own early
# stop (no reference counterpart)
# --------------------------------------------------------------------------
def _masked(conv, old, new):
    """``old`` where the problem has converged, else ``new``."""
    return torch.where(conv.reshape((-1,) + (1,) * (old.ndim - 1)), old, new)


def _batched_loop(one_iter, loss_of, state0, tol, max_iter):
    """:func:`_converging_loop` over a leading batch axis: ``loss_of(state)
    -> (B,)``.  The loop runs while any problem is unconverged; a converged
    problem's state is frozen, so each problem's trajectory and stop are
    those it would have alone.  One host read per chunk.  Returns
    ``(state, conv, k)``: ``conv (B,)`` whether each problem converged, and
    ``k (B,)`` the chunk it converged at."""
    loss_init = loss_of(state0)
    B = loss_init.shape[0]
    conv = torch.zeros(B, dtype=torch.bool, device=loss_init.device)
    k_conv = torch.zeros(B, dtype=torch.long, device=loss_init.device)
    n_chunks, rem = divmod(max_iter, 10)
    state, prev, k = state0, loss_init, 0
    while k < n_chunks and not bool(conv.all()):
        new = state
        for _ in range(10):
            new = one_iter(new)
        state = tuple(_masked(conv, o, n) for o, n in zip(state, new))
        loss = torch.where(conv, prev, loss_of(state))
        newly = ~conv & ((prev - loss) / loss_init < tol)
        k_conv = torch.where(newly, k + 1, k_conv)
        conv, prev, k = conv | newly, loss, k + 1
    if rem:
        new = state
        for _ in range(rem):
            new = one_iter(new)
        state = tuple(_masked(conv, o, n) for o, n in zip(state, new))
    return state, conv, k_conv


def _batched_pos(pos):
    """An analytic β=1 denominator over a leading batch axis.  Its result
    gets unit axes after the batch axis up to its operand's rank, so each
    problem broadcasts against its factor as alone (a model's two factors
    have one rank)."""
    from torch.func import vmap

    def batched(x):
        out = vmap(pos)(x)
        return out.reshape(out.shape[:1] + (1,) * (x.ndim - out.ndim)
                           + out.shape[1:])

    return batched


def get_batched_dense_fit(
    recon2: Callable,
    beta: float,
    tol: float,
    max_iter: int,
    update_W: bool,
    update_H: bool,
    l1_reg: float,
    l2_reg: float,
    updater_factory: Optional[Callable] = None,
):
    """Returns ``fit(V, W, H) -> (W, H, n_iter)`` over a leading batch axis:
    ``V (B, ...)``, ``W (B, ...)``, ``H (B, ...)``, ``n_iter (B,)`` (the
    JAX package's ``get_batched_dense_fit``).  ``recon2`` is the batched
    reconstruction ``(H (B, ...), W (B, ...)) -> (B, ...)`` (``recon.linear``
    is one batched GEMM; ``torch.func.vmap`` of another model's).  The
    problems share no parameters, so the gradients of the batch's summed
    cotangent products are each problem's own MU numerator and denominator.
    ``updater_factory`` (optional) supplies updaters that take batched
    operands (the Gram updaters at β = 2); it has no layout transform."""
    from torch.func import vmap

    gamma = gamma_from_beta(beta)
    updaters = (
        updater_factory(beta, gamma, l1_reg, l2_reg) if updater_factory else None
    )
    if updaters is None:
        updaters = _default_updaters(recon2, beta, gamma, l1_reg, l2_reg,
                                     _batched_pos(kl_pos_W),
                                     _batched_pos(kl_pos_H))
    upd_W, upd_H, loss_terms, prepare, _ = _normalize_updaters(updaters)
    if prepare is not None or loss_terms is not None:
        raise ValueError("the batched fit takes updaters without a layout "
                         "transform or a loss")
    div_b = vmap(lambda wh, v: beta_div(wh, v, beta))

    @torch.no_grad()
    def fit(V, W, H):
        def one_iter(state):
            w, h = state
            if update_W:
                w = upd_W(V, w, h)
            if update_H:
                h = upd_H(V, w, h)
            return w, h

        def loss_of(state):
            w, h = state
            return torch.sqrt(2.0 * div_b(recon2(h, w), V))

        (W, H), conv, k = _batched_loop(one_iter, loss_of, (W, H), tol,
                                        max_iter)
        return W, H, torch.where(conv, k * 10, max_iter)

    return fit


# --------------------------------------------------------------------------
# Sparse-target β-divergence MU fit (reference fit, sparse path;
# nmf.py:351-353, 371-374, 383-387, 396-398 + _sp_double_backward_update)
# --------------------------------------------------------------------------
def _sp_factor_update(pos_neg_p, p, gamma, l1_reg, l2_reg, pos_pre=None):
    """MU step from the scalar pair ``pos_neg_p(p) -> (pos, neg)`` of one
    factor: numerator and denominator are the two scalars' gradients
    (reference ``_sp_double_backward_update``, nmf.py:95-119)."""
    with torch.enable_grad():
        x = p.detach().requires_grad_(True)
        pos, neg = pos_neg_p(x)
        (g,) = torch.autograd.grad(neg, x, retain_graph=pos_pre is None)
        neg = torch.relu(g) + eps
        if pos_pre is None:
            (g,) = torch.autograd.grad(pos, x)
            pos = torch.relu(g) + eps
        else:
            pos = pos_pre
    return p * mu_multiplier(neg, pos, p, gamma, l1_reg, l2_reg)


def get_sparse_fit(
    pos_neg: Callable,
    beta: float,
    tol: float,
    max_iter: int,
    update_W: bool,
    update_H: bool,
    l1_reg: float,
    l2_reg: float,
    verbose: bool = False,
    tier: str = "gather",
    recon2: Optional[Callable] = None,
    updater_factory: Optional[Callable] = None,
):
    """Returns ``fit(V, W, H) -> (W, H, n_iter)`` for a sparse target:
    ``V`` a coalesced ``torch.sparse_coo_tensor`` (``tier="ell"``: its
    :class:`~.sparse.SparseELL` layout).  ``pos_neg(V, H, W, beta) -> (pos,
    neg)`` is the model's split scalar pair (for NMF,
    :func:`~.sparse.nmf_sp_pos_neg`).  Three tiers:

    * ``"densify"``: the target is densified once at fit entry and the
      updates run through the dense updaters of ``updater_factory`` (the
      model's resolver: B1 on a CUDA float32 target at β ≠ 2) or the
      generic engine over ``recon2``; zero entries contribute nothing to
      any β cotangent, so the updates are the sparse ones;
    * ``"ell"``: the dual-ELL layout; each numerator is a dense reduction
      over one side's padded non-zeros (:func:`~.sparse.ell_neg_grad`),
      each denominator a closed form.  Fixed-order sums: deterministic;
    * ``"gather"``: ``torch.autograd.grad`` of the scalar pair, whose
      gathers' gradients are scatter-adds into the factors (advanced
      indexing's backward); held to the other tiers by tolerance.

    The every-10-iterations loss is the exact split form ``V_norm + pos -
    neg`` over the non-zeros in every tier (reference nmf.py:358,398)."""
    if tier not in ("densify", "ell", "gather"):
        raise ValueError(f"unknown sparse tier {tier!r}")
    gamma = gamma_from_beta(beta)
    dense_updaters = None
    if tier == "densify":
        updaters = (updater_factory(beta, gamma, l1_reg, l2_reg)
                    if updater_factory else None)
        if updaters is None:
            updaters = _default_updaters(recon2, beta, gamma, l1_reg, l2_reg)
        upd_W_d, upd_H_d, _, prepare, _ = _normalize_updaters(updaters)
        if prepare is not None:
            raise ValueError("the sparse densify tier takes no layout-"
                             "transforming updater factory")
        dense_updaters = upd_W_d, upd_H_d

    def ell_update(p, neg_raw, pos_pre, pos_raw):
        neg = torch.relu(neg_raw) + eps
        pos = pos_pre if pos_pre is not None else torch.relu(pos_raw) + eps
        return p * mu_multiplier(neg, pos, p, gamma, l1_reg, l2_reg)

    def ell_neg(side_idx, side_val, rem, self_f, other_f):
        g = _sparse.ell_neg_grad(side_idx, side_val, self_f, other_f, beta)
        if rem[2].numel():  # the hybrid's over-cap spill
            g = g + _sparse.coo_rem_neg_grad(rem, self_f, other_f, beta)
        return g

    @torch.no_grad()
    def fit(V, W, H):
        coo = V.coo if tier == "ell" else V
        V_norm = _sparse.get_V_norm(coo, beta)
        Vd = _sparse.densify(coo) if tier == "densify" else None

        def loss_of(state):
            w, h = state
            if tier == "ell":
                pos = _sparse.nmf_ell_pos_scalar(w, h, beta)
                neg = _sparse.ell_neg_scalar(V.row_idx, V.row_val, h, w, beta)
                if V.row_rem[2].numel():
                    neg = neg + _sparse.coo_rem_neg_scalar(V.row_rem, h, w, beta)
            else:
                pos, neg = pos_neg(coo, h, w, beta)
            return torch.sqrt(2.0 * (V_norm + pos - neg))

        def one_iter(state):
            w, h = state
            if tier == "densify":
                upd_W, upd_H = dense_updaters
                if update_W:
                    w = upd_W(Vd, w, h)
                if update_H:
                    h = upd_H(Vd, w, h)
            elif tier == "ell":
                if update_W:
                    w = ell_update(
                        w, ell_neg(V.col_idx, V.col_val, V.col_rem, w, h),
                        kl_pos_W(h) if beta == 1 else None,
                        None if beta == 1
                        else _sparse.nmf_ell_pos_grad(w, h, beta, want_H=False))
                if update_H:
                    h = ell_update(
                        h, ell_neg(V.row_idx, V.row_val, V.row_rem, h, w),
                        kl_pos_H(w) if beta == 1 else None,
                        None if beta == 1
                        else _sparse.nmf_ell_pos_grad(w, h, beta, want_H=True))
            else:
                if update_W:
                    w = _sp_factor_update(
                        lambda x: pos_neg(coo, h, x, beta), w, gamma, l1_reg,
                        l2_reg, kl_pos_W(h) if beta == 1 else None)
                if update_H:
                    h = _sp_factor_update(
                        lambda x: pos_neg(coo, x, w, beta), h, gamma, l1_reg,
                        l2_reg, kl_pos_H(w) if beta == 1 else None)
            return w, h

        with _progress(verbose, max_iter) as report:
            (W, H), k, conv = _converging_loop(
                one_iter, loss_of, (W, H), tol, max_iter, report)
        return W, H, (k * 10 if conv else max_iter)

    return fit


# --------------------------------------------------------------------------
# Hoyer sparseness-constrained fit (reference sparse_fit; nmf.py:411-599)
# --------------------------------------------------------------------------
def _f32(x: float) -> float:
    """``x`` rounded to float32, the dtype the JAX package carries its step
    sizes in (float64 fits too)."""
    return float(np.float32(x))


def _backtrack_project(loss_baseline, loss_of_new, p, grad, stepsize,
                       L1_scale):
    """Backtracking line search with per-column Hoyer projection (reference
    nmf.py:515-535): try ``p - ss·grad`` projected column-wise onto
    ``(L1_scale·norm_j, norm_j²)``; halve the step until the new loss is no
    worse, at most 10 attempts; keep the last candidate even if it failed,
    halve the step once more when the 10th attempt failed, then grow it by
    1.2.  Each attempt reads one comparison on the host, counted in
    ``_backtrack_project.reads``.  Returns ``(p_new, step)``."""
    def attempt(ss):
        pnew = proj_columns(p - ss * grad, L1_scale)
        _backtrack_project.reads += 1
        return pnew, bool(loss_of_new(pnew) > loss_baseline)

    pnew, worse = attempt(stepsize)
    tries = 1
    while worse and tries < 10:
        stepsize *= 0.5
        pnew, worse = attempt(stepsize)
        tries += 1
    if worse:
        stepsize *= 0.5
    return pnew, _f32(stepsize * 1.2)


_backtrack_project.reads = 0


def _value_and_grad(f, x):
    """``(f(x), ∂f/∂x)`` of a scalar ``f``, on a fresh leaf."""
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        val = f(x)
        (g,) = torch.autograd.grad(val, x)
    return val.detach(), g


def get_hoyer_fit(
    recon2: Optional[Callable],
    pos_neg: Optional[Callable],
    beta: float,
    max_iter: int,
    update_W: bool,
    update_H: bool,
    sW: Optional[float],
    sH: Optional[float],
    W_col_dim: int,
    H_col_dim: int,
    verbose: bool = False,
):
    """Returns ``fit(V, W, H) -> (W, H, n_iter)``: Hoyer'04 sparseness-
    constrained fitting, exactly ``max_iter`` iterations (no tolerance
    stop).  Exactly one of ``recon2`` (dense target) and ``pos_neg`` (sparse
    COO target, the model's split scalar pair) is given.  ``W_col_dim`` and
    ``H_col_dim`` are the flattened sizes of one rank column, for the L1
    targets (reference nmf.py:460-461, 469-470).

    A constrained factor is first projected to unit L2 norm per column,
    then takes, each iteration, a gradient step of the loss with the
    backtracking projection (:func:`_backtrack_project`); an unconstrained
    one takes the generic MU step (``_default_updaters`` on a dense target,
    ``_sp_factor_update`` on a sparse one).  Whenever H is trainable the
    pair is renormed onto unit-norm H (reference nmf.py:585)."""
    gamma = gamma_from_beta(beta)
    sparse = pos_neg is not None
    L1a = hoyer_l1_target(W_col_dim, sW) if sW is not None else None
    L1s = hoyer_l1_target(H_col_dim, sH) if sH is not None else None
    if not sparse:
        upd_W, upd_H = _default_updaters(recon2, beta, gamma, 0.0, 0.0)

    @torch.no_grad()
    def fit(V, W, H):
        if sparse:
            V_norm = _sparse.get_V_norm(V, beta)

            def loss(w, h):
                pos, neg = pos_neg(V, h, w, beta)
                return V_norm + pos - neg

            def mu_W(w, h):
                return _sp_factor_update(
                    lambda x: pos_neg(V, h, x, beta), w, gamma, 0.0, 0.0,
                    kl_pos_W(h) if beta == 1 else None)

            def mu_H(w, h):
                return _sp_factor_update(
                    lambda x: pos_neg(V, x, w, beta), h, gamma, 0.0, 0.0,
                    kl_pos_H(w) if beta == 1 else None)
        else:
            def loss(w, h):
                return beta_div(recon2(h, w), V, beta)

            def mu_W(w, h):
                return upd_W(V, w, h)

            def mu_H(w, h):
                return upd_H(V, w, h)

        # the constrained factors start at unit L2 per column (nmf.py:459-475)
        if sW is not None and update_W:
            W = proj_columns_explicit(W, L1a, 1.0)
        if sH is not None and update_H:
            H = proj_columns_explicit(H, L1s, 1.0)

        def one_iter(w, h, ssW, ssH):
            if update_W:
                if sW is None:
                    w = mu_W(w, h)
                else:
                    base, grad = _value_and_grad(lambda x: loss(x, h), w)
                    w, ssW = _backtrack_project(
                        base, lambda x: loss(x, h), w, grad, ssW, L1a)
            if update_H:
                if sH is None:
                    h = mu_H(w, h)
                else:
                    base, grad = _value_and_grad(lambda x: loss(w, x), h)
                    h, ssH = _backtrack_project(
                        base, lambda x: loss(w, x), h, grad, ssH, L1s)
                w, h = renorm(w, h, "H")
            return w, h, ssW, ssH

        state = (W, H, 1.0, 1.0)
        with _progress(verbose, max_iter) as report:
            for i in range(1, max_iter + 1):
                state = one_iter(*state)
                if report is not None and i % 10 == 0:
                    report(i // 10, float(torch.sqrt(2.0 * loss(*state[:2]))))
        return state[0], state[1], max_iter

    return fit


def get_batched_hoyer_fit(
    recon2: Callable,
    beta: float,
    max_iter: int,
    update_W: bool,
    update_H: bool,
    sW: Optional[float],
    sH: Optional[float],
    W_col_dim: int,
    H_col_dim: int,
):
    """Batched Hoyer fit for dense targets: ``fit(V (B, ...), W (B, ...),
    H (B, ...)) -> (W, H, n_iter (B,))``.  Each problem's line searches are
    its own, so the single-problem fit runs once per problem: every
    trajectory is exactly what it would be alone."""
    inner = get_hoyer_fit(recon2, None, beta, max_iter, update_W, update_H,
                          sW, sH, W_col_dim, H_col_dim)

    def fit(V, W, H):
        outs = [inner(v, w, h) for v, w, h in zip(V, W, H)]
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs]),
                torch.full((V.shape[0],), max_iter, dtype=torch.long,
                           device=V.device))

    return fit


# --------------------------------------------------------------------------
# PLCA EM fit (reference plca.py:193-304)
# --------------------------------------------------------------------------
def _plca_marginal_sum(x):
    """Sum over all axes but the rank axis, kept for broadcasting — the
    probability normalizer (reference plca.py:23-31 ``get_norm``)."""
    if x.ndim > 1:
        axes = tuple(d for d in range(x.ndim) if d != 1)
        return torch.sum(x, dim=axes, keepdim=True)
    return torch.sum(x)


def _threshold_eps(x):
    """``F.threshold(x, eps, eps)``: values ``<= eps`` become ``eps``."""
    return torch.where(x > eps, x, torch.full_like(x, eps))


def alpha_is_active(alpha) -> bool:
    """Whether a Dirichlet prior hyperparameter differs from the neutral 1
    (array-valued alphas always count as active)."""
    return not (isinstance(alpha, (int, float)) and alpha == 1)


def _plca_e_step(recon3, Vn, w, h, z):
    """The E-step: one backward pass of the reconstruction with cotangent
    ``Vn / (WZH + eps)`` (reference plca.py:252-253), on fresh leaves so no
    graph outlives it.  Every factor gets its gradient, a frozen one too:
    Z's M-step reads them.  Returns ``(gH, gW, gZ)``."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(True) for x in (h, w, z)]
        WZH = recon3(*leaves)
        return torch.autograd.grad(WZH, leaves, Vn / (WZH.detach() + eps))


def _plca_em_iter(recon3, update_W, update_H, update_Z, W_alpha_active,
                  H_alpha_active, Z_alpha_active, Vn, state, W_alpha, H_alpha,
                  Z_alpha, cotangents=None):
    """One EM iteration: the E-step (:func:`_plca_e_step`, or
    ``cotangents(Vn, w, h, z) -> (gH, gW, gZ)`` of :mod:`.fast_plca`), then
    :func:`_plca_m_step`."""
    w, h, z = state
    if cotangents is not None:
        gH, gW, gZ = cotangents(Vn, w, h, z)
    else:
        gH, gW, gZ = _plca_e_step(recon3, Vn, w, h, z)
    return _plca_m_step(update_W, update_H, update_Z, W_alpha_active,
                        H_alpha_active, Z_alpha_active, w, h, z, gH, gW, gZ,
                        W_alpha, H_alpha, Z_alpha)


def _plca_m_step(update_W, update_H, update_Z, W_alpha_active, H_alpha_active,
                 Z_alpha_active, w, h, z, gH, gW, gZ, W_alpha, H_alpha,
                 Z_alpha, h_marginal=None, h_mask=None):
    """The M-step: closed-form renormalizations of the unnormalized
    posterior marginals with optional Dirichlet MAP (reference
    plca.py:255-289).  Returns ``(w, h, z)``.

    The sharded fits pass ``h_marginal`` (the H marginal summed over the
    ranks) and ``h_mask`` (zero at H's padded positions, which the prior's
    ``h + (alpha - 1)`` would otherwise fill)."""
    if h_marginal is None:
        h_marginal = _plca_marginal_sum
    Z_prior = None
    if update_Z:
        z = z * torch.relu(gZ)
        Z_prior = z
        if Z_alpha_active:
            z = _threshold_eps(z + (Z_alpha - 1.0))
        z = z / torch.sum(z)

    if update_W:
        w = w * torch.relu(gW)
        if Z_prior is None:
            W_divider = _plca_marginal_sum(w)
            Z_prior = W_divider.reshape(-1)
        else:
            W_divider = Z_prior.reshape((-1,) + (1,) * (w.ndim - 2))
        w = w / W_divider
        if W_alpha_active:
            w = _threshold_eps(w + (W_alpha - 1.0))
            w = w / _plca_marginal_sum(w)

    if update_H:
        h = h * torch.relu(gH)
        if Z_prior is None:
            H_divider = h_marginal(h)
        else:
            H_divider = Z_prior.reshape((-1,) + (1,) * (h.ndim - 2))
        h = h / H_divider
        if H_alpha_active:
            h = _threshold_eps(h + (H_alpha - 1.0))
            if h_mask is not None:
                h = h * h_mask
            h = h / h_marginal(h)

    return w, h, z


def get_plca_fit(
    recon3: Callable,
    tol: float,
    max_iter: int,
    update_W: bool,
    update_H: bool,
    update_Z: bool,
    W_alpha_active: bool,
    H_alpha_active: bool,
    Z_alpha_active: bool,
    verbose: bool = False,
    em_engine: Optional[Callable] = None,
    _graph: bool = True,
):
    """Returns ``fit(V, W, H, Z, W_alpha, H_alpha, Z_alpha) -> (W, H, Z,
    n_iter, norm)``: EM maximizing the posterior log-probability
    (reference plca.py:193-304).  ``V`` arrives unnormalized and is divided
    by ``norm = V.sum()`` inside.  ``em_engine()`` (optional) supplies the
    E-step cotangents.  ``n_iter`` is the reference's raw loop index:
    ``10·k - 1`` when chunk ``k`` converged, else ``max_iter - 1``.  The
    chunks run as :func:`get_dense_fit`'s do (``_graph`` likewise)."""
    cotangents = em_engine() if em_engine is not None else None
    loop = _graphed_loop if _graph else _converging_loop

    @torch.no_grad()
    def fit(V, W, H, Z, W_alpha, H_alpha, Z_alpha):
        norm = V.sum()
        Vn = V / norm

        def log_probability(state):
            # shown beside the loss when verbose (reference plca.py:18-20)
            w, h, z = state
            WZH = recon3(h, w, z)
            lp = matmul(Vn.reshape(-1), torch.log(WZH + eps).reshape(-1))
            lp = lp + torch.sum(torch.log(w + eps) * (W_alpha - 1.0))
            lp = lp + torch.sum(torch.log(h + eps) * (H_alpha - 1.0))
            return lp + torch.sum(torch.log(z + eps) * (Z_alpha - 1.0))

        def loss_of(state):
            w, h, z = state
            return torch.sqrt(2.0 * kl_div(recon3(h, w, z) * norm, Vn * norm))

        def one_iter(state):
            return _plca_em_iter(
                recon3, update_W, update_H, update_Z, W_alpha_active,
                H_alpha_active, Z_alpha_active, Vn, state, W_alpha, H_alpha,
                Z_alpha, cotangents)

        with _progress(verbose, max_iter) as report:
            (W, H, Z), k, conv = loop(
                one_iter, loss_of, (W, H, Z), tol, max_iter, report,
                extra_of=log_probability)
        return W, H, Z, (k * 10 - 1 if conv else max_iter - 1), norm

    return fit


def get_batched_plca_fit(
    recon3: Callable,
    tol: float,
    max_iter: int,
    update_W: bool,
    update_H: bool,
    update_Z: bool,
    W_alpha_active: bool,
    H_alpha_active: bool,
    Z_alpha_active: bool,
):
    """Batched EM: ``fit(V (B, ...), W (B, ...), H (B, ...), Z (B, R),
    W_alpha, H_alpha, Z_alpha) -> (W, H, Z, n_iter (B,), norm (B,))``, each
    problem with its own early stop and the raw-index ``n_iter``.  ``recon3``
    is one problem's reconstruction; the E-step differentiates
    ``torch.func.vmap(recon3)`` over the whole batch (the problems share no
    parameters), the M-step is ``vmap``-ed, the priors are shared."""
    from torch.func import vmap

    recon3_b = vmap(recon3)
    m_step = vmap(
        lambda w, h, z, gH, gW, gZ, Wa, Ha, Za: _plca_m_step(
            update_W, update_H, update_Z, W_alpha_active, H_alpha_active,
            Z_alpha_active, w, h, z, gH, gW, gZ, Wa, Ha, Za),
        in_dims=(0,) * 6 + (None,) * 3)
    loss_b = vmap(lambda vn, w, h, z, nrm: torch.sqrt(
        2.0 * kl_div(recon3(h, w, z) * nrm, vn * nrm)))

    @torch.no_grad()
    def fit(V, W, H, Z, W_alpha, H_alpha, Z_alpha):
        norm = V.reshape(V.shape[0], -1).sum(1)
        Vn = V / norm.reshape((-1,) + (1,) * (V.ndim - 1))

        def one_iter(state):
            w, h, z = state
            gH, gW, gZ = _plca_e_step(recon3_b, Vn, w, h, z)
            return m_step(w, h, z, gH, gW, gZ, W_alpha, H_alpha, Z_alpha)

        (W, H, Z), conv, k = _batched_loop(
            one_iter, lambda s: loss_b(Vn, *s, norm), (W, H, Z), tol, max_iter)
        return W, H, Z, torch.where(conv, k * 10 - 1, max_iter - 1), norm

    return fit

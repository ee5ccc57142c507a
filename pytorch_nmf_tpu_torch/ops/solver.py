r"""Training loops (counterpart of :mod:`pytorch_nmf_tpu.ops.solver`;
dense fit only so far).

The semantics are those of the reference ``BaseComponent.fit``
(``torchnmf/nmf.py:355-409``) as the JAX package compiles them:

* the loss is checked every 10 iterations, with the stop rule
  ``(prev - loss) / loss_init < tol``;
* ``n_iter = 10·k`` when the check of chunk ``k`` converged, else
  ``max_iter``; the ``max_iter % 10`` remainder iterations are skipped once
  converged;
* W updates against the old H, then H against the new W.

PyTorch runs eagerly, so the loop is a Python loop; the host reads the
device only at the 10-iteration cadence, for the stop rule.
"""

import contextlib
from typing import Callable, Optional

import torch

from ..metrics import beta_div
from .mu import gamma_from_beta, kl_pos_H, kl_pos_W, mu_update

__all__ = ["get_dense_fit"]


def _default_updaters(recon2, beta, gamma, l1_reg, l2_reg):
    """Per-factor updaters on the generic autograd MU engine."""
    def upd_W(V, W, H):
        pos_pre = kl_pos_W(H) if beta == 1 else None
        return mu_update(
            lambda w: recon2(H, w), V, W, beta, gamma, l1_reg, l2_reg, pos_pre
        )

    def upd_H(V, W, H):
        pos_pre = kl_pos_H(W) if beta == 1 else None
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


@contextlib.contextmanager
def _progress(verbose: bool, max_iter: int):
    """Yields ``report(chunk_idx, loss)`` (or ``None``): a tqdm bar when
    tqdm is installed, else one printed line per 10-iteration chunk."""
    if not verbose:
        yield None
        return
    try:
        from tqdm import tqdm
    except ImportError:
        yield lambda k, loss: print(f"iter {k * 10}: loss={loss:.6g}")
        return
    with tqdm(total=max_iter) as bar:
        def report(k, loss):
            bar.set_postfix(loss=loss)
            bar.n = min(k * 10, max_iter)
            bar.refresh()

        yield report


def _converging_loop(
    one_iter: Callable,
    loss_of: Callable,
    state0,
    tol: float,
    max_iter: int,
    report: Optional[Callable] = None,
):
    """The chunked convergence loop: ``one_iter(state) -> state``,
    ``loss_of(state) -> 0-d tensor`` (on the reference's
    ``sqrt(2·divergence)`` scale).  Returns ``(state, n_chunks, converged)``."""
    loss_init = loss_of(state0)
    n_chunks, rem = divmod(max_iter, 10)
    state, prev, k, conv = state0, loss_init, 0, False
    while not conv and k < n_chunks:
        for _ in range(10):
            state = one_iter(state)
        loss = loss_of(state)
        # the one host sync per chunk; NaN compares False, as on the device
        conv = bool((prev - loss) / loss_init < tol)
        prev, k = loss, k + 1
        if report is not None:
            report(k, float(loss))
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
):
    """Returns ``fit(V, W, H) -> (W, H, n_iter)`` for the dense β-divergence
    MU fit.  ``updater_factory(beta, gamma, l1_reg, l2_reg)`` supplies the
    updaters (``None``, or a factory returning ``None``, selects the
    generic engine over ``recon2``)."""
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
            state, k, conv = _converging_loop(
                one_iter, loss_of, state0, tol, max_iter, report
            )
        W, H = state if finish is None else finish(V, *state)
        return W, H, (k * 10 if conv else max_iter)

    return fit

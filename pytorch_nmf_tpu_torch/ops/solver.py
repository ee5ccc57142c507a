r"""Training loops (counterpart of :mod:`pytorch_nmf_tpu.ops.solver`): the
dense and sparse-target β-divergence MU fits and the PLCA EM fit.

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

from ..constants import eps
from ..metrics import beta_div, kl_div
from . import sparse as _sparse
from .mu import gamma_from_beta, kl_pos_H, kl_pos_W, mu_multiplier, mu_update

__all__ = ["get_dense_fit", "get_sparse_fit", "get_plca_fit", "alpha_is_active"]


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
    """Yields ``report(chunk_idx, loss, extra=None)`` (or ``None``): a tqdm
    bar when tqdm is installed, else one printed line per 10-iteration
    chunk.  ``extra`` is PLCA's log-probability."""
    if not verbose:
        yield None
        return
    try:
        from tqdm import tqdm
    except ImportError:
        def report(k, loss, extra=None):
            tail = "" if extra is None else f", log_prob={extra:.6g}"
            print(f"iter {k * 10}: loss={loss:.6g}{tail}")

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

        yield report


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
        conv = bool((prev - loss) / loss_init < tol)
        prev, k = loss, k + 1
        if report is not None:
            report(k, float(loss),
                   None if extra_of is None else float(extra_of(state)))
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


def _plca_em_iter(recon3, update_W, update_H, update_Z, W_alpha_active,
                  H_alpha_active, Z_alpha_active, Vn, state, W_alpha, H_alpha,
                  Z_alpha, cotangents=None):
    """One EM iteration: the E-step, one backward pass of the
    reconstruction with cotangent ``Vn / (WZH + eps)`` (reference
    plca.py:252-253), on fresh leaves so no graph outlives it; then the
    M-step's closed-form renormalizations with optional Dirichlet MAP
    (plca.py:255-289).  ``cotangents(Vn, w, h, z) -> (gH, gW, gZ)``
    replaces the E-step (:mod:`.fast_plca`).  Every factor gets its
    gradient, a frozen one too: Z's M-step reads them."""
    w, h, z = state
    if cotangents is not None:
        gH, gW, gZ = cotangents(Vn, w, h, z)
    else:
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_(True) for x in (h, w, z)]
            WZH = recon3(*leaves)
            gH, gW, gZ = torch.autograd.grad(
                WZH, leaves, Vn / (WZH.detach() + eps))

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
            H_divider = _plca_marginal_sum(h)
        else:
            H_divider = Z_prior.reshape((-1,) + (1,) * (h.ndim - 2))
        h = h / H_divider
        if H_alpha_active:
            h = _threshold_eps(h + (H_alpha - 1.0))
            h = h / _plca_marginal_sum(h)

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
):
    """Returns ``fit(V, W, H, Z, W_alpha, H_alpha, Z_alpha) -> (W, H, Z,
    n_iter, norm)``: EM maximizing the posterior log-probability
    (reference plca.py:193-304).  ``V`` arrives unnormalized and is divided
    by ``norm = V.sum()`` inside.  ``em_engine()`` (optional) supplies the
    E-step cotangents.  ``n_iter`` is the reference's raw loop index:
    ``10·k - 1`` when chunk ``k`` converged, else ``max_iter - 1``."""
    cotangents = em_engine() if em_engine is not None else None

    @torch.no_grad()
    def fit(V, W, H, Z, W_alpha, H_alpha, Z_alpha):
        norm = V.sum()
        Vn = V / norm

        def log_probability(state):
            # shown beside the loss when verbose (reference plca.py:18-20)
            w, h, z = state
            WZH = recon3(h, w, z)
            lp = Vn.reshape(-1) @ torch.log(WZH + eps).reshape(-1)
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
            (W, H, Z), k, conv = _converging_loop(
                one_iter, loss_of, (W, H, Z), tol, max_iter, report,
                extra_of=log_probability)
        return W, H, Z, (k * 10 - 1 if conv else max_iter - 1), norm

    return fit

"""Functional API (counterpart of :mod:`pytorch_nmf_tpu.functional`):
explicit tensors in, new tensors out; the models' state is not involved.

* :func:`nmf_fit` / :func:`nmfd_fit` / :func:`nmf2d_fit` / :func:`nmf3d_fit`
  — the β-divergence MU fits, through the models' own fit on explicit
  factors (the same engine choice, so the same kernels run);
* :func:`nmf_hoyer_fit` — the Hoyer sparseness-constrained fit;
* :func:`plca_fit` — EM for the PLCA family;
* :func:`nmf_fit_batched`, :func:`plca_fit_batched`,
  :func:`nmf_hoyer_fit_batched` — many problems with a leading batch axis,
  each with its own stop;
* :func:`streaming_nmf_fit` — ``NMF`` on a host-resident target read in
  row blocks (:mod:`.ops.streaming`);
* :func:`mu_update`, :func:`betamu_step`, :func:`sparsity_proj_step`,
  :func:`proj_func`, :func:`gamma_from_beta`, :func:`renorm`.

The factors are copied to the first factor's device (the card for a numpy
array), float64 kept and every other dtype made float32; ``V`` follows them
(:func:`~.models._common.target_like`).  A DTensor ``V`` takes the models'
route (the sharded and halo fits, or the declined path: their module
docstrings) in :func:`nmf_fit`, :func:`nmfd_fit`, :func:`nmf2d_fit`,
:func:`nmf3d_fit`, :func:`nmf_hoyer_fit` and :func:`plca_fit`, and their
factors come back as DTensors.
"""

import functools

import torch
from torch.func import vmap

from .models import nmf as _nmf_models
from .models import plca as _plca_models
from .models._common import (is_dtensor, target_like, to_param,
                             validate_target)
from .ops.fast_nmf import nmf_updater_factory_generic
from .ops.mu import gamma_from_beta, mu_update, renorm  # noqa: F401
from .ops.projection import proj_func  # noqa: F401
from .ops.solver import (
    alpha_is_active,
    get_batched_dense_fit,
    get_batched_hoyer_fit,
    get_batched_plca_fit,
)
from .ops.streaming import streaming_nmf_fit  # noqa: F401
from .ops.trainer_core import betamu_step, sparsity_proj_step  # noqa: F401

__all__ = [
    "nmf_fit",
    "nmf_fit_batched",
    "nmfd_fit",
    "nmf2d_fit",
    "nmf3d_fit",
    "nmf_hoyer_fit",
    "nmf_hoyer_fit_batched",
    "plca_fit",
    "plca_fit_batched",
    "streaming_nmf_fit",
    "mu_update",
    "betamu_step",
    "sparsity_proj_step",
    "proj_func",
    "gamma_from_beta",
    "renorm",
]


@functools.lru_cache(maxsize=None)
def _batched_recon(reconstruct):
    """``vmap(reconstruct)``, one object a model: the batched fits' factories
    are cached on their arguments."""
    return vmap(reconstruct)


def _factors(*xs):
    """Copies of the factors on the first one's device (the card when it is
    not a tensor): float64 stays float64, every other dtype becomes
    float32.  A DTensor factor stays as it is (the fits read it, and
    return new ones)."""
    device = xs[0].device if isinstance(xs[0], torch.Tensor) else None
    return tuple(x if is_dtensor(x) else to_param(x, device) for x in xs)


def _fit(model_cls, V, W, H, beta, tol, max_iter, update_W, update_H,
         l1_reg, l2_reg):
    W, H = _factors(W, H)
    return model_cls._fit_mu(V, W, H, bool(update_W), bool(update_H),
                             float(beta), float(tol), int(max_iter), False,
                             float(l1_reg), float(l2_reg))


def nmf_fit(V, W, H, beta=1, tol=1e-4, max_iter=200, update_W=True,
            update_H=True, l1_reg=0.0, l2_reg=0.0):
    """Fit ``V ≈ H Wᵀ``; returns ``(W, H, n_iter)``.  ``V`` may be dense or
    a sparse COO tensor."""
    return _fit(_nmf_models.NMF, V, W, H, beta, tol, max_iter, update_W,
                update_H, l1_reg, l2_reg)


def nmfd_fit(V, W, H, beta=1, tol=1e-4, max_iter=200, update_W=True,
             update_H=True, l1_reg=0.0, l2_reg=0.0):
    """Fit the 1-D deconvolutional model; returns ``(W, H, n_iter)``."""
    return _fit(_nmf_models.NMFD, V, W, H, beta, tol, max_iter, update_W,
                update_H, l1_reg, l2_reg)


def nmf2d_fit(V, W, H, beta=1, tol=1e-4, max_iter=200, update_W=True,
              update_H=True, l1_reg=0.0, l2_reg=0.0):
    """Fit the 2-D deconvolutional model; returns ``(W, H, n_iter)``."""
    return _fit(_nmf_models.NMF2D, V, W, H, beta, tol, max_iter, update_W,
                update_H, l1_reg, l2_reg)


def nmf3d_fit(V, W, H, beta=1, tol=1e-4, max_iter=200, update_W=True,
              update_H=True, l1_reg=0.0, l2_reg=0.0):
    """Fit the 3-D deconvolutional model; returns ``(W, H, n_iter)``."""
    return _fit(_nmf_models.NMF3D, V, W, H, beta, tol, max_iter, update_W,
                update_H, l1_reg, l2_reg)


def nmf_hoyer_fit(V, W, H, beta=2, max_iter=200, sW=None, sH=None,
                  update_W=True, update_H=True, model_cls=None):
    """Hoyer'04 sparseness-constrained fit; returns ``(W, H, n_iter)``.
    ``model_cls`` defaults to ``NMF``; a sparse COO target is taken by
    ``NMF`` only."""
    model_cls = model_cls or _nmf_models.NMF
    W, H = _factors(W, H)
    return model_cls._fit_hoyer(V, W, H, bool(update_W), bool(update_H),
                                float(beta), int(max_iter), False, sW, sH)


def plca_fit(V, W, H, Z, model_cls=None, tol=1e-4, max_iter=200,
             update_W=True, update_H=True, update_Z=True,
             W_alpha=1.0, H_alpha=1.0, Z_alpha=1.0):
    """EM-fit a PLCA-family model (``model_cls``, default ``PLCA``); returns
    ``(W, H, Z, n_iter, norm)``."""
    model_cls = model_cls or _plca_models.PLCA
    W, H, Z = _factors(W, H, Z)
    return model_cls._fit_em(V, W, H, Z, bool(update_W), bool(update_H),
                             bool(update_Z), float(tol), int(max_iter), False,
                             W_alpha, H_alpha, Z_alpha)


def nmf_fit_batched(V, W, H, beta=1, tol=1e-4, max_iter=200, update_W=True,
                    update_H=True, l1_reg=0.0, l2_reg=0.0, model_cls=None):
    """Fit many factorizations at once: ``V``, ``W`` and ``H`` carry a
    leading batch axis, and each problem stops on its own tolerance (its
    factors freeze).  Returns ``(W, H, n_iter)``, ``n_iter (B,)``.
    ``model_cls`` (default ``NMF``) gives the reconstruction; ``NMF`` at
    β=2 takes the Gram updates, every other case the generic engine, both
    as batched products (no hand-written kernel)."""
    model_cls = model_cls or _nmf_models.NMF
    W, H = _factors(W, H)
    V = target_like(V, W, H)
    validate_target(V, beta)
    nmf = model_cls is _nmf_models.NMF
    fit = get_batched_dense_fit(
        model_cls.reconstruct if nmf else _batched_recon(model_cls.reconstruct),
        float(beta), float(tol), int(max_iter), bool(update_W),
        bool(update_H), float(l1_reg), float(l2_reg),
        nmf_updater_factory_generic if nmf else None)
    return fit(V, W, H)


def plca_fit_batched(V, W, H, Z, model_cls=None, tol=1e-4, max_iter=200,
                     update_W=True, update_H=True, update_Z=True,
                     W_alpha=1.0, H_alpha=1.0, Z_alpha=1.0):
    """EM-fit many PLCA-family problems at once (leading batch axis on
    ``V``, ``W``, ``H``, ``Z``), each with its own stop.  Returns ``(W, H,
    Z, n_iter, norm)`` with ``n_iter (B,)`` and ``norm (B,)``."""
    model_cls = model_cls or _plca_models.PLCA
    W, H, Z = _factors(W, H, Z)
    V = target_like(V, W, H, Z)
    validate_target(V, 1)
    fit = get_batched_plca_fit(
        model_cls.reconstruct, float(tol), int(max_iter), bool(update_W),
        bool(update_H), bool(update_Z), alpha_is_active(W_alpha),
        alpha_is_active(H_alpha), alpha_is_active(Z_alpha))

    def alpha(a):  # the factors' dtype: float32 for a bfloat16 V
        return torch.as_tensor(a, dtype=W.dtype, device=V.device)

    return fit(V, W, H, Z, alpha(W_alpha), alpha(H_alpha),
               alpha(Z_alpha))


def nmf_hoyer_fit_batched(V, W, H, beta=2, max_iter=200, sW=None, sH=None,
                          update_W=True, update_H=True, model_cls=None):
    """Hoyer-fit many problems (dense targets, leading batch axis); returns
    ``(W, H, n_iter)``, ``n_iter (B,)``.  One batched program, as the JAX
    package's ``vmap`` of the single fit: each problem's line search is its
    own, so its trajectory is the one :func:`nmf_hoyer_fit` gives it alone
    (up to the batched sums' rounding).  ``model_cls`` (default ``NMF``)
    gives the reconstruction, a batched GEMM for ``NMF`` and
    ``torch.func.vmap`` of the model's otherwise; every projection of the
    batch is one launch of the projection kernel."""
    model_cls = model_cls or _nmf_models.NMF
    W, H = _factors(W, H)
    V = target_like(V, W, H)
    if V.layout != torch.strided:
        raise NotImplementedError("batched Hoyer fits take dense targets only")
    validate_target(V, beta)
    nmf = model_cls is _nmf_models.NMF
    fit = get_batched_hoyer_fit(
        model_cls.reconstruct if nmf else _batched_recon(model_cls.reconstruct),
        float(beta), int(max_iter), bool(update_W),
        bool(update_H),
        None if sW is None or not update_W else float(sW),
        None if sH is None or not update_H else float(sH),
        W[0].numel() // W.shape[2], H[0].numel() // H.shape[2])
    return fit(V, W, H)

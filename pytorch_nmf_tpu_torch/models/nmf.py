r"""NMF models: ``BaseComponent``, ``NMF``, ``NMFD``, ``NMF2D`` and ``NMF3D``
(counterpart of :mod:`pytorch_nmf_tpu.models.nmf`).

The classes are ``torch.nn.Module``\ s holding ``nn.Parameter``\ s ``W`` and
``H``, with the reference's constructor shape inference and validation
(``torchnmf/nmf.py:173-260``); ``requires_grad`` records the
``trainable_W``/``trainable_H`` flags.  The factors live on the card unless
the constructor is given ``device="cpu"``; ``fit`` moves ``V`` there and runs
the MU solvers of :mod:`pytorch_nmf_tpu_torch.ops.solver`, ``sparse_fit`` the
Hoyer solver.  Both run on explicit factors in classmethods, which the
functional API (:mod:`pytorch_nmf_tpu_torch.functional`) calls too.

A :class:`~torch.distributed.tensor.DTensor` target is routed as the JAX
package's ``fit`` routes a sharded array (its ``models/nmf.py:290-306``):
``NMF`` with its rows sharded over one named mesh dimension (and its
columns over another, or not at all) to
:func:`~..parallel.sharded.sharded_nmf_fit`, ``NMFD``/``NMF2D``/``NMF3D``
sharded on the trailing axis alone to the halo fits
(:func:`~..parallel.halo._sharded_deconv_fit`); the layout rules are
:func:`~._common.row_axes` and :func:`~._common.trailing_seq_axis`.  Every
other DTensor target, and ``sparse_fit`` on one, takes the declined path
(:func:`~._common.fit_declined`): each rank gathers ``V`` whole and runs
the single-card fit, where GSPMD would spread it.  The fitted factors are
then DTensors, held by new ``nn.Parameter``\ s.

===========  =======================  ==========================
model        V                        W / H
===========  =======================  ==========================
``NMF``      ``(M, K)``               ``W (K, R)``, ``H (M, R)``
``NMFD``     ``(N, C, L)``            ``W (C, R, T)``, ``H (N, R, L-T+1)``
``NMF2D``    ``(N, C, L, M)``         ``W (C, R, kh, kw)``, ``H`` full-pad
``NMF3D``    ``(N, C, L, M, O)``      analogous with 3 spatial dims
===========  =======================  ==========================
"""

from collections.abc import Iterable as Iterabc
from typing import Iterable, Optional, Tuple, Union

import torch
from torch import nn

from ..ops import autotune as _autotune
from ..ops import recon as _recon
from ..ops import solver as _solver
from ..ops import sparse as _sparse
from ..ops.fast_nmf import resolve_nmf_updater_factory
from ._common import (
    _BETA_ZERO_MSG,
    assert_nonneg,
    fit_declined,
    gather_whole,
    is_dtensor,
    is_tensor_like,
    load_placed,
    pair,
    rand_abs_normal,
    resolve_device,
    row_axes,
    set_factors,
    single,
    target_like,
    to_param,
    trailing_seq_axis,
    triple,
    validate_sharded,
    validate_target,
)

__all__ = ["BaseComponent", "NMF", "NMFD", "NMF2D", "NMF3D"]


class BaseComponent(nn.Module):
    r"""Base class for the NMF modules (reference nmf.py:173-599).

    Args:
        rank: size of the hidden dimension.
        W: shape tuple (random |N(0,1)| init) or initial non-negative values.
        H: shape tuple or initial non-negative values.
        trainable_W / trainable_H: freeze flags for given initial values.
        device: where random inits are drawn and given values are placed;
            the card (``"cuda"``) when ``None``, which raises without one.
            Pass ``device="cpu"`` to run on the CPU.
        generator: the ``torch.Generator`` random inits are drawn from, on
            the model's device (another device raises ``ValueError``).
    """

    def __init__(
        self,
        rank: int = None,
        W=None,
        H=None,
        trainable_W: bool = True,
        trainable_H: bool = True,
        *,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        device = resolve_device(device, generator)

        def make(x, name, trainable):
            if is_tensor_like(x):
                value = to_param(x, device)
                assert_nonneg(value, name)
                return nn.Parameter(value, requires_grad=trainable)
            if isinstance(x, Iterabc):
                return nn.Parameter(rand_abs_normal(x, generator, device))
            return None

        self.register_parameter("W", make(W, "W", trainable_W))
        self.register_parameter("H", make(H, "H", trainable_H))

        infer_rank = None
        for p in (self.W, self.H):
            if p is not None:
                infer_rank = p.shape[1]
        if infer_rank is None:
            if not rank:
                raise ValueError(
                    "A rank should be given when W and H are not available!"
                )
        else:
            if self.H is not None and self.H.shape[1] != infer_rank:
                raise ValueError("Latent size of H does not match with others!")
            if self.W is not None:
                if self.W.shape[1] != infer_rank:
                    raise ValueError("Latent size of W does not match with others!")
                self.out_channels = self.W.shape[0]
                if self.W.ndim > 2:
                    self.kernel_size = tuple(self.W.shape[2:])
            rank = infer_rank
        self.rank = int(rank)

    def extra_repr(self) -> str:
        s = f"{self.rank}"
        if self.W is not None:
            s += f", out_channels={self.out_channels}"
            if hasattr(self, "kernel_size"):
                s += f", kernel_size={self.kernel_size}"
        return s

    def forward(self, H=None, W=None):
        """Reconstruct with the given (or stored) factors
        (reference nmf.py:261-284).  DTensor factors (a fit on a DTensor
        target leaves them) are gathered whole first
        (:func:`~._common.gather_whole`: every rank of their mesh calls
        it), and the reconstruction is a whole, plain tensor on every rank;
        a factor's gradient through the gather is its own block of the
        whole one, a DTensor placed as the factor."""
        H = self.H if H is None else H
        W = self.W if W is None else W
        if H is None or W is None:
            raise ValueError("both factors are needed to reconstruct")
        return self.reconstruct(gather_whole(H), gather_whole(W))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        """``load_state_dict``: a whole value for a DTensor factor (a fit on
        a DTensor target left it) goes in as the factor's block
        (:func:`~._common.load_placed`); every rank of its mesh loads."""
        load_placed(self, state_dict, prefix)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    @staticmethod
    def reconstruct(H, W):
        """The model's forward map; overridden by subclasses."""
        raise NotImplementedError

    # staticmethod (V, H, W, beta) -> (pos, neg) for a sparse target: the
    # split β-divergence's scalar pair; only NMF has one (reference
    # nmf.py:617-638)
    _sp_pos_neg = None

    def fit(
        self,
        V,
        beta: float = 1,
        tol: float = 1e-4,
        max_iter: int = 200,
        verbose: bool = False,
        alpha: float = 0,
        l1_ratio: float = 0,
    ) -> int:
        r"""Learn the factorization by minimizing the β-divergence with
        multiplicative updates (reference nmf.py:297-409) on the factors'
        device, in their dtype.  ``V`` (a tensor anywhere, or a numpy array)
        is moved there (:func:`~._common.target_like`: a float64 ``V`` of a
        float32 model is cast, with a ``UserWarning``; a bfloat16 ``V`` stays
        bfloat16, half the memory, with float32 factors and arithmetic);
        ``NMF`` also takes a sparse COO tensor.  Returns the number of
        iterations run.

        A :class:`~torch.distributed.tensor.DTensor` ``V`` (every rank of its
        mesh calls ``fit``) runs the sharded or halo fit where its layout
        routes (the module docstring), else the declined path; afterwards
        ``W`` and ``H`` are new ``nn.Parameter``\ s holding the fitted
        DTensors (``requires_grad`` kept), which a later ``fit`` continues
        from.  A plain ``V`` given to DTensor factors gathers them and
        leaves plain parameters."""
        W, H = self.W, self.H
        W_new, H_new, n_iter = self._fit_mu(
            V, W.detach(), H.detach(), W.requires_grad, H.requires_grad,
            float(beta), float(tol), int(max_iter), bool(verbose),
            float(alpha * l1_ratio), float(alpha * (1 - l1_ratio)))
        set_factors(self, W=W_new, H=H_new)
        return int(n_iter)

    @classmethod
    def _fit_mu(cls, V, W, H, update_W, update_H, beta, tol, max_iter,
                verbose, l1_reg, l2_reg):
        """The MU fit of :meth:`fit` on explicit factors (shared with
        :func:`~pytorch_nmf_tpu_torch.functional.nmf_fit`):
        ``(W, H, n_iter)``; DTensors in and out where ``V`` or a factor is
        one (:meth:`_fit_mu_sharded`)."""
        if any(is_dtensor(x) for x in (V, W, H)):
            return cls._fit_mu_sharded(V, W, H, update_W, update_H, beta, tol,
                                       max_iter, verbose, l1_reg, l2_reg)
        V = target_like(V, W, H)
        if V.layout != torch.strided:
            return cls._fit_sparse(V, W, H, update_W, update_H, beta, tol,
                                   max_iter, verbose, l1_reg, l2_reg)
        validate_target(V, beta)
        fit_fn = _solver.get_dense_fit(
            cls.reconstruct, beta, tol, max_iter, update_W, update_H, l1_reg,
            l2_reg, verbose, cls._resolve_updater_factory(V, W, H, beta),
        )
        return fit_fn(V, W, H)

    @classmethod
    def _fit_mu_sharded(cls, V, W, H, update_W, update_H, beta, tol,
                        max_iter, verbose, l1_reg, l2_reg):
        """:meth:`_fit_mu` on a DTensor target (or DTensor factors): the
        model's route (:meth:`_route`) where ``V``'s layout has one and the
        factors are float32, after the ranks' joint check of ``V``
        (:func:`~._common.validate_sharded`); else the declined path
        (:func:`~._common.fit_declined`)."""
        route = None
        if is_dtensor(V) and all(x.dtype == torch.float32 for x in (W, H)):
            route = cls._route(V)
        if route is None:
            return fit_declined(
                lambda V, W, H, verbose: cls._fit_mu(
                    V, W, H, update_W, update_H, beta, tol, max_iter, verbose,
                    l1_reg, l2_reg), V, (W, H), verbose)
        validate_sharded(V, beta)
        return route(V, W, H, update_W=update_W, update_H=update_H, beta=beta,
                     tol=tol, max_iter=max_iter, verbose=verbose,
                     l1_reg=l1_reg, l2_reg=l2_reg)

    @classmethod
    def _route(cls, V):
        """The explicit fit that a DTensor ``V`` of this model routes to, as
        ``fit(V, W, H, **keywords)``, or ``None`` (declined): none here;
        :class:`NMF` and the deconvolutional models have theirs."""
        return None

    @classmethod
    def _resolve_updater_factory(cls, V, W, H, beta):
        """The updater factory of this fit (``None``: the generic engine);
        :class:`NMF` takes its kernels' factory, the deconvolutional models
        resolve theirs per fit (:func:`~..ops.autotune.resolve_deconv_factory`)."""
        return None

    @classmethod
    def _fit_sparse(cls, V, W, H, update_W, update_H, beta, tol, max_iter,
                    verbose, l1_reg, l2_reg):
        """The sparse branch of :meth:`_fit_mu` (reference nmf.py:351-398),
        ``(W, H, n_iter)``: ``V`` a sparse COO tensor, coalesced here.  The
        tier is chosen once: densify when the dense target fits its byte
        budget (:func:`~..ops.sparse.should_densify`), else ELL when its
        layout builds, else gather.  A densify fit that runs out of card
        memory (``torch.cuda.OutOfMemoryError``) is run once more on the ELL
        or gather tier; any other error propagates."""
        if V.layout != torch.sparse_coo:
            raise ValueError(f"a sparse target must be a sparse COO tensor, "
                             f"not {V.layout}")
        if beta <= 0:
            raise ValueError(_BETA_ZERO_MSG)
        if cls._sp_pos_neg is None:
            raise NotImplementedError(
                f"{cls.__name__} does not support sparse targets.")
        V = V.coalesce()
        if V.ndim != 2:
            raise ValueError(f"a sparse target is 2-D, got {tuple(V.shape)}")
        if V.values().numel() and float(V.values().min()) < 0:
            raise ValueError("Target should be non-negative.")

        def run(tier, V_arg):
            fit_fn = _solver.get_sparse_fit(
                cls._sp_pos_neg, beta, tol, max_iter, update_W, update_H,
                l1_reg, l2_reg, verbose, tier, cls.reconstruct,
                (cls._resolve_updater_factory(V, W, H, beta)
                 if tier == "densify" else None))
            return fit_fn(V_arg, W, H)

        out = None
        if _sparse.should_densify(V):
            try:
                out = run("densify", V)
            except torch.cuda.OutOfMemoryError:
                out = None  # once to the tiers that never densify
        if out is None:
            ell = _sparse.maybe_ell(V)
            out = run("gather", V) if ell is None else run("ell", ell)
        return out

    def sparse_fit(
        self,
        V,
        beta: float = 2,
        max_iter: int = 200,
        verbose: bool = False,
        sW: Optional[float] = None,
        sH: Optional[float] = None,
    ) -> int:
        r"""Hoyer'04 sparseness-constrained fitting (reference
        nmf.py:411-599) on the factors' device: W's rank columns held at
        Hoyer sparseness ``sW``, H's at ``sH`` (``None``: unconstrained; a
        frozen factor's is ignored).  Constrained factors take projected
        gradient steps with a backtracking line search, unconstrained ones
        MU steps, for exactly ``max_iter`` iterations.  ``V`` as in
        :meth:`fit`; a sparse COO target is taken by ``NMF`` only.
        Returns ``max_iter``.  A DTensor ``V`` takes the declined path, as
        the JAX package routes no Hoyer fit (every rank fits the whole
        ``V``; the factors come back replicated DTensors)."""
        W, H = self.W, self.H
        W_new, H_new, n_iter = self._fit_hoyer(
            V, W.detach(), H.detach(), W.requires_grad, H.requires_grad,
            float(beta), int(max_iter), bool(verbose), sW, sH)
        set_factors(self, W=W_new, H=H_new)
        return int(n_iter)

    @classmethod
    def _fit_hoyer(cls, V, W, H, update_W, update_H, beta, max_iter, verbose,
                   sW, sH):
        """The Hoyer fit of :meth:`sparse_fit` on explicit factors (shared
        with :func:`~pytorch_nmf_tpu_torch.functional.nmf_hoyer_fit`):
        ``(W, H, n_iter)``; a DTensor ``V`` or factor takes the declined
        path (:func:`~._common.fit_declined`)."""
        if any(is_dtensor(x) for x in (V, W, H)):
            return fit_declined(
                lambda V, W, H, verbose: cls._fit_hoyer(
                    V, W, H, update_W, update_H, beta, max_iter, verbose, sW,
                    sH), V, (W, H), verbose)
        V = target_like(V, W, H)
        sparse = V.layout != torch.strided
        if sparse:
            if V.layout != torch.sparse_coo or cls._sp_pos_neg is None:
                raise NotImplementedError(
                    f"{cls.__name__}'s Hoyer fit takes no {V.layout} target")
            if beta <= 0:
                raise ValueError(_BETA_ZERO_MSG)
            V = V.coalesce()
        else:
            validate_target(V, beta)
        fit_fn = _solver.get_hoyer_fit(
            None if sparse else cls._resolve_fit_recon2(V, W, H, beta),
            cls._sp_pos_neg if sparse else None,
            beta, max_iter, update_W, update_H,
            None if sW is None or not update_W else float(sW),
            None if sH is None or not update_H else float(sH),
            W.numel() // W.shape[1], H.numel() // H.shape[1], verbose)
        return fit_fn(V, W, H)

    @classmethod
    def _resolve_fit_recon2(cls, V, W, H, beta):
        """The reconstruction this Hoyer fit differentiates: the model's own
        ``reconstruct`` (the deconvolutional models resolve theirs per fit,
        :func:`~..ops.autotune.resolve_hoyer_recon2`)."""
        return cls.reconstruct


class NMF(BaseComponent):
    r"""Non-negative Matrix Factorization :math:`V \approx H W^\top`
    (reference nmf.py:641-697).  Shapes: ``V (M, K)``, ``W (K, R)``,
    ``H (M, R)``."""

    def __init__(self, Vshape: Iterable[int] = None, rank: int = None, **kwargs):
        if isinstance(Vshape, Iterabc):
            M, K = Vshape
            rank = rank if rank else K
            kwargs["W"] = (K, rank)
            kwargs["H"] = (M, rank)
        super().__init__(rank, **kwargs)

    @staticmethod
    def reconstruct(H, W):
        return _recon.linear(H, W)

    _sp_pos_neg = staticmethod(_sparse.nmf_sp_pos_neg)

    @classmethod
    def _resolve_updater_factory(cls, V, W, H, beta):
        return resolve_nmf_updater_factory(V.device, V.dtype)

    @classmethod
    def _route(cls, V):
        """Rows sharded over one named mesh dimension, the columns over
        another or not at all (:func:`~._common.row_axes`, the JAX
        package's ``P(data[, model])``): the explicit
        :func:`~..parallel.sharded.sharded_nmf_fit` on those axes."""
        axes = row_axes(V)
        if axes is None:
            return None
        from ..parallel import sharded

        def fit(V, W, H, *, update_W, update_H, beta, tol, max_iter, verbose,
                l1_reg, l2_reg):
            return sharded.sharded_nmf_fit(
                V, W, H, V.device_mesh, beta, tol, max_iter, l1_reg, l2_reg,
                data_axis=axes[0], model_axis=axes[1], _update_W=update_W,
                _update_H=update_H, _verbose=verbose)

        return fit


class _DeconvBase(BaseComponent):
    """The deconvolutional models' engine choice per fit, by timing above a
    size threshold (:mod:`~..ops.autotune`), whose static choice below it
    is :func:`~..ops.fast_nmfd.resolve_nmfd_updater_factory`;
    ``_spatial_ndim`` is each model's number of spatial axes."""

    @classmethod
    def _resolve_updater_factory(cls, V, W, H, beta):
        return _autotune.resolve_deconv_factory(V, W, H, beta,
                                                cls._spatial_ndim,
                                                cls.reconstruct)

    @classmethod
    def _resolve_fit_recon2(cls, V, W, H, beta):
        return _autotune.resolve_hoyer_recon2(cls, V, W, H, beta)

    @classmethod
    def _route(cls, V):
        """The trailing axis sharded over one mesh dimension alone
        (:func:`~._common.trailing_seq_axis`): the halo fit
        :func:`~..parallel.halo._sharded_deconv_fit` on it, its per-shard
        mode resolved as the explicit call resolves it."""
        axis = trailing_seq_axis(V)
        if axis is None:
            return None
        from ..parallel import halo

        def fit(V, W, H, *, update_W, update_H, beta, tol, max_iter, verbose,
                l1_reg, l2_reg):
            return halo._sharded_deconv_fit(
                V, W, H, V.device_mesh, cls._spatial_ndim, beta, tol,
                max_iter, l1_reg, l2_reg, axis, update_W, update_H, verbose)

        return fit


class NMFD(_DeconvBase):
    r"""Non-negative Matrix Factor Deconvolution, 1-D (Smaragdis 2004;
    reference nmf.py:700-779): a full-padded true convolution with the
    kernel flipped along time.  Shapes: ``V (N, C, L)``, ``W (C, R, T)``,
    ``H (N, R, L - T + 1)``."""

    def __init__(self, Vshape: Iterable[int] = None, rank: int = None,
                 T: Union[int, Tuple[int]] = 1, **kwargs):
        if isinstance(Vshape, Iterabc):
            (T,) = single(T)
            batch, K, M = Vshape
            rank = rank if rank else K
            kwargs["W"] = (K, rank, T)
            kwargs["H"] = (batch, rank, M - T + 1)
        super().__init__(rank, **kwargs)

    @staticmethod
    def reconstruct(H, W):
        return _recon.deconv1d(H, W)

    _spatial_ndim = 1


class NMF2D(_DeconvBase):
    r"""Non-negative Matrix Factor 2-D Deconvolution (Schmidt 2006;
    reference nmf.py:782-865)."""

    def __init__(self, Vshape: Iterable[int] = None, rank: int = None,
                 kernel_size: Union[int, Tuple[int, int]] = 1, **kwargs):
        if isinstance(Vshape, Iterabc):
            kernel_size = pair(kernel_size)
            kh, kw = kernel_size
            batch, channel, K, M = Vshape
            rank = rank if rank else K
            kwargs["W"] = (channel, rank) + kernel_size
            kwargs["H"] = (batch, rank, K - kh + 1, M - kw + 1)
        super().__init__(rank, **kwargs)

    @staticmethod
    def reconstruct(H, W):
        return _recon.deconv2d(H, W)

    _spatial_ndim = 2


class NMF3D(_DeconvBase):
    r"""Non-negative Matrix Factor 3-D Deconvolution
    (reference nmf.py:868-942)."""

    def __init__(self, Vshape: Iterable[int] = None, rank: int = None,
                 kernel_size: Union[int, Tuple[int, int, int]] = 1, **kwargs):
        if isinstance(Vshape, Iterabc):
            kernel_size = triple(kernel_size)
            k1, k2, k3 = kernel_size
            batch, channel, N, K, M = Vshape
            rank = rank if rank else K
            kwargs["W"] = (channel, rank) + kernel_size
            kwargs["H"] = (batch, rank, N - k1 + 1, K - k2 + 1, M - k3 + 1)
        super().__init__(rank, **kwargs)

    @staticmethod
    def reconstruct(H, W):
        return _recon.deconv3d(H, W)

    _spatial_ndim = 3

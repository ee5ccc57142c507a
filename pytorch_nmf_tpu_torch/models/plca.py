r"""PLCA models: ``BaseComponent``, ``PLCA``, ``SIPLCA``, ``SIPLCA2`` and
``SIPLCA3`` (counterpart of :mod:`pytorch_nmf_tpu.models.plca`).

Probabilistic Latent Component Analysis factors a normalized non-negative
tensor as a mixture of per-component marginals with a latent prior ``Z``.
Its fit is EM: the E-step is one backward pass of the reconstruction with
cotangent ``V/(WZH+eps)``, the M-step renormalizes the unnormalized
posterior marginals (reference plca.py:250-289), with optional Dirichlet
MAP priors.

The classes are ``torch.nn.Module``\ s holding ``nn.Parameter``\ s ``W``,
``H`` and ``Z``; construction normalizes every factor to a probability
distribution over its non-rank axes (reference plca.py:94-127), and ``Z``
is uniform when only ``rank`` is given.  ``requires_grad`` records the
``trainable_*`` flags.  The factors live on the card unless the
constructor is given ``device="cpu"``.

On a float32 target the SIPLCA family's E-step differentiates the
kernel-adjoint deconvolution (:func:`~..ops.autotune.resolve_plca_recon3`):
``dH`` runs B3 (``hgrad``) and ``dW`` B4 (``wgrad``) on the card.

A :class:`~torch.distributed.tensor.DTensor` target is routed as the JAX
package's ``fit`` routes a sharded array (its ``models/plca.py:223-237``):
``PLCA`` with its rows (samples) sharded over one named mesh dimension and
nothing else, both ``M`` and ``H``'s rows divisible by its size and the
model's own ``reconstruct``, to :func:`~..parallel.sharded.sharded_plca_fit`;
``SIPLCA``/``SIPLCA2``/``SIPLCA3`` sharded on the trailing axis alone to
the halo EM (:func:`~..parallel.halo._sharded_siplca_fit`).  Every other
DTensor target takes the declined path (:func:`~._common.fit_declined`):
each rank gathers ``V`` whole and runs the single-card fit.
"""

from collections.abc import Iterable as Iterabc
from typing import Iterable, Optional, Tuple, Union

import torch
from torch import nn

from ..ops import autotune as _autotune
from ..ops import recon as _recon
from ..ops import solver as _solver
from ..ops.fast_plca import resolve_plca_em_engine
from ..ops.solver import _plca_marginal_sum
from ._common import (
    assert_nonneg,
    fit_declined,
    gather_whole,
    is_dtensor,
    is_tensor_like,
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

__all__ = ["BaseComponent", "PLCA", "SIPLCA", "SIPLCA2", "SIPLCA3"]


class BaseComponent(nn.Module):
    r"""Base class for the PLCA modules (reference plca.py:34-304): like the
    NMF base, with a latent prior vector ``Z``; every stored factor is
    normalized to a probability distribution at construction.

    Args:
        rank: size of the hidden dimension; alone, it gives a uniform ``Z``.
        W, H: shape tuples (random |N(0,1)| init) or initial non-negative
            values.
        Z: initial non-negative ``(rank,)`` values.
        trainable_W / trainable_H / trainable_Z: freeze flags for given
            initial values.
        device: the card (``"cuda"``) when ``None``; ``"cpu"`` for the CPU.
        generator: the ``torch.Generator`` random inits are drawn from.
    """

    def __init__(
        self,
        rank: int = None,
        W=None,
        H=None,
        Z=None,
        trainable_W: bool = True,
        trainable_H: bool = True,
        trainable_Z: bool = True,
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

        infer_rank = None
        for name, x, trainable in (("W", W, trainable_W), ("H", H, trainable_H)):
            p = make(x, name, trainable)
            self.register_parameter(name, p)
            if p is not None:
                with torch.no_grad():
                    p.div_(_plca_marginal_sum(p))
                infer_rank = p.shape[1]

        if is_tensor_like(Z):
            z = to_param(Z, device)
            if z.ndim != 1:
                raise ValueError("Z should be one dimensional.")
            assert_nonneg(z, "Z")
            rank = int(z.shape[0])
            Zp = nn.Parameter(z, requires_grad=trainable_Z)
        elif isinstance(rank, int):
            Zp = nn.Parameter(torch.full((rank,), 1.0 / rank, device=device))
        else:
            Zp = None
        self.register_parameter("Z", Zp)
        if Zp is not None:
            with torch.no_grad():
                Zp.div_(Zp.sum())
            infer_rank = Zp.shape[0]

        if infer_rank is None:
            if not rank:
                raise ValueError(
                    "A rank should be given when W, H and Z are not available!")
        else:
            for name in ("Z", "H", "W"):
                p = getattr(self, name)
                if p is not None and p.shape[0 if name == "Z" else 1] != infer_rank:
                    raise ValueError(
                        f"Latent size of {name} does not match with others!")
            if self.W is not None:
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

    def forward(self, H=None, W=None, Z=None, norm: float = None):
        """Reconstruct with the given (or stored) factors, rescaled by
        ``norm`` when given (reference plca.py:153-183).  DTensor factors
        are gathered whole first (every rank of their mesh calls it): the
        result is a whole, plain tensor on every rank, with no gradient
        through the gather."""
        H = self.H if H is None else H
        W = self.W if W is None else W
        Z = self.Z if Z is None else Z
        if H is None or W is None or Z is None:
            raise ValueError("W, H and Z are needed to reconstruct")
        result = self.reconstruct(gather_whole(H), gather_whole(W),
                                  gather_whole(Z))
        return result if norm is None else result * norm

    @staticmethod
    def reconstruct(H, W, Z):
        """The model's forward map; overridden by subclasses."""
        raise NotImplementedError

    @classmethod
    def _em_engine(cls, V):
        """A fused E-step engine factory for this fit, or ``None`` for the
        generic backward pass (:class:`PLCA` overrides it)."""
        return None

    def fit(
        self,
        V,
        tol: float = 1e-4,
        max_iter: int = 200,
        verbose: bool = False,
        W_alpha: Union[float, torch.Tensor] = 1.0,
        H_alpha: Union[float, torch.Tensor] = 1.0,
        Z_alpha: Union[float, torch.Tensor] = 1.0,
    ):
        r"""EM maximizing the posterior log-probability with optional
        Dirichlet priors (reference plca.py:193-304), on the factors'
        device, in their dtype; ``V`` (a tensor anywhere, or a numpy array)
        is moved there (a float64 ``V`` of a float32 model is cast, with a
        ``UserWarning``).

        Returns ``(n_iter, norm)``: the reference's raw loop index, and
        ``V.sum()``, the scale to pass back to :meth:`forward` to
        reconstruct in ``V``'s units.

        A :class:`~torch.distributed.tensor.DTensor` ``V`` (every rank of its
        mesh calls ``fit``) runs the sharded or halo EM where its layout
        routes (the module docstring; ``norm`` is then a float), else the
        declined path; afterwards ``W``, ``H`` and ``Z`` are new
        ``nn.Parameter``\ s holding the fitted DTensors (``requires_grad``
        kept), which a later ``fit`` continues from.  A plain ``V`` given
        to DTensor factors gathers them and leaves plain parameters."""
        W, H, Z = self.W, self.H, self.Z
        W_new, H_new, Z_new, n_iter, norm = self._fit_em(
            V, W.detach(), H.detach(), Z.detach(), W.requires_grad,
            H.requires_grad, Z.requires_grad, float(tol), int(max_iter),
            bool(verbose), W_alpha, H_alpha, Z_alpha)
        set_factors(self, W=W_new, H=H_new, Z=Z_new)
        return int(n_iter), norm

    @classmethod
    def _fit_em(cls, V, W, H, Z, update_W, update_H, update_Z, tol, max_iter,
                verbose, W_alpha, H_alpha, Z_alpha):
        """The EM fit of :meth:`fit` on explicit factors (shared with
        :func:`~pytorch_nmf_tpu_torch.functional.plca_fit`):
        ``(W, H, Z, n_iter, norm)``; on a DTensor target (or DTensor
        factors) the model's route (:meth:`_route`) where ``V``'s layout
        has one and the factors are float32, after the ranks' joint check
        of ``V``, else the declined path (:func:`~._common.fit_declined`):
        DTensors in and out."""
        if any(is_dtensor(x) for x in (V, W, H, Z)):
            route = None
            if is_dtensor(V) and all(x.dtype == torch.float32
                                     for x in (W, H, Z)):
                route = cls._route(V, H)
            if route is None:
                return fit_declined(
                    lambda V, W, H, Z, verbose: cls._fit_em(
                        V, W, H, Z, update_W, update_H, update_Z, tol,
                        max_iter, verbose, W_alpha, H_alpha, Z_alpha),
                    V, (W, H, Z), verbose)
            validate_sharded(V, 1)
            return route(V, W, H, Z, tol, max_iter, W_alpha, H_alpha,
                         Z_alpha, update_W, update_H, update_Z, verbose)
        V = target_like(V, W, H, Z)
        validate_target(V, 1)
        fit_fn = _solver.get_plca_fit(
            cls._resolve_fit_recon3(V, W, H, Z), tol, max_iter,
            update_W, update_H, update_Z, _solver.alpha_is_active(W_alpha),
            _solver.alpha_is_active(H_alpha), _solver.alpha_is_active(Z_alpha),
            verbose, em_engine=cls._em_engine(V))

        def alpha(a):  # the factors' dtype: float32 for a bfloat16 V
            return torch.as_tensor(a, dtype=W.dtype, device=V.device)

        return fit_fn(V, W, H, Z, alpha(W_alpha), alpha(H_alpha),
                      alpha(Z_alpha))

    @classmethod
    def _resolve_fit_recon3(cls, V, W, H, Z):
        """The EM reconstruction of this fit: ``reconstruct`` (the
        shift-invariant models resolve theirs per fit,
        :func:`~..ops.autotune.resolve_plca_recon3`)."""
        return cls.reconstruct

    @classmethod
    def _route(cls, V, H):
        """The explicit EM that a DTensor ``V`` of this model routes to, as
        ``fit(V, W, H, Z, tol, max_iter, W_alpha, H_alpha, Z_alpha,
        update_W, update_H, update_Z, verbose)``, or ``None`` (declined):
        none here; :class:`PLCA` and the shift-invariant models have
        theirs."""
        return None


def _siplca_route(cls, V, H):
    """The shift-invariant models' route: the trailing axis sharded over one
    mesh dimension alone (:func:`~._common.trailing_seq_axis`) takes the
    halo EM :func:`~..parallel.halo._sharded_siplca_fit` on it."""
    axis = trailing_seq_axis(V)
    if axis is None:
        return None
    from ..parallel import halo

    def fit(V, W, H, Z, tol, max_iter, W_alpha, H_alpha, Z_alpha, update_W,
            update_H, update_Z, verbose):
        return halo._sharded_siplca_fit(
            V, W, H, Z, V.device_mesh, cls._spatial_ndim, tol, max_iter,
            W_alpha, H_alpha, Z_alpha, update_W, update_H, update_Z, axis,
            verbose)

    return fit


class PLCA(BaseComponent):
    r"""Probabilistic Latent Component Analysis:
    :math:`P(n, c) \approx \sum_z P(c|z) P(z) P(n|z)`, i.e.
    ``V ≈ H diag(Z) Wᵀ`` (reference plca.py:307-373).  Shapes: ``V (M, K)``,
    ``W (K, R)``, ``H (M, R)``, ``Z (R,)``."""

    def __init__(self, Vshape: Iterable[int] = None, rank: int = None, **kwargs):
        if isinstance(Vshape, Iterabc):
            M, K = Vshape
            rank = rank if rank else K
            kwargs["W"] = (K, rank)
            kwargs["H"] = (M, rank)
        super().__init__(rank, **kwargs)

    @staticmethod
    def reconstruct(H, W, Z):
        return _recon.linear(H, _recon.scaled_kernel(W, Z, 0))

    @classmethod
    def _route(cls, V, H):
        """The JAX package's rule (``models/plca.py:341-360``): the rows
        sharded over one named mesh dimension and nothing else
        (:func:`~._common.row_axes` without columns; not float64), ``V``'s
        and ``H``'s rows divisible by its size, and the model's own
        ``reconstruct`` (the explicit EM's is the dense one): the explicit
        :func:`~..parallel.sharded.sharded_plca_fit` on that axis."""
        axes = row_axes(V, columns=False)
        if axes is None or cls.reconstruct is not PLCA.reconstruct:
            return None
        mesh = V.device_mesh
        n = mesh.size(mesh.mesh_dim_names.index(axes[0]))
        if V.shape[0] % n or H.shape[0] % n:
            return None
        from ..parallel import sharded

        def fit(V, W, H, Z, tol, max_iter, W_alpha, H_alpha, Z_alpha,
                update_W, update_H, update_Z, verbose):
            return sharded.sharded_plca_fit(
                V, W, H, Z, mesh, tol, max_iter, W_alpha, H_alpha, Z_alpha,
                update_W, update_H, update_Z, data_axis=axes[0],
                verbose=verbose)

        return fit

    @classmethod
    def _em_engine(cls, V):
        # the fused E-step is opt-in (PNT_PLCA_FUSED=1), and only for the
        # dense reconstruction: a subclass with its own keeps the generic
        if cls.reconstruct is not PLCA.reconstruct:
            return None
        return resolve_plca_em_engine(V)


class SIPLCA(BaseComponent):
    r"""Shift-Invariant PLCA, 1-D (Smaragdis & Raj 2007; reference
    plca.py:376-449).  Shapes: ``V (N, C, L)``, ``W (C, R, T)``,
    ``H (N, R, L - T + 1)``, ``Z (R,)``."""

    _spatial_ndim = 1

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
    def reconstruct(H, W, Z):
        return _recon.deconv1d(H, _recon.scaled_kernel(W, Z, 1))

    _resolve_fit_recon3 = classmethod(_autotune.resolve_plca_recon3)
    _route = classmethod(_siplca_route)


class SIPLCA2(BaseComponent):
    r"""Shift-Invariant PLCA across 2 dimensions (reference
    plca.py:452-525)."""

    _spatial_ndim = 2

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
    def reconstruct(H, W, Z):
        return _recon.deconv2d(H, _recon.scaled_kernel(W, Z, 2))

    _resolve_fit_recon3 = classmethod(_autotune.resolve_plca_recon3)
    _route = classmethod(_siplca_route)


class SIPLCA3(BaseComponent):
    r"""Shift-Invariant PLCA across 3 dimensions (reference
    plca.py:528-606)."""

    _spatial_ndim = 3

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
    def reconstruct(H, W, Z):
        return _recon.deconv3d(H, _recon.scaled_kernel(W, Z, 3))

    _resolve_fit_recon3 = classmethod(_autotune.resolve_plca_recon3)
    _route = classmethod(_siplca_route)

"""Small user utilities, and the carry-over of a JAX model's parameters.

* :func:`normalize` — scale so the sum over ``axis`` is 1.
* :func:`renorm` — scale so the L2 norm over ``axis`` is 1.
* :func:`nmf_from_numpy` — build the port's ``NMF``, ``NMFD``, ``NMF2D`` or
  ``NMF3D`` from the JAX package's
  ``{"W": np.asarray(m.W.data), "H": np.asarray(m.H.data)}``.
* :func:`plca_from_numpy` — the same for ``PLCA``, ``SIPLCA``, ``SIPLCA2`` or
  ``SIPLCA3`` from ``{"W", "H", "Z"}``.
* :class:`LossHistory` — record a verbose fit's 10-iteration losses.
* :mod:`.checkpoint` — ``.npz`` checkpoints and segmented fits that resume
  (each package resumes the other's directories).
* :mod:`.profiling` — ``torch.profiler`` traces, named regions and the
  card's memory statistics.
"""

import numpy as np
import torch

from . import checkpoint, profiling  # noqa: F401

__all__ = ["normalize", "renorm", "nmf_from_numpy", "plca_from_numpy",
           "checkpoint", "profiling", "LossHistory"]


class LossHistory:
    """Record the solver's cadence losses during a fit.

    The fits evaluate the loss every 10 iterations and, when verbose,
    report it to their progress bar and to every registered handler; this
    context manager registers a recorder beside the bar.  Pass
    ``verbose=True`` to the fit being recorded (the condition under which
    the reference computes its losses for tqdm, nmf.py:393-404).

    >>> with LossHistory() as hist:
    ...     model.fit(V, beta=1, max_iter=200, verbose=True)
    >>> hist.chunks, hist.losses   # 10-iteration checkpoints
    >>> hist.extras                # PLCA: the log-posterior trace

    ``hist.losses`` are on the reference's ``sqrt(2 * divergence)`` scale.
    """

    def __init__(self):
        self.chunks = []
        self.losses = []
        self.extras = []

    def _record(self, chunk_idx, loss, extra=None):
        self.chunks.append(int(chunk_idx))
        self.losses.append(float(loss))
        self.extras.append(None if extra is None else float(extra))

    def __enter__(self):
        from ..ops import solver

        solver.push_progress_handler(self._record)
        return self

    def __exit__(self, *exc):
        from ..ops import solver

        solver.pop_progress_handler()
        return False


def normalize(x: torch.Tensor, axis=None) -> torch.Tensor:
    if axis is None:
        return x / torch.sum(x)
    return x / torch.sum(x, dim=axis, keepdim=True)


def renorm(x: torch.Tensor, axis=None) -> torch.Tensor:
    if axis is None:
        return x / torch.sqrt(torch.sum(x * x))
    return x / torch.sqrt(torch.sum(x * x, dim=axis, keepdim=True))


def nmf_from_numpy(params: "dict[str, np.ndarray]", device=None,
                   trainable_W: bool = True, trainable_H: bool = True):
    """The port's model holding the given factors on ``device`` (the card
    when ``None``; ``"cpu"`` for the CPU), chosen by
    the number of axes of ``W``: ``W (K, R)`` builds ``NMF`` (with ``H (M, R)``),
    ``W (C, R, *k)`` with one to three kernel axes ``NMFD``, ``NMF2D`` or
    ``NMF3D`` (with ``H (N, R, *S_in)``).  The layouts are the JAX package's."""
    from ..models.nmf import NMF, NMF2D, NMF3D, NMFD

    models = {2: NMF, 3: NMFD, 4: NMF2D, 5: NMF3D}
    ndim = np.ndim(params["W"])
    if ndim not in models:
        raise ValueError(f"no model takes a {ndim}-D W")
    return models[ndim](
        W=torch.from_numpy(np.array(params["W"])),  # a writable copy
        H=torch.from_numpy(np.array(params["H"])),
        trainable_W=trainable_W,
        trainable_H=trainable_H,
        device=device,
    )


def plca_from_numpy(params: "dict[str, np.ndarray]", device=None,
                    trainable_W: bool = True, trainable_H: bool = True,
                    trainable_Z: bool = True):
    """The port's PLCA-family model holding the given factors on ``device``
    (the card when ``None``), chosen by the number of axes of ``W``: 2-D
    ``PLCA``, 3-D ``SIPLCA``, 4-D ``SIPLCA2``, 5-D ``SIPLCA3``.  The
    constructor renormalizes them, which leaves the JAX package's fitted
    (already normalized) factors as they are up to rounding."""
    from ..models.plca import PLCA, SIPLCA, SIPLCA2, SIPLCA3

    models = {2: PLCA, 3: SIPLCA, 4: SIPLCA2, 5: SIPLCA3}
    ndim = np.ndim(params["W"])
    if ndim not in models:
        raise ValueError(f"no PLCA model takes a {ndim}-D W")
    return models[ndim](
        W=torch.from_numpy(np.array(params["W"])),
        H=torch.from_numpy(np.array(params["H"])),
        Z=torch.from_numpy(np.array(params["Z"])),
        trainable_W=trainable_W,
        trainable_H=trainable_H,
        trainable_Z=trainable_Z,
        device=device,
    )

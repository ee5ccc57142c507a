"""Small user utilities, and the carry-over of a JAX model's parameters.

* :func:`normalize` — scale so the sum over ``axis`` is 1.
* :func:`renorm` — scale so the L2 norm over ``axis`` is 1.
* :func:`nmf_from_numpy` — build the port's ``NMF`` from the JAX package's
  ``{"W": np.asarray(m.W.data), "H": np.asarray(m.H.data)}``.
"""

import numpy as np
import torch

__all__ = ["normalize", "renorm", "nmf_from_numpy"]


def normalize(x: torch.Tensor, axis=None) -> torch.Tensor:
    if axis is None:
        return x / torch.sum(x)
    return x / torch.sum(x, dim=axis, keepdim=True)


def renorm(x: torch.Tensor, axis=None) -> torch.Tensor:
    if axis is None:
        return x / torch.sqrt(torch.sum(x * x))
    return x / torch.sqrt(torch.sum(x * x, dim=axis, keepdim=True))


def nmf_from_numpy(params: "dict[str, np.ndarray]", device,
                   trainable_W: bool = True, trainable_H: bool = True):
    """The port's ``NMF`` holding the given factors on ``device``.  The
    layouts are those of the JAX package: ``W (K, R)``, ``H (M, R)``."""
    from ..models.nmf import NMF

    return NMF(
        W=torch.from_numpy(np.ascontiguousarray(params["W"])),
        H=torch.from_numpy(np.ascontiguousarray(params["H"])),
        trainable_W=trainable_W,
        trainable_H=trainable_H,
        device=device,
    )

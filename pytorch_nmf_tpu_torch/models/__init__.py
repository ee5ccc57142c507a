"""Stateful model wrappers; all training delegates to ``ops.solver``."""

from .nmf import BaseComponent, NMF, NMF2D, NMF3D, NMFD  # noqa: F401
from .plca import PLCA, SIPLCA, SIPLCA2, SIPLCA3  # noqa: F401

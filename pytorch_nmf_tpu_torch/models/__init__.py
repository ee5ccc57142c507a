"""Stateful model wrappers; all training delegates to ``ops.solver``."""

from .nmf import BaseComponent, NMF  # noqa: F401

"""User-facing NMF module — mirrors the reference import surface
(``from pytorch_nmf_tpu_torch.nmf import NMF``)."""

from .models.nmf import BaseComponent, NMF  # noqa: F401

__all__ = ["BaseComponent", "NMF"]

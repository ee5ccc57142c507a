"""User-facing NMF module — mirrors the reference import surface
(``from pytorch_nmf_tpu_torch.nmf import NMF``)."""

from .models.nmf import NMF, NMF2D, NMF3D, NMFD, BaseComponent  # noqa: F401

__all__ = ["BaseComponent", "NMF", "NMFD", "NMF2D", "NMF3D"]

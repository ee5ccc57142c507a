"""User-facing PLCA module — mirrors the reference import surface
(``from pytorch_nmf_tpu_torch.plca import PLCA``)."""

from .models.plca import PLCA, SIPLCA, SIPLCA2, SIPLCA3, BaseComponent  # noqa: F401

__all__ = ["BaseComponent", "PLCA", "SIPLCA", "SIPLCA2", "SIPLCA3"]

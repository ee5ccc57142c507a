"""The port's public surface against the JAX package's: every name in a
JAX module's ``__all__`` exists in the port's counterpart module.

The exceptions are explicit.  ``NOT_PORTED`` mirrors ``ROADMAP.md``'s "Not
ported" list (TPU- or JAX-only machinery); ``RENAMED`` maps a JAX name to
the port's counterpart of another name; ``MODULES`` the two kernel
modules, which the port names after its kernels.
"""

import importlib
import pkgutil

import pytest

jax = pytest.importorskip("jax")

import pytorch_nmf_tpu  # noqa: E402

# JAX module -> the port's module, where the names differ
MODULES = {
    "pytorch_nmf_tpu.ops.pallas_mu": "pytorch_nmf_tpu_torch.ops.fused_mu",
    "pytorch_nmf_tpu.ops.pallas_deconv": "pytorch_nmf_tpu_torch.ops.fused_deconv",
}

# (JAX module, name) -> the port's name in the counterpart module
RENAMED = {
    ("pytorch_nmf_tpu.models._common", "to_f32"): "target_like",
    ("pytorch_nmf_tpu.ops.fast_nmf", "nmf_updater_factory"):
        "resolve_nmf_updater_factory",
    ("pytorch_nmf_tpu.ops.fast_nmf", "nmf_updater_factory_pallas"):
        "nmf_updater_factory_fused",
    ("pytorch_nmf_tpu.ops.fast_nmf", "nmf_updater_factory_interpret"):
        "nmf_updater_factory_plain",
    ("pytorch_nmf_tpu.ops.fast_nmf", "nmf_updater_factory_xla"):
        "nmf_updater_factory_generic",
}

# whole modules, and names, that ROADMAP.md lists under "Not ported"
NOT_PORTED_MODULES = {"pytorch_nmf_tpu.module", "pytorch_nmf_tpu.native"}
NOT_PORTED = {
    "pytorch_nmf_tpu.ops.sparse": {"SparseCOO", "sparse_coo_tensor",
                                   "from_torch_sparse"},
    "pytorch_nmf_tpu.utils.checkpoint": {"save_orbax", "load_orbax"},
    "pytorch_nmf_tpu.ops.autotune": {"enable_compile_cache"},
    "pytorch_nmf_tpu.parallel.sharded": {"nmf_updater_factory_sharded"},
    "pytorch_nmf_tpu.ops.pallas_deconv": {
        "deconv_pallas_supported", "deconv_pallas_nd_supported",
        "deconv_pallas_w_supported", "halo_pallas_mode"},
    "pytorch_nmf_tpu.ops.pallas_mu": {"pallas_supported"},
}


def _public_modules():
    """``[(JAX module name, __all__)]`` of every JAX module with one."""
    out = []
    for info in pkgutil.walk_packages(pytorch_nmf_tpu.__path__,
                                      "pytorch_nmf_tpu."):
        mod = importlib.import_module(info.name)
        names = getattr(mod, "__all__", None)
        if names is not None:
            out.append((info.name, tuple(names)))
    return out


PUBLIC = _public_modules() + [("pytorch_nmf_tpu",
                               tuple(getattr(pytorch_nmf_tpu, "__all__", ())))]
PORTED = [(m, names) for m, names in PUBLIC if m not in NOT_PORTED_MODULES]


@pytest.mark.parametrize("jax_name, names", PORTED, ids=[m for m, _ in PORTED])
def test_jax_public_names_exist_in_the_port(jax_name, names):
    port_name = MODULES.get(
        jax_name, jax_name.replace("pytorch_nmf_tpu", "pytorch_nmf_tpu_torch",
                                   1))
    port = importlib.import_module(port_name)
    skip = NOT_PORTED.get(jax_name, set())
    missing = [n for n in names if n not in skip
               and not hasattr(port, RENAMED.get((jax_name, n), n))]
    assert not missing, f"{port_name} lacks {missing} of {jax_name}.__all__"


def test_exceptions_name_real_jax_names():
    """Every exception names a name the JAX package still exports, so the
    list cannot outlive what it excuses."""
    public = dict(PUBLIC)
    for mod, names in NOT_PORTED.items():
        assert names <= set(public[mod]), mod
    for mod, name in RENAMED:
        assert name in public[mod], (mod, name)
    assert NOT_PORTED_MODULES <= set(public)


def test_models_package_exports_the_deconv_models():
    from pytorch_nmf_tpu import models as jm
    from pytorch_nmf_tpu_torch import models as tm
    from pytorch_nmf_tpu_torch.models import NMF2D, NMF3D, NMFD  # noqa: F401

    for name in ("NMF", "NMFD", "NMF2D", "NMF3D", "PLCA", "SIPLCA", "SIPLCA2",
                 "SIPLCA3"):
        assert hasattr(jm, name) and hasattr(tm, name), name
        assert getattr(tm, name) is getattr(tm.nmf if "NMF" in name
                                            else tm.plca, name)


def test_unfold_patches_matches_jax():
    """``unfold_patches(H, T)`` is the 1-D patch matrix of the JAX
    package's, ``(N, L + T - 1, T·R)``."""
    import numpy as np
    import torch

    from pytorch_nmf_tpu.ops.fast_nmfd import unfold_patches as jax_unfold
    from pytorch_nmf_tpu_torch.ops.fast_nmfd import unfold_patches

    H = np.random.RandomState(0).rand(2, 3, 17).astype("f")
    P = unfold_patches(torch.from_numpy(H), 5)
    assert tuple(P.shape) == (2, 21, 15)
    np.testing.assert_array_equal(P.numpy(), np.asarray(jax_unfold(H, 5)))


def test_device_bytes_limit_is_none_on_the_cpu():
    import torch

    from pytorch_nmf_tpu_torch.ops import budget

    assert budget.device_bytes_limit("cpu") is None
    if not torch.cuda.is_available():
        assert budget.device_bytes_limit() is None
    assert budget.budget_bytes("PNT_NO_SUCH_BUDGET", 123, 0.5, "cpu") == 123

"""The port stands alone: importing every module of
``pytorch_nmf_tpu_torch`` loads neither JAX nor any module of the JAX
package."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import pytorch_nmf_tpu_torch

ROOT = Path(__file__).resolve().parents[1]


def _modules():
    prefix = pytorch_nmf_tpu_torch.__name__ + "."
    return [pytorch_nmf_tpu_torch.__name__] + sorted(
        m.name for m in pkgutil.walk_packages(pytorch_nmf_tpu_torch.__path__,
                                              prefix))


def test_every_module_is_listed():
    mods = _modules()
    for name in ("ops.sparse", "ops.fast_plca", "ops.budget", "models.plca",
                 "plca", "ops.fused_deconv", "utils", "functional", "trainer",
                 "ops.projection", "ops.trainer_core", "ops.autotune",
                 "ops.streaming", "ops.fft_nmfd", "utils.checkpoint",
                 "utils.profiling", "parallel", "parallel.comm",
                 "parallel.distributed", "parallel.halo", "parallel.mesh",
                 "parallel.sharded", "parallel.sharded_sparse"):
        assert f"pytorch_nmf_tpu_torch.{name}" in mods


def test_public_names_match_the_jax_package():
    """The slice's public names: ``utils`` (less orbax), ``ops.autotune``'s
    entry points and the solver's progress-handler stack."""
    from pytorch_nmf_tpu_torch import utils
    from pytorch_nmf_tpu_torch.ops import autotune, solver
    from pytorch_nmf_tpu_torch.utils import checkpoint, profiling

    assert {"normalize", "renorm", "checkpoint", "profiling",
            "LossHistory"} <= set(utils.__all__)
    assert set(checkpoint.__all__) == {"save", "load", "checkpointed_fit",
                                       "checkpointed_plca_fit"}
    assert set(profiling.__all__) == {"trace", "annotate",
                                      "device_memory_stats"}
    for name in ("clear_cache", "autotune_winner", "resolve_deconv_factory",
                 "resolve_plca_recon3", "resolve_hoyer_recon2",
                 "autotune_halo_mode"):
        assert callable(getattr(autotune, name))
    assert callable(solver.push_progress_handler)
    assert callable(solver.pop_progress_handler)


def test_importing_every_module_leaves_jax_out():
    code = (
        "import importlib, sys\n"
        f"for name in {_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'pytorch_nmf_tpu' or m.startswith('pytorch_nmf_tpu.'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=ROOT)


# the JAX package's ``parallel`` names (``pytorch_nmf_tpu/parallel``), and
# those the port leaves out: ``sharded.nmf_updater_factory_sharded``
# exists for the GSPMD auto-routing of ``NMF.fit`` on a sharded target,
# which has no torch counterpart (ROADMAP A15 "Removal")
JAX_PARALLEL = {
    "": {"distributed", "left_halo", "make_hybrid_mesh", "make_mesh",
         "shard_target", "sharded_nmf2d_fit", "sharded_nmf3d_fit",
         "sharded_nmf_fit", "sharded_nmfd_fit", "sharded_plca_fit",
         "sharded_siplca2_fit", "sharded_siplca3_fit", "sharded_siplca_fit",
         "sharded_sparse_nmf_fit"},
    "mesh": {"make_mesh", "make_hybrid_mesh"},
    "distributed": {"initialize", "global_mesh"},
    "sharded": {"shard_target", "sharded_nmf_fit", "sharded_plca_fit",
                "nmf_updater_factory_sharded"},
    "sharded_sparse": {"sharded_sparse_nmf_fit"},
    "halo": {"left_halo", "halo_adjoint", "halo_recv", "halo_adjoint_strip",
             "sharded_nmfd_fit", "sharded_nmf2d_fit", "sharded_nmf3d_fit",
             "sharded_siplca_fit", "sharded_siplca2_fit",
             "sharded_siplca3_fit"},
}
NOT_PORTED = {"sharded": {"nmf_updater_factory_sharded"}}


def test_parallel_names_match_the_jax_package():
    import importlib

    for mod, names in JAX_PARALLEL.items():
        m = importlib.import_module(
            "pytorch_nmf_tpu_torch.parallel" + (f".{mod}" if mod else ""))
        assert set(m.__all__) == names - NOT_PORTED.get(mod, set()), mod
        for name in m.__all__:
            assert hasattr(m, name), (mod, name)


def test_parallel_sources_import_no_jax():
    """No module of ``parallel/`` names JAX or the JAX package in an
    import."""
    import re

    pattern = re.compile(r"^\s*(from|import)\s+(jax\b|pytorch_nmf_tpu\b(?!_))",
                         re.M)
    for path in (ROOT / "pytorch_nmf_tpu_torch" / "parallel").glob("*.py"):
        assert not pattern.search(path.read_text()), path.name

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
                 "utils.profiling"):
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
                 "resolve_plca_recon3", "resolve_hoyer_recon2"):
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

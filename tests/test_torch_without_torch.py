"""The port's tests where torch is not installed (the JAX package's CI
installs none): every port test module skips at collection, with no
collection error.  This file imports torch only inside its tests.

Also ``autotune.autotune_halo_mode``'s default device: the card, as for the
models, and the CPU's rules only when ``device="cpu"`` is passed.
"""

import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

# hides torch from the child (``import torch`` raises ImportError), then
# collects the given files
COLLECT = ("import sys; sys.modules['torch'] = None; import pytest; "
           "sys.exit(pytest.main(sys.argv[1:]))")


def _port_test_files():
    return sorted(str(p.relative_to(ROOT))
                  for p in (ROOT / "tests").glob("test_torch_*.py")) + [
        "tests/_torch_parallel_child.py"]


def test_port_tests_skip_without_torch():
    files = _port_test_files()
    run = subprocess.run(
        [sys.executable, "-c", COLLECT, "--collect-only", "-q", "-rs",
         "-p", "no:cacheprovider", *files],
        cwd=ROOT, capture_output=True, text=True, timeout=45)
    out = run.stdout + run.stderr
    # this file's own tests are the only ones collected
    assert run.returncode == 0, out[-4000:]
    assert "error" not in out.splitlines()[-1].lower(), out[-4000:]
    skipped = {line.split()[2].split(":")[0]
               for line in out.splitlines()
               if line.startswith("SKIPPED") and "torch" in line}
    assert skipped == set(files) - {"tests/test_torch_without_torch.py",
                                    "tests/_torch_parallel_child.py"}, out[-4000:]


# one rank's problem: 1 batch, 12 channels, 40 frames, kernel 5, rank 3
ROW = (1, 12, (), 40, (5,), 3, 1.0)


def test_autotune_halo_mode_defaults_to_the_card(monkeypatch):
    torch = pytest.importorskip("torch")
    from pytorch_nmf_tpu_torch.ops import autotune

    for name in ("PNT_NMFD_PALLAS", "PNT_NMFD_AUTOTUNE",
                 "PNT_AUTOTUNE_MIN_FLOPS"):
        monkeypatch.delenv(name, raising=False)
    autotune.clear_cache()
    if torch.cuda.is_available():
        # the kernel path's rule, untimed below the threshold
        assert autotune.autotune_halo_mode(*ROW, "unrolled") == "fused"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            autotune.autotune_halo_mode(*ROW, "unrolled")
    # the CPU's rules, as before: the heuristic below the threshold,
    # float64 → conv, PNT_NMFD_PALLAS=1 → fused
    for heuristic in ("stream", "unrolled", "conv"):
        assert autotune.autotune_halo_mode(*ROW, heuristic,
                                           device="cpu") == heuristic
    assert autotune.autotune_halo_mode(*ROW, "unrolled", device="cpu",
                                       dtype=torch.float64) == "conv"
    monkeypatch.setenv("PNT_NMFD_PALLAS", "1")
    assert autotune.autotune_halo_mode(*ROW, "stream", device="cpu") == "fused"
    assert not autotune._MEASURED

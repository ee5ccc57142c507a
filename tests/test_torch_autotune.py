"""The port's per-fit engine selection (``ops/autotune.py``), following
``tests/test_autotune.py``: forced on at small CPU shapes
(``PNT_NMFD_AUTOTUNE=1``), a winner is measured and cached, fits agree
whichever engine wins (``max|Δ| < 5e-5``, the JAX test's bound; 5e-6 for
the EM, whose values are probabilities), the env switches come before the
tuner, small problems keep the static choice, the persistent cache round
trips and ignores winners that are no candidate of the port, and a
candidate that raises while it is timed makes the tuner raise.  On the
card (stand-in targets here) only the kernel engines are candidates, and a
challenger replaces the static choice only past the margin.
"""

import json
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pytorch_nmf_tpu_torch.nmf import NMFD, NMF2D
from pytorch_nmf_tpu_torch.ops import autotune, fast_nmfd
from pytorch_nmf_tpu_torch.plca import SIPLCA

ENV = ("PNT_NMFD_AUTOTUNE", "PNT_AUTOTUNE_MIN_FLOPS", "PNT_AUTOTUNE_CACHE",
       "PNT_NMFD_UNFOLD", "PNT_NMFD_FFT", "PNT_NMFD_AUTOCORR",
       "PNT_NMFD_PALLAS")
NAMES = {"fused", "fused_w", "unfold", "autocorr", "fft", "conv"}


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(autotune, "_TARGET_S", 0.002)
    autotune.clear_cache()
    yield
    autotune.clear_cache()


@pytest.fixture(scope="module")
def jx():
    """The JAX package's NMFD and autotuner."""
    pytest.importorskip("jax")
    from pytorch_nmf_tpu.models import nmf
    from pytorch_nmf_tpu.ops import autotune as jautotune

    return SimpleNamespace(NMFD=nmf.NMFD, autotune=jautotune)


def _problem(seed=5):
    rs = np.random.RandomState(seed)
    V = rs.rand(1, 12, 40).astype("f")
    W0 = rs.rand(12, 4, 6).astype("f") + 0.1
    H0 = rs.rand(1, 4, 35).astype("f") + 0.1
    return V, W0, H0


def _t(*xs):
    return tuple(torch.from_numpy(x) for x in xs)


def _max_diff(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return float(np.abs(a - b).max())


def _fit(V, W0, H0, beta, iters=5, model=NMFD):
    m = model(W=W0, H=H0, device="cpu")
    m.fit(V, beta=beta, tol=float("-inf"), max_iter=iters)
    return m


def test_autotune_measures_and_caches(monkeypatch):
    monkeypatch.setenv("PNT_NMFD_AUTOTUNE", "1")
    V, W0, H0 = _problem()
    _fit(V, W0, H0, 1)
    (key, winner), = autotune._WINNERS.items()
    assert key == ("cpu", 1, 1.0, V.shape, H0.shape)
    assert set(autotune._MEASURED[key]) == {"fused", "fused_w", "unfold",
                                            "conv"}
    assert winner in autotune._MEASURED[key]
    calls = []
    monkeypatch.setattr(autotune, "_time_candidate",
                        lambda *a, **k: calls.append(1) or 1.0)
    _fit(V, W0, H0, 1)
    assert not calls


def test_fft_and_autocorr_candidates_at_beta2(monkeypatch):
    monkeypatch.setenv("PNT_NMFD_FFT", "auto")
    V, W0, H0 = _t(*_problem())
    winner = autotune.autotune_winner(V, W0, H0, 2.0, 1, NMFD.reconstruct)
    (key,) = autotune._MEASURED
    assert set(autotune._MEASURED[key]) == {"fused", "fused_w", "unfold",
                                            "autocorr", "fft", "conv"}
    assert winner in autotune._MEASURED[key]
    monkeypatch.setenv("PNT_NMFD_FFT", "")
    monkeypatch.setenv("PNT_NMFD_AUTOCORR", "0")
    names = {n for n, _ in autotune._candidates(V, H0, 2.0, 1)}
    assert names == {"fused", "fused_w", "unfold", "conv"}
    assert "autocorr" not in {n for n, _ in autotune._candidates(V, H0, 1.0, 1)}


@pytest.mark.parametrize("forced", ["fused", "fused_w", "unfold", "conv",
                                    "fft", "autocorr"])
def test_fit_matches_for_any_winner(monkeypatch, forced):
    V, W0, H0 = _problem()
    monkeypatch.setenv("PNT_NMFD_AUTOTUNE", "0")
    ref = _fit(V, W0, H0, 2)
    monkeypatch.setenv("PNT_NMFD_AUTOTUNE", "1")
    monkeypatch.setenv("PNT_NMFD_FFT", "auto")
    monkeypatch.setattr(autotune, "autotune_winner", lambda *a, **k: forced)
    m = _fit(V, W0, H0, 2)
    assert _max_diff(m.W, ref.W) < 5e-5 and _max_diff(m.H, ref.H) < 5e-5


@pytest.mark.parametrize("forced", ["unfold", "conv", "fft", "autocorr"])
def test_forced_winner_matches_jax(jx, monkeypatch, forced):
    """The engines the packages share give the same fit for the same
    forced winner."""
    V, W0, H0 = _problem(seed=8)
    monkeypatch.setenv("PNT_NMFD_AUTOTUNE", "1")
    monkeypatch.setenv("PNT_NMFD_FFT", "auto")
    monkeypatch.setattr(autotune, "autotune_winner", lambda *a, **k: forced)
    monkeypatch.setattr(jx.autotune, "autotune_winner", lambda *a, **k: forced)
    m = _fit(V, W0, H0, 2)
    j = jx.NMFD(W=W0, H=H0)
    j.fit(V, beta=2, tol=float("-inf"), max_iter=5)
    assert _max_diff(m.W, j.W.data) < 5e-5 and _max_diff(m.H, j.H.data) < 5e-5


@pytest.mark.parametrize("env, beta, want", [
    ({"PNT_NMFD_UNFOLD": "0"}, 1.0, None),
    ({"PNT_NMFD_FFT": "1"}, 2.0, "nmfd_fft_updater_factory"),
    ({"PNT_NMFD_AUTOCORR": "1"}, 2.0, "nmfd_autocorr_updater_factory"),
    ({"PNT_NMFD_PALLAS": "1"}, 1.0, "fused"),
])
def test_env_switches_beat_autotune(monkeypatch, env, beta, want):
    monkeypatch.setenv("PNT_NMFD_AUTOTUNE", "1")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    V, W0, H0 = _t(*_problem())
    out = autotune.resolve_deconv_factory(V, W0, H0, beta, 1, NMFD.reconstruct)
    if want is None:
        assert out is None
    elif want == "fused":
        assert out is fast_nmfd.deconv_updater_factory_fused(1)
    else:
        assert out is getattr(fast_nmfd, want)
    assert not autotune._WINNERS  # no timing ran


def test_pallas_off_removes_the_kernel_engines(monkeypatch):
    monkeypatch.setenv("PNT_NMFD_PALLAS", "0")
    V, W0, H0 = _t(*_problem())
    names = [n for n, _ in autotune._candidates(V, H0, 1.0, 1)]
    assert names == ["unfold", "conv"]
    monkeypatch.setenv("PNT_NMFD_AUTOTUNE", "0")
    assert autotune.resolve_deconv_factory(
        V, W0, H0, 1.0, 1, NMFD.reconstruct) is \
        fast_nmfd.deconv_updater_factory_unfold(1)


def test_threshold_and_dtype_keep_the_static_choice(monkeypatch):
    V, W0, H0 = _t(*_problem())
    static = fast_nmfd.resolve_nmfd_updater_factory("cpu", torch.float32, 1)
    assert autotune.resolve_deconv_factory(
        V, W0, H0, 1.0, 1, NMFD.reconstruct) is static
    _fit(*_problem(), 1)
    assert not autotune._WINNERS  # below PNT_AUTOTUNE_MIN_FLOPS
    monkeypatch.setenv("PNT_NMFD_AUTOTUNE", "1")
    assert autotune.resolve_deconv_factory(
        V.double(), W0.double(), H0.double(), 1.0, 1, NMFD.reconstruct) is None
    assert not autotune._WINNERS
    monkeypatch.setenv("PNT_NMFD_AUTOTUNE", "")
    monkeypatch.setenv("PNT_AUTOTUNE_MIN_FLOPS", "1")
    _fit(*_problem(), 1)
    assert len(autotune._WINNERS) == 1


def test_persistent_cache_roundtrip(monkeypatch, tmp_path):
    cache = tmp_path / "autotune.json"
    monkeypatch.setenv("PNT_AUTOTUNE_CACHE", str(cache))
    monkeypatch.setenv("PNT_NMFD_AUTOTUNE", "1")
    V, W0, H0 = _problem()
    _fit(V, W0, H0, 1, iters=3)
    saved = json.loads(cache.read_text())
    (key_str, winner), = saved.items()
    assert key_str.startswith("cpu|1|1|") and winner in NAMES
    autotune.clear_cache()
    monkeypatch.setattr(autotune, "_time_candidate", lambda *a, **k: pytest.fail(
        "timed despite a persisted winner"))
    _fit(V, W0, H0, 1, iters=3)


def test_persistent_cache_ignores_foreign_winners(monkeypatch, tmp_path):
    """A winner the port has no candidate of (the JAX package's ``pallas``)
    and another platform's entry are tuned anew."""
    V, W0, H0 = _problem()
    key = ("cpu", 1, 1.0, V.shape, H0.shape)
    cache = tmp_path / "autotune.json"
    cache.write_text(json.dumps({
        autotune._key_str(key): "pallas",
        autotune._key_str(("tpu",) + key[1:]): "unfold"}))
    monkeypatch.setenv("PNT_AUTOTUNE_CACHE", str(cache))
    monkeypatch.setenv("PNT_NMFD_AUTOTUNE", "1")
    _fit(V, W0, H0, 1, iters=3)
    assert autotune._WINNERS[key] in NAMES and autotune._MEASURED[key]
    assert json.loads(cache.read_text())[autotune._key_str(key)] in NAMES


def test_a_candidate_that_raises_is_not_skipped(monkeypatch):
    """A failure while a candidate is timed (on the card: a kernel that does
    not build or launch) propagates; nothing is cached."""
    def broken(beta, gamma, l1_reg, l2_reg):
        upd = fast_nmfd.deconv_updater_factory_unfold(1)(beta, gamma, l1_reg,
                                                         l2_reg)

        def upd_W(V, w, H):
            raise RuntimeError("kernel launch failed")

        return (upd_W,) + tuple(upd[1:])

    monkeypatch.setattr(fast_nmfd, "deconv_updater_factory_fused_w",
                        lambda nd: broken)
    monkeypatch.setenv("PNT_NMFD_AUTOTUNE", "1")
    V, W0, H0 = _problem()
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        _fit(V, W0, H0, 1)
    assert not autotune._WINNERS


def _on_card(shape, dtype=torch.float32):
    """A stand-in for a tensor on the card (there is none here): what the
    candidate sets read."""
    return SimpleNamespace(shape=torch.Size(shape), dtype=dtype,
                           device=torch.device("cuda"))


@pytest.mark.parametrize("beta, nd", [(1.0, 1), (2.0, 1), (0.5, 2), (2.0, 3)])
def test_card_candidates_are_the_kernel_engines(monkeypatch, beta, nd):
    """On a CUDA float32 target only the hand-written kernels' engines are
    timed by default; the library engines come only by a pin."""
    V = _on_card((1, 12) + (40,) * nd)
    H = _on_card((1, 4) + (35,) * nd)
    assert [n for n, _ in autotune._candidates(V, H, beta, nd)] == \
        ["fused", "fused_w"]
    assert [n for n, _ in autotune._recon_candidates(V, H, 1, 2, 3)] == \
        ["fused"]
    monkeypatch.setenv("PNT_NMFD_FFT", "auto")
    want = ["fused", "fused_w"] + (["fft"] if (beta, nd) == (2.0, 1) else [])
    assert [n for n, _ in autotune._candidates(V, H, beta, nd)] == want
    monkeypatch.setenv("PNT_NMFD_FFT", "")
    monkeypatch.setenv("PNT_NMFD_PALLAS", "0")
    monkeypatch.setenv("PNT_NMFD_UNFOLD_MAX_BYTES", str(2**30))
    names = [n for n, _ in autotune._candidates(V, H, beta, nd)]
    assert names[0] == "unfold" and names[-1] == "conv"
    assert "fused" not in names and "fused_w" not in names


@pytest.mark.parametrize("times, want", [
    ({"fused": 1.0, "fused_w": 0.95, "unfold": 0.92}, "fused"),
    ({"fused": 1.0, "fused_w": 0.85, "unfold": 0.92}, "fused_w"),
    ({"fused": 1.0, "fused_w": 1.2, "unfold": 0.5}, "unfold"),
])
def test_a_challenger_must_beat_the_static_choice_by_the_margin(
        monkeypatch, times, want):
    monkeypatch.setattr(autotune, "_time_candidate",
                        lambda run, device, reject_above=None: times[run])
    key = ("cpu", 1, 1.0, (1,), (1,))
    winner = autotune._tune(key, [(n, n) for n in times], lambda x: x, "cpu")
    assert winner == want == autotune._WINNERS[key]
    assert autotune._MEASURED[key] == times


def test_a_lone_candidate_is_kept_untimed():
    key = ("cpu", "plca-em", 0.0, (1,), (1,))

    def make_run(x):
        pytest.fail("a lone candidate was timed")

    assert autotune._tune(key, [("fused", None)], make_run, "cpu") == "fused"
    assert autotune._WINNERS[key] == "fused"


def test_empty_candidate_set_raises():
    with pytest.raises(RuntimeError, match="no engine"):
        autotune._tune(("cpu", 1, 1.0, (1,), (1,)), [], None, "cpu")


def test_time_candidate_rejects_a_slow_pilot():
    calls = []

    def run(n):  # a cost that grows with n, so the long runs outlast the short
        calls.append(n)
        time.sleep(n * 5e-6)

    per = autotune._time_candidate(run, "cpu", reject_above=-1.0)
    assert calls == [1, 4] and per > 0  # warm-up, pilot, no long runs
    calls.clear()
    autotune._time_candidate(run, "cpu", reps=2)
    assert len(calls) == 2 + 4 and calls[2] > calls[4]


def test_conv_macs_per_iter():
    assert autotune._conv_macs_per_iter((1, 1025, 5000), (1, 88, 4601)) == \
        4.0 * 5000 * 400 * 88 * 1025
    assert autotune._conv_macs_per_iter((2, 3, 10, 12), (2, 4, 8, 9)) == \
        4.0 * 2 * 120 * 12 * 4 * 3


def _siplca_problem():
    rs = np.random.RandomState(5)
    V = rs.rand(1, 10, 36).astype("f")
    W0 = rs.rand(10, 3, 5).astype("f") + 0.1
    H0 = rs.rand(1, 3, 32).astype("f") + 0.1
    return V, W0, H0, np.full((3,), 1 / 3, "f")


def test_plca_em_autotune(monkeypatch):
    V, W0, H0, Z0 = _siplca_problem()
    monkeypatch.setenv("PNT_NMFD_AUTOTUNE", "0")
    ref = SIPLCA(W=W0, H=H0, Z=Z0, device="cpu")
    ref.fit(V, tol=float("-inf"), max_iter=8)
    monkeypatch.setenv("PNT_NMFD_AUTOTUNE", "1")
    m = SIPLCA(W=W0, H=H0, Z=Z0, device="cpu")
    m.fit(V, tol=float("-inf"), max_iter=8)
    key = next(k for k in autotune._WINNERS if k[1] == "plca-em")
    assert set(autotune._MEASURED[key]) == {"fused", "unfold", "conv"}
    assert _max_diff(m.W, ref.W) < 5e-6 and _max_diff(m.H, ref.H) < 5e-6


@pytest.mark.parametrize("forced", ["fused", "unfold", "conv"])
def test_plca_em_any_winner(monkeypatch, forced):
    V, W0, H0, Z0 = _siplca_problem()
    ref = SIPLCA(W=W0, H=H0, Z=Z0, device="cpu")
    ref.fit(V, tol=float("-inf"), max_iter=8)
    monkeypatch.setenv("PNT_NMFD_AUTOTUNE", "1")
    monkeypatch.setattr(autotune, "autotune_plca_recon3",
                        lambda *a, **k: forced)
    m = SIPLCA(W=W0, H=H0, Z=Z0, device="cpu")
    m.fit(V, tol=float("-inf"), max_iter=8)
    assert _max_diff(m.W, ref.W) < 5e-6 and _max_diff(m.H, ref.H) < 5e-6


def test_plca_em_switches(monkeypatch):
    V, W0, H0, Z0 = _t(*_siplca_problem())
    monkeypatch.setenv("PNT_NMFD_AUTOTUNE", "1")
    monkeypatch.setenv("PNT_NMFD_UNFOLD", "0")
    assert autotune.resolve_plca_recon3(SIPLCA, V, W0, H0, Z0) is \
        SIPLCA.reconstruct
    monkeypatch.setenv("PNT_NMFD_UNFOLD", "")
    monkeypatch.setenv("PNT_NMFD_PALLAS", "1")
    assert autotune.resolve_plca_recon3(SIPLCA, V, W0, H0, Z0) is \
        fast_nmfd._RECON3[1, "fused"]
    monkeypatch.setenv("PNT_NMFD_PALLAS", "0")
    monkeypatch.setenv("PNT_NMFD_AUTOTUNE", "0")
    assert autotune.resolve_plca_recon3(SIPLCA, V, W0, H0, Z0) is \
        fast_nmfd._RECON3[1, "unfold"]
    assert not autotune._WINNERS


def test_hoyer_recon2_autotune(monkeypatch):
    V, W0, H0, _ = _siplca_problem()
    monkeypatch.setenv("PNT_NMFD_AUTOTUNE", "0")
    ref = NMFD(W=W0, H=H0, device="cpu")
    ref.sparse_fit(V, beta=2, max_iter=6, sH=0.4)
    monkeypatch.setenv("PNT_NMFD_AUTOTUNE", "1")
    m = NMFD(W=W0, H=H0, device="cpu")
    m.sparse_fit(V, beta=2, max_iter=6, sH=0.4)
    key = next(k for k in autotune._WINNERS if k[1] == "hoyer-recon2")
    assert set(autotune._MEASURED[key]) == {"fused", "unfold", "conv"}
    assert _max_diff(m.W, ref.W) < 5e-5 and _max_diff(m.H, ref.H) < 5e-5


@pytest.mark.parametrize("forced", ["fused", "unfold", "conv"])
def test_hoyer_any_winner(monkeypatch, forced):
    V, W0, H0, _ = _siplca_problem()
    ref = NMFD(W=W0, H=H0, device="cpu")
    ref.sparse_fit(V, beta=2, max_iter=6, sH=0.4)
    monkeypatch.setenv("PNT_NMFD_AUTOTUNE", "1")
    monkeypatch.setattr(autotune, "autotune_hoyer_recon2",
                        lambda *a, **k: forced)
    m = NMFD(W=W0, H=H0, device="cpu")
    m.sparse_fit(V, beta=2, max_iter=6, sH=0.4)
    assert _max_diff(m.W, ref.W) < 5e-5 and _max_diff(m.H, ref.H) < 5e-5


def test_nd_models_tune_their_own_rank(monkeypatch):
    monkeypatch.setenv("PNT_NMFD_AUTOTUNE", "1")
    rs = np.random.RandomState(2)
    V = rs.rand(1, 3, 12, 14).astype("f")
    W0 = rs.rand(3, 3, 3, 4).astype("f") + 0.1
    H0 = rs.rand(1, 3, 10, 11).astype("f") + 0.1
    _fit(V, W0, H0, 1, model=NMF2D)
    (key,) = autotune._WINNERS
    assert key[1] == 2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return "cuda"


@pytest.mark.cuda
def test_cuda_autotune_times_the_kernels(cuda, monkeypatch):
    """On the card the kernel engines are timed (and only they), the key
    names the card, and the hybrid launches one B4 an iteration and no
    B3."""
    from pytorch_nmf_tpu_torch.ops import fused_deconv, solver

    monkeypatch.setenv("PNT_NMFD_AUTOTUNE", "1")
    V, W0, H0 = (torch.from_numpy(x).to(cuda) for x in _problem())
    winner = autotune.autotune_winner(V, W0, H0, 1.0, 1, NMFD.reconstruct)
    (key,) = autotune._WINNERS
    assert key[0] == torch.cuda.get_device_name(V.device)
    assert set(autotune._MEASURED[key]) == {"fused", "fused_w"}
    assert winner in autotune._MEASURED[key]
    fused_deconv.hgrad.launches = fused_deconv.wgrad.launches = 0
    solver.get_dense_fit(NMFD.reconstruct, 1.0, float("-inf"), 7, True, True,
                         0.0, 0.0, False,
                         fast_nmfd.deconv_updater_factory_fused_w(1))(V, W0, H0)
    assert (fused_deconv.hgrad.launches, fused_deconv.wgrad.launches) == (0, 7)

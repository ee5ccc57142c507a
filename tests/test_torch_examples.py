"""The port's example scripts (``examples/torch_port/``) on the CPU, held
against the JAX package where the inits can be shared.

The scripts share their basenames with the JAX package's examples, which
``tests/test_examples.py`` imports by name, so they are loaded here by file
path under names of their own.  Tolerances: the audio pipeline's stems
within 1e-4 relative (``max|Δ|/max|ref|``) of the JAX pipeline's after 30
iterations; the other scripts' numbers within 1e-4 relative of the JAX
package's, with the same ``n_iter``; the sharded fit within 1e-5 of the
single-device fit.  The audio separation must gain more than 8 dB SI-SNR,
the bar of ``tests/test_examples.py``.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-4


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port(name):
    return _load(f"examples/torch_port/{name}.py", f"torch_port_{name}")


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side, imported only by the tests that use it."""
    pytest.importorskip("jax")
    from types import SimpleNamespace

    import pytorch_nmf_tpu as pnt
    from pytorch_nmf_tpu import metrics
    from pytorch_nmf_tpu.nmf import NMF, NMFD
    from pytorch_nmf_tpu.trainer import BetaMu

    return SimpleNamespace(pnt=pnt, metrics=metrics, NMF=NMF, NMFD=NMFD,
                           BetaMu=BetaMu)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def test_audio_separation_recovers_sources():
    gain = _port("audio_separation").main(
        device="cpu", sr=8000, duration=2.0, rank=3, T=8, nperseg=256,
        max_iter=200, verbose=False)
    assert gain > 8.0, gain


def test_audio_separation_matches_the_jax_pipeline(jx):
    """``separate`` against STFT → the JAX package's NMFD → Wiener masks →
    ISTFT, from the same inits."""
    from scipy import signal

    ex = _port("audio_separation")
    sources, sr = ex.synth_sources(sr=8000, duration=2.0)
    mix = sources.sum(0)
    nperseg, noverlap, T = 256, 128, 8
    _, _, Z = signal.stft(mix, sr, nperseg=nperseg, noverlap=noverlap)
    S = np.abs(Z).astype("f")[None]
    W0, H0 = ex.init_factors(S.shape, 3, T)

    net = jx.NMFD(W=W0, H=H0)
    ref_n = net.fit(S, beta=1, max_iter=30)
    W, H = np.asarray(net.W.data), np.asarray(net.H.data)
    comps = np.stack([np.asarray(jx.NMFD.reconstruct(H[:, r:r + 1],
                                                     W[:, r:r + 1]))[0]
                      for r in range(3)])
    power = comps ** 2
    denom = power.sum(0) + 1e-12
    ref = np.stack([
        signal.istft((power[r] / denom) * Z, sr, nperseg=nperseg,
                     noverlap=noverlap)[1][:len(mix)].astype("f")
        for r in range(3)])

    stems, got_comps, n = ex.separate(mix, sr, rank=3, T=T, nperseg=nperseg,
                                      max_iter=30, device="cpu", W0=W0, H0=H0)
    assert n == ref_n
    assert _rel(got_comps, comps) < RTOL
    assert _rel(stems, ref) < RTOL


def test_spectrogram_nmfd_matches_jax(jx):
    ex = _port("spectrogram_nmfd")
    got = ex.main(device="cpu", verbose=False)
    V = ex.synth_spectrogram()
    # the JAX example's target, synthesized through its own NMFD
    jax_ex = _load("examples/spectrogram_nmfd.py", "jax_spectrogram_nmfd")
    np.testing.assert_allclose(V, jax_ex.synth_spectrogram(), rtol=1e-5,
                               atol=1e-6)
    W0, H0 = ex.init_factors(V.shape, rank=3, T=40)
    ref = jx.NMFD(W=W0, H=H0)
    n = ref.fit(V, beta=1, tol=1e-6, max_iter=200)
    kl = float(jx.metrics.kl_div(ref(), V))
    assert np.isfinite(got["kl"])
    assert got["n_iter"] == n
    assert abs(got["kl"] - kl) / kl < RTOL


def _jax_basic_tutorial(jx):
    """The port's tutorial, section by section, through the JAX package
    from the same draws of numpy seed 0."""
    beta_div, sparseness = jx.metrics.beta_div, jx.metrics.sparseness
    rng = np.random.RandomState(0)

    def model(M, K, R, **kw):
        W = np.abs(rng.randn(K, R)).astype("f")
        return jx.NMF(W=W, H=np.abs(rng.randn(M, R)).astype("f"), **kw)

    out = {}
    V = rng.rand(100, 50).astype("f")
    net = model(*V.shape, 8)
    out["n_iter"] = net.fit(V, beta=1)
    out["kl"] = float(beta_div(net(), V, 1))
    for beta in [0, 1, 2]:
        m = model(*V.shape, 8)
        m.fit(V + 0.01, beta=beta, max_iter=100)
        out[f"beta{beta}"] = float(beta_div(m(), V + 0.01, beta))
    rng.randn(50, 8)  # the port draws W as well, then keeps the templates
    m = jx.NMF(W=net.W.data, H=np.abs(rng.randn(100, 8)).astype("f"),
               trainable_W=False)
    m.fit(V, beta=1)
    out["frozen_kl"] = float(beta_div(m(), V, 1))
    dense = np.where(V > 0.9, V, 0).astype("f")
    m = model(*V.shape, 8)
    m.fit(jx.pnt.sparse_from_dense(dense), beta=1)
    out["sparse_kl"] = float(beta_div(m(), dense, 1))
    m = model(*V.shape, 8)
    m.sparse_fit(V, beta=2, sW=0.6, max_iter=50)
    out["sparseness"] = float(sparseness(m.W.data[:, 0]))
    return out


def test_basic_tutorial_matches_jax(jx):
    got = _port("basic_tutorial").main(device="cpu")
    ref = _jax_basic_tutorial(jx)
    assert got.keys() == ref.keys()
    assert got["n_iter"] == ref["n_iter"]
    for key, value in got.items():
        assert np.isfinite(value), key
        assert abs(value - ref[key]) / abs(ref[key]) < RTOL, (key, value,
                                                              ref[key])


def test_source_filter_model_matches_jax(jx):
    ex = _port("source_filter_model")
    got = ex.main(device="cpu")
    target, W_e, H_e, W_f, H_f = ex.problem()
    jax_ex = _load("examples/source_filter_model.py", "jax_source_filter_model")
    model = jax_ex.SourceFilter(W_e.shape[0], H_e.shape[0], W_e, W_f.shape[1])
    model.excitation.H.data = H_e
    model.filter.W.data = W_f
    model.filter.H.data = H_f
    trainer = jx.BetaMu(model.parameters(), beta=1)

    def closure():
        trainer.zero_grad()
        return target, model()

    ref = {}
    for step in range(30):
        trainer.step(closure)
        if step % 10 == 9:
            ref[f"kl_step{step + 1}"] = float(
                jx.metrics.beta_div(model(), target, 1))
    assert got.keys() == ref.keys()
    for key, value in got.items():
        assert np.isfinite(value), key
        assert abs(value - ref[key]) / ref[key] < RTOL, (key, value, ref[key])


def test_multi_device_fit_matches_the_single_device_fit():
    got = _port("multi_device_fit").main(device="cpu", world=2, verbose=False)
    assert got["max_rel_delta"] <= 1e-5, got
    # the model API on DTensor targets: the routed NMF fit is the sharded
    # fit, the routed NMFD fit the halo fit, bit for bit
    assert got["max_rel_delta_model"] == got["max_rel_delta"], got
    assert got["max_rel_delta_halo_route"] == 0, got
    for key, value in got.items():
        assert np.isfinite(value), key
    assert 0 < got["n_iter"] <= 200 and got["n_iter_halo"] > 0

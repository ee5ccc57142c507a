"""The whole slice: the port's ``NMFD``/``NMF2D``/``NMF3D.fit`` against the
JAX package's, from the same numpy target and inits.

The JAX package fits on the CPU with its unfold engine (these shapes are
below its autotuner's threshold); the port runs its kernel engine over the
plain versions of B3/B4.  Tolerance: after 12 iterations at ``tol=0``,
``max|Δ|/max|ref| < 5e-5`` for W and H, the bound that
``tests/test_pallas.py::test_nmfd_pallas_engine_matches_stream`` holds the
JAX package's own fused engine to (float32 reordering of the same sums).
The JAX models get explicit ``W=``/``H=``, so they draw nothing from the
JAX package's global key chain.
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pytorch_nmf_tpu.models import nmf as jnmf  # noqa: E402
from pytorch_nmf_tpu.ops import recon as jrecon  # noqa: E402
from pytorch_nmf_tpu_torch.nmf import NMF2D, NMF3D, NMFD  # noqa: E402
from pytorch_nmf_tpu_torch.ops import fast_nmfd, fused_deconv, solver  # noqa: E402
from pytorch_nmf_tpu_torch.utils import nmf_from_numpy  # noqa: E402

RTOL_FIT = 5e-5

# model → (N, C, S_in, kernel, R)
PROBLEMS = {
    "NMFD": (1, 20, (389,), (12,), 6),
    "NMF2D": (1, 6, (12, 14), (3, 4), 3),
    "NMF3D": (1, 4, (5, 6, 4), (2, 3, 2), 2),
}
JAX_MODELS = {"NMFD": jnmf.NMFD, "NMF2D": jnmf.NMF2D, "NMF3D": jnmf.NMF3D}


def _problem(N, C, s_in, kernel, R, seed=0):
    rs = np.random.RandomState(seed)
    s_out = tuple(s + k - 1 for s, k in zip(s_in, kernel))
    V = rs.rand(N, C, *s_out).astype("f") + 0.01
    W0 = rs.rand(C, R, *kernel).astype("f") + 0.1
    H0 = rs.rand(N, R, *s_in).astype("f") + 0.1
    return V, W0, H0


def _rel(got, ref):
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(got) - ref).max() / np.abs(ref).max())


def _fit_both(name, V, W0, H0, **fit_kw):
    ref = JAX_MODELS[name](W=W0, H=H0)
    ref_n = ref.fit(V, **fit_kw)
    port = nmf_from_numpy({"W": W0, "H": H0}, "cpu")
    assert type(port).__name__ == name
    port_n = port.fit(torch.from_numpy(V), **fit_kw)
    return port, port_n, ref, ref_n


def _assert_factors(port, ref):
    assert _rel(port.W.detach().numpy(), ref.W.data) < RTOL_FIT
    assert _rel(port.H.detach().numpy(), ref.H.data) < RTOL_FIT


@pytest.mark.parametrize("N", [1, 2])
@pytest.mark.parametrize("beta", [1, 2, 0.5])
def test_nmfd_fit_matches_jax(beta, N):
    _, C, s_in, kernel, R = PROBLEMS["NMFD"]
    V, W0, H0 = _problem(N, C, s_in, kernel, R)
    port, port_n, ref, ref_n = _fit_both("NMFD", V, W0, H0, beta=beta, tol=0,
                                         max_iter=12)
    assert port_n == ref_n == 12
    _assert_factors(port, ref)


@pytest.mark.parametrize("name", ["NMF2D", "NMF3D"])
@pytest.mark.parametrize("beta", [1, 0.5])
def test_nd_fit_matches_jax(name, beta):
    V, W0, H0 = _problem(*PROBLEMS[name], seed=1)
    port, port_n, ref, ref_n = _fit_both(name, V, W0, H0, beta=beta, tol=0,
                                         max_iter=12)
    assert port_n == ref_n == 12
    _assert_factors(port, ref)


def test_nmf2d_batched_fit_matches_jax():
    _, C, s_in, kernel, R = PROBLEMS["NMF2D"]
    V, W0, H0 = _problem(2, C, s_in, kernel, R, seed=2)
    port, _, ref, _ = _fit_both("NMF2D", V, W0, H0, beta=1, tol=0, max_iter=12)
    _assert_factors(port, ref)


def test_tol_fit_stops_at_the_same_iteration():
    V, W0, H0 = _problem(*PROBLEMS["NMFD"], seed=3)
    port, port_n, ref, ref_n = _fit_both("NMFD", V, W0, H0, beta=1, tol=1e-4,
                                         max_iter=200)
    assert port_n == ref_n < 200
    assert _rel(port.W.detach().numpy(), ref.W.data) < 10 * RTOL_FIT


def test_constructor_shape_inference():
    m = NMFD((2, 20, 100), 5, T=7, device="cpu",
             generator=torch.Generator().manual_seed(0))
    assert m.W.shape == (20, 5, 7) and m.H.shape == (2, 5, 94)
    assert m.kernel_size == (7,) and m.out_channels == 20 and m.rank == 5
    assert m().shape == (2, 20, 100)
    m2 = NMF2D((1, 6, 12, 14), 3, kernel_size=(3, 4), device="cpu",
               generator=torch.Generator())
    assert m2.W.shape == (6, 3, 3, 4) and m2.H.shape == (1, 3, 10, 11)
    assert NMF2D((1, 6, 12, 14), 3, kernel_size=3,
                 device="cpu").W.shape == (6, 3, 3, 3)
    m3 = NMF3D((1, 4, 9, 8, 7), 2, kernel_size=(2, 3, 4), device="cpu")
    assert m3.W.shape == (4, 2, 2, 3, 4) and m3.H.shape == (1, 2, 8, 6, 4)
    assert NMFD((1, 20, 100), T=7, device="cpu").rank == 20
    for model in (NMFD, NMF2D, NMF3D):  # the JAX package's argument names
        names = model.__init__.__code__.co_varnames[:4]
        assert names == JAX_MODELS[model.__name__].__init__.__code__.co_varnames[:4]
    with pytest.raises(ValueError):
        NMF2D((1, 6, 12, 14), 3, kernel_size=(3, 4, 5), device="cpu")


@pytest.mark.parametrize("beta", [0, -0.5])
def test_zeros_with_nonpositive_beta_raise(beta):
    V, W0, H0 = _problem(*PROBLEMS["NMFD"])
    V[0, 0, 0] = 0.0
    with pytest.raises(ValueError, match="beta <= 0"):
        nmf_from_numpy({"W": W0, "H": H0}, "cpu").fit(torch.from_numpy(V),
                                                       beta=beta)
    with pytest.raises(ValueError, match="beta <= 0"):
        jnmf.NMFD(W=W0, H=H0).fit(V, beta=beta)


@pytest.mark.parametrize("name", ["NMFD", "NMF2D", "NMF3D"])
def test_float64_generic_engine_matches_float32(name):
    """The float64 route (the generic autograd engine over ``deconvNd``) and
    the float32 kernel engine are the same update."""
    V, W0, H0 = _problem(*PROBLEMS[name], seed=4)
    m32 = nmf_from_numpy({"W": W0, "H": H0}, "cpu")
    m64 = nmf_from_numpy({"W": W0.astype("f8"), "H": H0.astype("f8")}, "cpu")
    m32.fit(torch.from_numpy(V), beta=0.5, tol=0, max_iter=10)
    m64.fit(torch.from_numpy(V.astype("f8")), beta=0.5, tol=0, max_iter=10)
    assert m64.W.dtype == m64.H.dtype == torch.float64
    assert _rel(m32.W.detach().numpy(), m64.W.detach().numpy()) < RTOL_FIT
    assert _rel(m32.H.detach().numpy(), m64.H.detach().numpy()) < RTOL_FIT


@pytest.mark.parametrize("name", ["NMFD", "NMF2D", "NMF3D"])
def test_forward_and_carry_over_match_jax_recon(name):
    """``forward()`` is JAX ``recon.deconvNd``; the carried-over weights give
    the same reconstruction in both packages."""
    N, C, s_in, kernel, R = PROBLEMS[name]
    V, W0, H0 = _problem(2, C, s_in, kernel, R, seed=5)
    ref = JAX_MODELS[name](W=W0, H=H0)
    port = nmf_from_numpy({"W": np.asarray(ref.W.data),
                           "H": np.asarray(ref.H.data)}, "cpu")
    deconv = getattr(jrecon, f"deconv{len(kernel)}d")
    want = np.asarray(deconv(ref.H.data, ref.W.data))
    got = port().detach().numpy()
    assert got.shape == V.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_carry_over_rejects_other_shapes():
    with pytest.raises(ValueError, match="1-D W"):
        nmf_from_numpy({"W": np.ones(3, "f"), "H": np.ones((2, 3), "f")}, "cpu")


def test_stream_recon_matches_forward():
    for name in ("NMFD", "NMF2D", "NMF3D"):
        V, W0, H0 = _problem(*PROBLEMS[name], seed=6)
        m = nmf_from_numpy({"W": W0, "H": H0}, "cpu")
        kernel = W0.shape[2:]
        WH2 = fast_nmfd._stream_recon(fast_nmfd._w2(m.W.detach()),
                                      m.H.detach(), kernel)
        want = fast_nmfd._v2_flat(m().detach())
        torch.testing.assert_close(WH2, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize(
    "device, dtype, want",
    [("cpu", torch.float32, "plain"), ("cuda", torch.float32, "fused"),
     ("cpu", torch.float64, None), ("cuda", torch.float64, None)],
)
@pytest.mark.parametrize("nd", [1, 2, 3])
def test_factory_resolution(device, dtype, want, nd, monkeypatch):
    for name in ("PNT_NMFD_AUTOTUNE", "PNT_NMFD_PALLAS", "PNT_NMFD_UNFOLD"):
        monkeypatch.delenv(name, raising=False)
    got = fast_nmfd.resolve_nmfd_updater_factory(device, dtype, nd)
    if want is None:
        assert got is None
    else:
        assert got is getattr(fast_nmfd, f"deconv_updater_factory_{want}")(nd)
    # the resolver the fit calls, at a shape below the tuning threshold (a
    # stand-in target: it reads only the shape, dtype and device)
    model = {1: NMFD, 2: NMF2D, 3: NMF3D}[nd]
    V, H = (SimpleNamespace(shape=torch.Size(shape), dtype=dtype,
                            device=torch.device(device))
            for shape in ((1, 4) + (8,) * nd, (1, 2) + (6,) * nd))
    assert model._resolve_updater_factory(V, None, H, 1.0) is got


def test_cpu_fit_never_launches():
    V, W0, H0 = _problem(*PROBLEMS["NMFD"])
    before = (fused_deconv.hgrad.launches, fused_deconv.wgrad.launches)
    nmf_from_numpy({"W": W0, "H": H0}, "cpu").fit(torch.from_numpy(V),
                                                   beta=1, tol=0, max_iter=3)
    assert (fused_deconv.hgrad.launches, fused_deconv.wgrad.launches) == before


def test_fused_and_plain_factories_agree_on_cpu():
    """On CPU tensors the wrappers run their plain versions, so the two
    factories give the same fit bit for bit."""
    V, W0, H0 = (torch.from_numpy(x) for x in _problem(*PROBLEMS["NMFD"]))
    out = [
        solver.get_dense_fit(NMFD.reconstruct, 0.5, 0.0, 5, True, True, 0.0,
                             0.0, False, factory(1))(V, W0, H0)
        for factory in (fast_nmfd.deconv_updater_factory_fused,
                        fast_nmfd.deconv_updater_factory_plain)
    ]
    for a, b in zip(out[0][:2], out[1][:2]):
        assert torch.equal(a, b)


def test_wrong_rank_target_raises():
    V, W0, H0 = _problem(*PROBLEMS["NMFD"])
    m = nmf_from_numpy({"W": W0, "H": H0}, "cpu")
    with pytest.raises(ValueError):
        m.fit(torch.from_numpy(V[0]))


# --------------------------------------------------------------------------
# The engines beside the kernel engine, each against the JAX package's
# counterpart from the same inputs and inits (run eagerly in both packages:
# prepare, ENGINE_ITERS W-then-H updates, finish), within RTOL_FIT
# --------------------------------------------------------------------------
from pytorch_nmf_tpu.ops import fast_nmfd as jfast  # noqa: E402
from pytorch_nmf_tpu.ops import fft_nmfd as jfft  # noqa: E402
from pytorch_nmf_tpu.ops.mu import gamma_from_beta  # noqa: E402
from pytorch_nmf_tpu_torch.ops import fft_nmfd  # noqa: E402

ENGINE_ITERS = 6


def _run(updaters, V, W, H, iters=ENGINE_ITERS):
    upd_W, upd_H, _, prepare, finish = (tuple(updaters) + (None,) * 5)[:5]
    w, h = (W, H) if prepare is None else prepare(V, W, H)
    for _ in range(iters):
        w = upd_W(V, w, h)
        h = upd_H(V, w, h)
    return (w, h) if finish is None else finish(V, w, h)


def _port_run(factory, V, W0, H0, beta, iters=ENGINE_ITERS):
    with torch.no_grad():
        return _run(factory(beta, gamma_from_beta(beta), 0.0, 0.0),
                    *(torch.from_numpy(x) for x in (V, W0, H0)), iters)


def _jax_run(updaters, V, W0, H0, iters=ENGINE_ITERS):
    """The JAX updaters' fit, compiled afresh (a new function each call, so
    no compiled program outlives a test's chunk-size setting)."""
    import jax
    import jax.numpy as jnp

    upd_W, upd_H, _, prepare, finish = (tuple(updaters) + (None,) * 5)[:5]

    def fit(V, W, H):
        state = (W, H) if prepare is None else prepare(V, W, H)

        def body(_, s):
            w = upd_W(V, *s)
            return w, upd_H(V, w, s[1])

        w, h = jax.lax.fori_loop(0, iters, body, state)
        return (w, h) if finish is None else finish(V, w, h)

    return jax.jit(fit)(*(jnp.asarray(x) for x in (V, W0, H0)))


def _assert_close(port, ref):
    for p, r in zip(port, ref):
        assert _rel(p.numpy(), r) < RTOL_FIT


@pytest.fixture
def small_chunks(monkeypatch):
    """The τ-chunked ("stream") regime at test sizes: at most 16 patch
    columns unrolled, in both packages."""
    monkeypatch.setattr(jfast, "_CHUNK_COLS", 16)
    monkeypatch.setattr(fast_nmfd, "_CHUNK_COLS", 16)
    monkeypatch.setattr(fused_deconv, "_CHUNK_COLS", 16)


def _engine_problem(nd, N, seed=11):
    _, C, s_in, kernel, R = PROBLEMS[{1: "NMFD", 2: "NMF2D", 3: "NMF3D"}[nd]]
    return _problem(N, C, s_in, kernel, R, seed=seed)


@pytest.mark.parametrize("mode", ["unrolled", "stream"])
@pytest.mark.parametrize("N", [1, 2])
@pytest.mark.parametrize("nd", [1, 2, 3])
def test_unfold_engine_matches_jax(request, nd, N, mode):
    if mode == "stream":
        request.getfixturevalue("small_chunks")
    V, W0, H0 = _engine_problem(nd, N)
    kernel = W0.shape[2:]
    assert fast_nmfd._unfold_mode(V.shape, H0.shape, torch.float32, "cpu") == mode
    port = _port_run(fast_nmfd.deconv_updater_factory_unfold(nd), V, W0, H0, 0.5)
    ref = _jax_run(jfast._deconv_unfold_updater_factory(
        nd, 0.5, gamma_from_beta(0.5), 0.0, 0.0), V, W0, H0)
    assert tuple(port[0].shape) == W0.shape and len(kernel) == nd
    _assert_close(port, ref)


@pytest.mark.parametrize("beta", [1, 2, 0])
def test_unfold_engine_betas_match_jax(small_chunks, beta):
    V, W0, H0 = _engine_problem(1, 1, seed=12)
    port = _port_run(fast_nmfd.nmfd_unfold_updater_factory, V, W0, H0, beta)
    ref = _jax_run(jfast.nmfd_unfold_updater_factory(
        beta, gamma_from_beta(beta), 0.0, 0.0), V, W0, H0)
    _assert_close(port, ref)


def test_unfold_engine_over_budget_takes_the_generic_engine(monkeypatch):
    V, W0, H0 = _engine_problem(1, 1, seed=13)
    assert fast_nmfd.nmfd_unfold_supported(V.shape, W0.shape)
    assert not fast_nmfd.nmfd_unfold_supported(V.shape, W0.shape[:2] + (1,))
    monkeypatch.setenv("PNT_NMFD_UNFOLD_MAX_BYTES", "16")
    assert not fast_nmfd.nmfd_unfold_supported(V.shape, W0.shape)
    port = _port_run(fast_nmfd.nmfd_unfold_updater_factory, V, W0, H0, 1)
    ref = solver.get_dense_fit(NMFD.reconstruct, 1.0, float("-inf"),
                               ENGINE_ITERS, True, True, 0.0, 0.0)(
        *(torch.from_numpy(x) for x in (V, W0, H0)))
    for p, r in zip(port, ref):
        assert _rel(p.numpy(), r.numpy()) < RTOL_FIT


@pytest.mark.parametrize("mode", ["unrolled", "stream"])
@pytest.mark.parametrize("nd", [1, 2, 3])
def test_unfold_deconv_matches_jax(request, nd, mode):
    """Values and both adjoints of ``unfold_deconv`` (autograd against
    ``jax.vjp``)."""
    import jax
    import jax.numpy as jnp

    if mode == "stream":
        request.getfixturevalue("small_chunks")
    V, W0, H0 = _engine_problem(nd, 2, seed=14)
    ct = np.random.RandomState(15).rand(*V.shape).astype("f")
    H = torch.from_numpy(H0).requires_grad_(True)
    W = torch.from_numpy(W0).requires_grad_(True)
    out = fast_nmfd.unfold_deconv(H, W)
    gH, gW = torch.autograd.grad(out, (H, W), torch.from_numpy(ct))
    jout, vjp = jax.vjp(jfast.unfold_deconv, jnp.asarray(H0), jnp.asarray(W0))
    jgH, jgW = vjp(jnp.asarray(ct))
    assert _rel(out.detach().numpy(), jout) < 1e-5
    assert _rel(gH.numpy(), jgH) < 1e-5 and _rel(gW.numpy(), jgW) < 1e-5
    want = getattr(jrecon, f"deconv{nd}d")(jnp.asarray(H0), jnp.asarray(W0))
    assert _rel(out.detach().numpy(), want) < 1e-5


def test_unfold_deconv_falls_back_to_the_convolution(monkeypatch):
    _, W0, H0 = _engine_problem(1, 1, seed=16)
    H, W = torch.from_numpy(H0).double(), torch.from_numpy(W0).double()
    assert torch.equal(fast_nmfd.unfold_deconv(H, W), NMFD.reconstruct(H, W))
    monkeypatch.setenv("PNT_NMFD_UNFOLD_MAX_BYTES", "16")
    H, W = H.float(), W.float()
    assert torch.equal(fast_nmfd.unfold_deconv(H, W), NMFD.reconstruct(H, W))


def test_autocorr_gram_matches_the_patch_gram():
    _, W0, H0 = _engine_problem(1, 2, seed=17)
    H = torch.from_numpy(H0)
    T = W0.shape[2]
    P = fast_nmfd.unfold_patches_nd(H, (T,)).reshape(-1, T * H.shape[1])
    torch.testing.assert_close(fast_nmfd._h_autocorr_gram(H, T), P.T @ P,
                               rtol=3e-5, atol=1e-5)
    import jax.numpy as jnp

    assert _rel(fast_nmfd._h_autocorr_gram(H, T).numpy(),
                jfast._h_autocorr_gram(jnp.asarray(H0), T)) < 1e-5


@pytest.mark.parametrize("N", [1, 2])
def test_autocorr_engine_matches_jax(N):
    V, W0, H0 = _engine_problem(1, N, seed=18)
    port = _port_run(fast_nmfd.nmfd_autocorr_updater_factory, V, W0, H0, 2)
    ref = _jax_run(jfast.nmfd_autocorr_updater_factory(2, 1.0, 0.0, 0.0),
                   V, W0, H0)
    _assert_close(port, ref)


def test_autocorr_refuses_other_configurations(small_chunks):
    with pytest.raises(ValueError, match="β=2"):
        fast_nmfd.nmfd_autocorr_updater_factory(1, 1.0, 0.0, 0.0)
    upd_W = fast_nmfd.nmfd_autocorr_updater_factory(2, 1.0, 0.0, 0.0)[0]
    V, W0, H0 = _engine_problem(1, 1, seed=19)  # K·R = 72 > 16: stream
    V, W0, H0 = (torch.from_numpy(x) for x in (V, W0, H0))
    with pytest.raises(ValueError, match="unrolled"):
        upd_W(V, fast_nmfd._w2(W0), H0)
    with pytest.raises(ValueError, match="unrolled"):
        upd_W(V.double(), fast_nmfd._w2(W0).double(), H0.double())
    V2, W2, H2 = (torch.from_numpy(x) for x in _engine_problem(2, 1, seed=19))
    with pytest.raises(ValueError, match="1-D"):
        upd_W(V2, fast_nmfd._w2(W2), H2)
    assert not fast_nmfd.autocorr_supported(V2.shape, H2.shape, torch.float32)


@pytest.mark.parametrize("N", [1, 2])
def test_fft_engine_matches_jax(N):
    V, W0, H0 = _engine_problem(1, N, seed=20)
    port = _port_run(fast_nmfd.nmfd_fft_updater_factory, V, W0, H0, 2)
    ref = _jax_run(jfft.fft_beta2_updater_factory(1.0, 0.0, 0.0), V, W0, H0)
    _assert_close(port, ref)


def test_fft_engine_chunks_channels(monkeypatch):
    """A chunk of one channel gives the same update as the whole spectrum,
    and the other β take the unfold engine."""
    V, W0, H0 = _engine_problem(1, 2, seed=21)
    whole = _port_run(fast_nmfd.nmfd_fft_updater_factory, V, W0, H0, 2)
    monkeypatch.setenv("PNT_FFT_CHUNK_MB", "0")
    assert fft_nmfd._c_chunk(20, 6, 257) == 1
    chunked = _port_run(fast_nmfd.nmfd_fft_updater_factory, V, W0, H0, 2)
    for a, b in zip(whole, chunked):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
    assert len(fast_nmfd.nmfd_fft_updater_factory(1, 1.0, 0.0, 0.0)) == 5


@pytest.mark.parametrize("beta", [1, 0.5])
@pytest.mark.parametrize("N", [1, 2])
@pytest.mark.parametrize("nd", [1, 2])
def test_fused_w_engine_matches_jax_unfold(nd, N, beta):
    """The hybrid (B4's plain version on the CPU, and the streamed fold)
    computes the unfold engine's update."""
    V, W0, H0 = _engine_problem(nd, N, seed=22)
    port = _port_run(fast_nmfd.deconv_updater_factory_fused_w(nd), V, W0, H0,
                     beta)
    ref = _jax_run(jfast._deconv_unfold_updater_factory(
        nd, beta, gamma_from_beta(beta), 0.0, 0.0), V, W0, H0)
    _assert_close(port, ref)


def test_fused_w_engine_never_calls_hgrad(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("hgrad called")

    monkeypatch.setattr(fused_deconv, "hgrad", refuse)
    V, W0, H0 = _engine_problem(1, 1, seed=23)
    _port_run(fast_nmfd.deconv_updater_factory_fused_w(1), V, W0, H0, 0.5)
    with pytest.raises(AssertionError, match="hgrad called"):
        _port_run(fast_nmfd.deconv_updater_factory_fused(1), V, W0, H0, 0.5)

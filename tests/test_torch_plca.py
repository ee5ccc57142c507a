"""The PLCA slice: the port's ``PLCA``/``SIPLCA``/``SIPLCA2``/``SIPLCA3``
against the JAX package's, from the same numpy data and inits.

The JAX models get explicit ``W=``/``H=``/``Z=`` and fit on the CPU (the
SIPLCA shapes here stay below the JAX autotuner's threshold, so its E-step
differentiates the unfold reconstruction); the port's SIPLCA E-step runs
its kernel-adjoint deconvolution over the plain versions of B3/B4.
Tolerance: after 12 EM iterations at ``tol=0``, ``max|Δ|/max|ref| < 5e-5``
for W, H and Z (float32 reordering of the same sums), and the same
``n_iter`` and ``norm``.

CUDA tests (marked ``cuda``, skipped without a card) hold the kernel path
against the plain one on the card:
``python -m pytest --noconftest -m cuda tests/test_torch_plca.py``.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pytorch_nmf_tpu_torch.ops import fast_nmfd, fast_plca, fused_deconv, fused_mu
from pytorch_nmf_tpu_torch.ops import recon, solver
from pytorch_nmf_tpu_torch.plca import PLCA, SIPLCA, SIPLCA2, SIPLCA3, BaseComponent
from pytorch_nmf_tpu_torch.utils import plca_from_numpy

RTOL_FIT = 5e-5
# model → (N, C, S_in, kernel, R); PLCA: (M, K, R)
PROBLEMS = {
    "SIPLCA": (1, 16, (150,), (9,), 4),
    "SIPLCA2": (1, 5, (10, 12), (3, 4), 3),
    "SIPLCA3": (1, 3, (5, 6, 4), (2, 3, 2), 2),
}


@pytest.fixture(scope="module")
def jx():
    """The JAX package's PLCA models and reconstructions, imported only by
    the tests that compare with it: the CUDA tests need no JAX."""
    pytest.importorskip("jax")
    from pytorch_nmf_tpu.models import plca
    from pytorch_nmf_tpu.ops import recon

    return SimpleNamespace(recon=recon, BaseComponent=plca.BaseComponent,
                           models={name: getattr(plca, name) for name in
                                   ("PLCA", "SIPLCA", "SIPLCA2", "SIPLCA3")})


def _rel(got, ref):
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(got) - ref).max() / np.abs(ref).max())


def _plca_problem(M=40, K=30, R=5, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.rand(M, K).astype("f"), rs.rand(K, R).astype("f"),
            rs.rand(M, R).astype("f"), rs.rand(R).astype("f") + 0.1)


def _si_problem(N, C, s_in, kernel, R, seed=0):
    rs = np.random.RandomState(seed)
    s_out = tuple(s + k - 1 for s, k in zip(s_in, kernel))
    return (rs.rand(N, C, *s_out).astype("f") + 0.01,
            rs.rand(C, R, *kernel).astype("f") + 0.1,
            rs.rand(N, R, *s_in).astype("f") + 0.1,
            rs.rand(R).astype("f") + 0.1)


def _fit_both(jx, name, V, W0, H0, Z0, trainable=(True, True, True), **fit_kw):
    tw, th, tz = trainable
    ref = jx.models[name](W=W0, H=H0, Z=Z0, trainable_W=tw, trainable_H=th,
                           trainable_Z=tz)
    ref_out = ref.fit(V, **fit_kw)
    port = plca_from_numpy({"W": W0, "H": H0, "Z": Z0}, "cpu", tw, th, tz)
    assert type(port).__name__ == name
    port_out = port.fit(torch.from_numpy(V), **fit_kw)
    return port, port_out, ref, ref_out


def _assert_factors(port, ref, tol=RTOL_FIT):
    for name in ("W", "H", "Z"):
        got = getattr(port, name).detach().numpy()
        assert _rel(got, getattr(ref, name).data) < tol, name


def _assert_simplex(p, keep=1):
    x = p.detach()
    axes = tuple(d for d in range(x.ndim) if d != keep)
    sums = x.sum(dim=axes) if axes else x.sum()
    torch.testing.assert_close(sums, torch.ones_like(sums), atol=1e-5, rtol=0)


RNG = np.random.RandomState(7)
VALID = [
    (8, (50, 8), (100, 8), None),
    (None, RNG.rand(50, 8).astype("f"), (100, 8), RNG.rand(8).astype("f")),
    (8, None, RNG.rand(100, 8).astype("f"), None),
    (None, None, None, RNG.rand(8).astype("f")),
    (8, None, None, None),
]


@pytest.mark.parametrize("rank, W, H, Z", VALID)
def test_construct_normalizes_like_jax(jx, rank, W, H, Z):
    port = BaseComponent(rank, W, H, Z, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    ref = jx.BaseComponent(rank, W, H, Z)
    assert port.rank == ref.rank
    for name in ("W", "H", "Z"):
        p, r = getattr(port, name), ref._parameters.get(name)
        assert (p is None) == (r is None)
        if p is not None:
            _assert_simplex(p, 1 if p.ndim > 1 else 0)
            given = {"W": W, "H": H, "Z": Z}[name]
            if given is not None and not isinstance(given, tuple):
                np.testing.assert_allclose(p.detach().numpy(),
                                           np.asarray(r.data), rtol=1e-6)
            elif name == "Z":  # uniform from the rank
                np.testing.assert_allclose(p.detach().numpy(),
                                           np.asarray(r.data), rtol=1e-6)


@pytest.mark.parametrize(
    "rank, W, H, Z",
    [
        (None, None, None, None),
        (7, (50, 8), (100, 10), None),
        (None, RNG.rand(50, 8).astype("f"), (100, 10), RNG.rand(7).astype("f")),
        (None, RNG.randn(50, 8).astype("f"), (100, 8), RNG.rand(8).astype("f")),
        (None, RNG.rand(50, 8).astype("f"), (100, 8), RNG.randn(8).astype("f")),
        (None, (50, 8), RNG.rand(100, 10).astype("f"), RNG.rand(10).astype("f")),
        (8, (50, 8), RNG.randn(100, 8).astype("f"), None),
        (None, RNG.rand(50, 8).astype("f"), RNG.rand(100, 10).astype("f"),
         RNG.rand(7).astype("f")),
        (None, None, None, RNG.rand(2, 4).astype("f")),
    ],
)
def test_invalid_construct_raises_as_jax(jx, rank, W, H, Z):
    with pytest.raises(ValueError):
        BaseComponent(rank, W, H, Z, device="cpu")
    with pytest.raises(Exception):
        jx.BaseComponent(rank, W, H, Z)


def test_model_construction_and_forward(jx):
    g = torch.Generator().manual_seed(0)
    m = PLCA((30, 20), 4, device="cpu", generator=g)
    assert m.W.shape == (20, 4) and m.H.shape == (30, 4) and m.Z.shape == (4,)
    y = m()
    assert y.shape == (30, 20) and abs(float(y.sum()) - 1) < 1e-5
    assert torch.allclose(m(norm=3.0), 3 * y)
    s = SIPLCA((2, 10, 40), 3, T=5, device="cpu", generator=g)
    assert s.W.shape == (10, 3, 5) and s.H.shape == (2, 3, 36)
    assert abs(float(s().sum()) - 1) < 1e-4
    s2 = SIPLCA2((1, 4, 12, 14), 3, kernel_size=(3, 4), device="cpu", generator=g)
    assert s2().shape == (1, 4, 12, 14) and s2.kernel_size == (3, 4)
    s3 = SIPLCA3((1, 2, 6, 7, 8), 2, kernel_size=2, device="cpu", generator=g)
    assert s3().shape == (1, 2, 6, 7, 8)
    for model in (PLCA, SIPLCA, SIPLCA2, SIPLCA3):  # the JAX argument names
        names = model.__init__.__code__.co_varnames[:4]
        want = jx.models[model.__name__].__init__.__code__.co_varnames[:4]
        assert names == want
    with pytest.raises(ValueError):
        PLCA((100, 50, 50), device="cpu")


@pytest.mark.parametrize("alphas", [(1, 1, 1), (0.999, 0.999, 0.999)])
@pytest.mark.parametrize(
    "trainable",
    [(True, True, True), (False, True, True), (True, False, True),
     (True, True, False), (False, False, True), (True, False, False),
     (False, True, False)],
)
def test_plca_fit_matches_jax(jx, alphas, trainable):
    V, W0, H0, Z0 = _plca_problem(seed=1)
    W_alpha, H_alpha, Z_alpha = alphas
    port, (pn, pnorm), ref, (rn, rnorm) = _fit_both(
        jx, "PLCA", V, W0, H0, Z0, trainable, tol=0, max_iter=12,
        W_alpha=W_alpha, H_alpha=H_alpha, Z_alpha=Z_alpha)
    assert pn == rn == 11
    assert abs(float(pnorm) - float(rnorm)) <= 1e-6 * abs(float(rnorm))
    _assert_factors(port, ref)
    for name, flag in zip("WHZ", trainable):
        assert getattr(port, name).requires_grad == flag
    _assert_simplex(port.W)
    _assert_simplex(port.H)


@pytest.mark.parametrize("name, N", [("SIPLCA", 1), ("SIPLCA", 2),
                                     ("SIPLCA2", 1), ("SIPLCA3", 1)])
def test_siplca_fit_matches_jax(jx, name, N):
    _, C, s_in, kernel, R = PROBLEMS[name]
    V, W0, H0, Z0 = _si_problem(N, C, s_in, kernel, R, seed=2)
    port, (pn, pnorm), ref, (rn, rnorm) = _fit_both(
        jx, name, V, W0, H0, Z0, tol=0, max_iter=12)
    assert pn == rn == 11
    assert abs(float(pnorm) - float(rnorm)) <= 1e-6 * abs(float(rnorm))
    _assert_factors(port, ref)


def test_siplca_alpha_fit_matches_jax(jx):
    _, C, s_in, kernel, R = PROBLEMS["SIPLCA"]
    V, W0, H0, Z0 = _si_problem(1, C, s_in, kernel, R, seed=3)
    port, _, ref, _ = _fit_both(jx, "SIPLCA", V, W0, H0, Z0, tol=0, max_iter=12,
                                W_alpha=0.999, H_alpha=1.001, Z_alpha=0.999)
    _assert_factors(port, ref)


def test_converging_fit_returns_the_raw_index(jx):
    """``n_iter`` is the reference's raw loop index: 10·k - 1 when chunk k
    converged."""
    V, W0, H0, Z0 = _plca_problem(seed=4)
    _, (pn, _), _, (rn, _) = _fit_both(jx, "PLCA", V, W0, H0, Z0, tol=1e-3,
                                       max_iter=200)
    assert pn == rn and pn < 199 and (pn + 1) % 10 == 0


@pytest.mark.parametrize("nd, N", [(1, 1), (1, 2), (2, 1), (2, 2), (3, 1)])
def test_plain_adjoint_deconv_matches_conv_autograd(jx, nd, N):
    """The kernel-adjoint deconvolution's plain twin against autograd
    through the convolution ``recon.deconvNd`` (and its forward against
    the JAX package's), float32, 1e-5 relative."""
    name = ("SIPLCA", "SIPLCA2", "SIPLCA3")[nd - 1]
    _, C, s_in, kernel, R = PROBLEMS[name]
    V, W0, H0, _ = _si_problem(N, C, s_in, kernel, R, seed=5)
    rs = np.random.RandomState(6)
    ct = torch.from_numpy(rs.rand(*V.shape).astype("f"))
    outs = []
    for fn in (fast_nmfd.plain_adjoint_deconv,
               getattr(recon, f"deconv{nd}d")):
        H = torch.from_numpy(H0).requires_grad_(True)
        W = torch.from_numpy(W0).requires_grad_(True)
        y = fn(H, W)
        outs.append((y.detach(),) + torch.autograd.grad(y, (H, W), ct))
    for got, want in zip(*outs):
        assert got.shape == want.shape
        assert _rel(got.numpy(), want.numpy()) < 1e-5
    jax_y = np.asarray(getattr(jx.recon, f"deconv{nd}d")(H0, W0))
    assert _rel(outs[0][0].numpy(), jax_y) < 1e-5


def test_adjoint_deconv_runs_one_contraction_each():
    """On a CPU tensor the kernel Function's adjoints are the wrappers'
    plain versions: the same gradients as the plain twin, bit for bit, and
    no kernel launch."""
    _, C, s_in, kernel, R = PROBLEMS["SIPLCA"]
    _, W0, H0, _ = _si_problem(2, C, s_in, kernel, R, seed=7)
    before = (fused_deconv.hgrad.launches, fused_deconv.wgrad.launches)
    grads = []
    for fn in (fast_nmfd.kernel_adjoint_deconv, fast_nmfd.plain_adjoint_deconv):
        H = torch.from_numpy(H0).requires_grad_(True)
        W = torch.from_numpy(W0).requires_grad_(True)
        grads.append(torch.autograd.grad(fn(H, W).square().sum(), (H, W)))
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    assert (fused_deconv.hgrad.launches, fused_deconv.wgrad.launches) == before


@pytest.mark.parametrize(
    "device, dtype, want",
    [("cpu", torch.float32, "plain"), ("cuda", torch.float32, "fused"),
     ("cpu", torch.float64, None), ("cuda", torch.float64, None)],
)
@pytest.mark.parametrize("model", [SIPLCA, SIPLCA2, SIPLCA3])
def test_recon3_resolution(device, dtype, want, model, monkeypatch):
    """The resolver the fit calls, at a shape below the tuning threshold (a
    stand-in target: the resolver reads only its shape, dtype and
    device)."""
    for name in ("PNT_NMFD_AUTOTUNE", "PNT_NMFD_PALLAS", "PNT_NMFD_UNFOLD"):
        monkeypatch.delenv(name, raising=False)
    nd = model._spatial_ndim
    V, H = (SimpleNamespace(shape=torch.Size(shape), dtype=dtype,
                            device=torch.device(device))
            for shape in ((1, 4) + (8,) * nd, (1, 2) + (6,) * nd))
    got = model._resolve_fit_recon3(V, None, H, None)
    if want is None:
        assert got is model.reconstruct
    else:
        assert got is fast_nmfd._RECON3[nd, want]
    assert PLCA._resolve_fit_recon3(V, None, H, None) is PLCA.reconstruct


def test_float64_siplca_fit_matches_float32():
    """The float64 route (autograd through the convolution) and the float32
    kernel-adjoint route are the same EM."""
    _, C, s_in, kernel, R = PROBLEMS["SIPLCA2"]
    V, W0, H0, Z0 = _si_problem(1, C, s_in, kernel, R, seed=8)
    fits = []
    for dt in ("f4", "f8"):
        m = plca_from_numpy({"W": W0.astype(dt), "H": H0.astype(dt),
                             "Z": Z0.astype(dt)}, "cpu")
        m.fit(torch.from_numpy(V.astype(dt)), tol=0, max_iter=10)
        fits.append(m)
    assert fits[1].W.dtype == torch.float64
    for name in ("W", "H", "Z"):
        assert _rel(getattr(fits[0], name).detach().numpy(),
                    getattr(fits[1], name).detach().numpy()) < RTOL_FIT


def test_fused_e_step_plain_twin_matches_generic(monkeypatch):
    V, W0, H0, Z0 = _plca_problem(seed=9)
    fits = []
    for env in ("", "1"):
        monkeypatch.setenv("PNT_PLCA_FUSED", env)
        m = plca_from_numpy({"W": W0, "H": H0, "Z": Z0}, "cpu")
        assert (fast_plca.resolve_plca_em_engine(torch.from_numpy(V))
                is (fast_plca.plca_em_engine_plain if env else None))
        fits.append((m.fit(torch.from_numpy(V), tol=0, max_iter=12), m))
    (n0, norm0), a = fits[0]
    (n1, norm1), b = fits[1]
    assert n0 == n1 == 11 and float(norm0) == float(norm1)
    for name in ("W", "H", "Z"):
        assert _rel(getattr(b, name).detach().numpy(),
                    getattr(a, name).detach().numpy()) < RTOL_FIT


def test_fused_e_step_gates(monkeypatch):
    monkeypatch.setenv("PNT_PLCA_FUSED", "1")
    assert fast_plca.resolve_plca_em_engine(torch.ones(3, 4, 5)) is None
    assert fast_plca.resolve_plca_em_engine(
        torch.ones(3, 4, dtype=torch.float64)) is None
    monkeypatch.setenv("PNT_PLCA_FUSED", "0")
    assert fast_plca.resolve_plca_em_engine(torch.ones(3, 4)) is None


def test_plca_from_numpy_picks_the_model(jx):
    for name, (N, C, s_in, kernel, R) in PROBLEMS.items():
        _, W0, H0, Z0 = _si_problem(N, C, s_in, kernel, R)
        m = plca_from_numpy({"W": W0, "H": H0, "Z": Z0}, "cpu",
                            trainable_Z=False)
        assert type(m).__name__ == name and not m.Z.requires_grad
        ref = jx.models[name](W=W0, H=H0, Z=Z0)
        for p in ("W", "H", "Z"):
            np.testing.assert_allclose(getattr(m, p).detach().numpy(),
                                       np.asarray(getattr(ref, p).data),
                                       rtol=1e-6)
        jax_y = np.asarray(ref())
        assert _rel(m().detach().numpy(), jax_y) < 1e-5
    _, W0, H0, Z0 = _plca_problem()
    assert type(plca_from_numpy({"W": W0, "H": H0, "Z": Z0}, "cpu")) is PLCA
    with pytest.raises(ValueError, match="1-D W"):
        plca_from_numpy({"W": Z0, "H": H0, "Z": Z0}, "cpu")


def test_verbose_shows_the_log_probability(capsys):
    V, W0, H0, Z0 = _plca_problem()
    plca_from_numpy({"W": W0, "H": H0, "Z": Z0}, "cpu").fit(
        torch.from_numpy(V), tol=0, max_iter=20, verbose=True)
    captured = capsys.readouterr()
    assert "log_prob" in captured.err + captured.out


def test_fit_rejects_bad_targets():
    """A negative target is refused; so are factors of two dtypes (a float64
    V is cast to the factors' dtype instead)."""
    V, W0, H0, Z0 = _plca_problem()
    m = plca_from_numpy({"W": W0, "H": H0, "Z": Z0}, "cpu")
    with pytest.raises(ValueError):
        m.fit(torch.from_numpy(-V))
    m = plca_from_numpy({"W": W0, "H": H0, "Z": Z0.astype("f8")}, "cpu")
    with pytest.raises(ValueError, match="one dtype, on one device"):
        m.fit(torch.from_numpy(V))


@pytest.mark.parametrize("name", ["PLCA", "SIPLCA"])
def test_float64_target_warns_and_matches_jax(jx, name):
    """A float64 V on a float32 model is cast to float32 with a
    ``UserWarning``, as the JAX package casts it; the fits agree."""
    if name == "PLCA":
        V, W0, H0, Z0 = _plca_problem(seed=14)
    else:
        V, W0, H0, Z0 = _si_problem(1, *PROBLEMS["SIPLCA"][1:], seed=14)
    with pytest.warns(UserWarning, match="float64 factors"):
        port, (pn, _), ref, (rn, _) = _fit_both(
            jx, name, V.astype("f8"), W0, H0, Z0, tol=0, max_iter=12)
    assert pn == rn == 11 and port.W.dtype == torch.float32
    _assert_factors(port, ref)


# ----------------------------------------------------------------- the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("N, C, s_in, kernel, R", [
    (1, 513, (301,), (20,), 8),
    (2, 33, (120,), (7,), 5),
    (1, 17, (10, 12), (3, 4), 16),
    (1, 6, (5, 6, 4), (2, 3, 2), 3),
])
def test_cuda_adjoint_deconv_matches_plain(cuda, N, C, s_in, kernel, R):
    V, W0, H0, _ = _si_problem(N, C, s_in, kernel, R, seed=10)
    ct = torch.from_numpy(np.random.RandomState(11).rand(*V.shape).astype("f"))
    outs = []
    for fn in (fast_nmfd.kernel_adjoint_deconv, fast_nmfd.plain_adjoint_deconv):
        H = torch.from_numpy(H0).to(cuda).requires_grad_(True)
        W = torch.from_numpy(W0).to(cuda).requires_grad_(True)
        y = fn(H, W)
        outs.append((y.detach(),) + torch.autograd.grad(y, (H, W), ct.to(cuda)))
    torch.cuda.synchronize()
    for got, want in zip(*outs):
        assert got.is_cuda and got.shape == want.shape
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["SIPLCA", "SIPLCA2", "SIPLCA3"])
def test_cuda_siplca_fit_runs_the_kernels(cuda, name):
    N, C, s_in, kernel, R = PROBLEMS[name]
    V, W0, H0, Z0 = _si_problem(N, C, s_in, kernel, R, seed=12)
    m = plca_from_numpy({"W": W0, "H": H0, "Z": Z0}, cuda)
    b3, b4 = fused_deconv.hgrad.launches, fused_deconv.wgrad.launches
    n, _ = m.fit(V, tol=0, max_iter=12)
    assert n == 11
    assert fused_deconv.hgrad.launches - b3 == 12
    assert fused_deconv.wgrad.launches - b4 == 12
    ref = plca_from_numpy({"W": W0, "H": H0, "Z": Z0}, "cpu")
    ref.fit(V, tol=0, max_iter=12)
    for p in ("W", "H", "Z"):
        assert getattr(m, p).is_cuda
        assert _rel(getattr(m, p).detach().cpu().numpy(),
                    getattr(ref, p).detach().numpy()) < RTOL_FIT


@pytest.mark.cuda
def test_cuda_fused_e_step_matches_generic(cuda, monkeypatch):
    V, W0, H0, Z0 = _plca_problem(M=70, K=45, R=6, seed=13)
    fits = []
    for env in ("", "1"):
        monkeypatch.setenv("PNT_PLCA_FUSED", env)
        m = plca_from_numpy({"W": W0, "H": H0, "Z": Z0}, cuda)
        b1 = fused_mu.fused_contractions.launches
        m.fit(V, tol=0, max_iter=12)
        assert (fused_mu.fused_contractions.launches - b1) == (24 if env else 0)
        fits.append(m)
    for p in ("W", "H", "Z"):
        assert _rel(getattr(fits[1], p).detach().cpu().numpy(),
                    getattr(fits[0], p).detach().cpu().numpy()) < RTOL_FIT


def test_em_iteration_keeps_no_graph():
    """The E-step differentiates fresh leaves: the returned factors carry
    no autograd history."""
    V, W0, H0, Z0 = _plca_problem()
    Vt = torch.from_numpy(V)
    fit = solver.get_plca_fit(PLCA.reconstruct, 0.0, 3, True, True, True,
                              False, False, False)
    one = torch.tensor(1.0)
    W, H, Z, n, norm = fit(Vt, *(torch.from_numpy(x) for x in (W0, H0, Z0)),
                           one, one, one)
    assert n == 2 and not (W.requires_grad or H.requires_grad or Z.requires_grad)
    assert W.grad_fn is None and H.grad_fn is None and Z.grad_fn is None

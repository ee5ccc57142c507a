"""The whole slice: the port's dense ``NMF.fit`` against the JAX package's,
from the same numpy target and inits (carried over with ``nmf_from_numpy``),
at 96×48, rank 8.

Tolerances: 30 iterations at ``tol=0`` agree to rtol 1e-5 / atol 1e-6;
``max_iter=200, tol=1e-4`` fits stop at the same ``n_iter`` and agree to
rtol 1e-4 / atol 1e-5 (float32 reordering, grown over the longer run).

The input is seed 1, on which the β=2 fit stops early (at 160), so the
stop rule is exercised.  On seed 0 every fit runs to ``max_iter`` and one
element of 768 at β=0.5 drifts to 1.4× the 200-iteration tolerance: the
JAX package on the CPU runs the generic engine, the port the fused
formulation, and XLA's and PyTorch's GEMMs round differently.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pytorch_nmf_tpu.nmf import NMF as JNMF  # noqa: E402
from pytorch_nmf_tpu_torch.nmf import NMF, NMFD  # noqa: E402
from pytorch_nmf_tpu_torch.ops import fast_nmf, solver  # noqa: E402
from pytorch_nmf_tpu_torch.utils import nmf_from_numpy  # noqa: E402

M, K, R = 96, 48, 8
BETAS = [0, 0.5, 1, 1.5, 2]


@pytest.fixture(scope="module")
def problem():
    rs = np.random.RandomState(1)
    V = np.abs(rs.randn(M, K)).astype("f") + 0.01
    W0 = rs.rand(K, R).astype("f") + 0.1
    H0 = rs.rand(M, R).astype("f") + 0.1
    return V, W0, H0


def _fit_both(problem, trainable_W=True, **fit_kw):
    V, W0, H0 = problem
    ref = JNMF(W=W0, H=H0, trainable_W=trainable_W)
    ref_n = ref.fit(V, **fit_kw)
    port = nmf_from_numpy({"W": W0, "H": H0}, "cpu", trainable_W=trainable_W)
    port_n = port.fit(torch.from_numpy(V), **fit_kw)
    return port, port_n, ref, ref_n


def _assert_factors(port, ref, rtol, atol):
    np.testing.assert_allclose(port.W.detach().numpy(), np.asarray(ref.W.data),
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(port.H.detach().numpy(), np.asarray(ref.H.data),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("beta", BETAS)
def test_fixed_iterations_match_jax(problem, beta):
    port, port_n, ref, ref_n = _fit_both(problem, beta=beta, tol=0, max_iter=30)
    assert port_n == ref_n == 30
    _assert_factors(port, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("beta", BETAS)
def test_converged_fit_matches_jax(problem, beta):
    port, port_n, ref, ref_n = _fit_both(problem, beta=beta, tol=1e-4,
                                         max_iter=200)
    assert port_n == ref_n
    _assert_factors(port, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("beta", [1, 0.5])
def test_regularized_fit_matches_jax(problem, beta):
    port, _, ref, _ = _fit_both(problem, beta=beta, tol=0, max_iter=30,
                                alpha=0.1, l1_ratio=0.5)
    _assert_factors(port, ref, rtol=1e-5, atol=1e-6)


def test_frozen_factor_matches_jax(problem):
    port, _, ref, _ = _fit_both(problem, trainable_W=False, beta=1, tol=0,
                                max_iter=30)
    assert not port.W.requires_grad
    np.testing.assert_array_equal(port.W.detach().numpy(), problem[1])
    _assert_factors(port, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("beta", [0, -0.5])
def test_zeros_with_nonpositive_beta_raise(problem, beta):
    V, W0, H0 = problem
    V = V.copy()
    V[0, 0] = 0.0
    m = nmf_from_numpy({"W": W0, "H": H0}, "cpu")
    with pytest.raises(ValueError, match="beta <= 0"):
        m.fit(torch.from_numpy(V), beta=beta)
    # explicit inits: a shape would draw from the JAX package's global key
    # chain, which other test files' random inits share
    with pytest.raises(ValueError, match="beta <= 0"):
        JNMF(W=W0, H=H0).fit(V, beta=beta)


def test_negative_target_raises(problem):
    m = NMF((M, K), R, device="cpu",
            generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="non-negative"):
        m.fit(-torch.from_numpy(problem[0]))


def test_sparse_target_fit_equals_dense_fit(problem):
    """Sparse targets are ported: ``fit`` takes a sparse COO tensor, and on
    a target with every entry stored it is the dense fit."""
    V = torch.from_numpy(problem[0])
    fits = []
    for target in (V, V.to_sparse()):
        m = NMF((M, K), R, device="cpu",
                generator=torch.Generator().manual_seed(0))
        assert m.fit(target, beta=1, tol=0, max_iter=10) == 10
        fits.append(m)
    torch.testing.assert_close(fits[1].W, fits[0].W, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(fits[1].H, fits[0].H, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("beta", [0.5, 1])
def test_generic_engine_matches_fused_formulation(problem, beta):
    """The autograd engine (the float64 route) and the fused formulation
    are the same update."""
    V, W0, H0 = (torch.from_numpy(x) for x in problem)
    out = [
        solver.get_dense_fit(NMF.reconstruct, beta, 0.0, 30, True, True, 0.0,
                             0.0, False, factory)(V, W0, H0)
        for factory in (None, fast_nmf.nmf_updater_factory_plain)
    ]
    for a, b in zip(out[0][:2], out[1][:2]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_float64_fit_stays_float64(problem):
    V, W0, H0 = (x.astype("f8") for x in problem)
    m = nmf_from_numpy({"W": W0, "H": H0}, "cpu")
    assert m.W.dtype == torch.float64
    m.fit(torch.from_numpy(V), beta=0.5, tol=0, max_iter=20)
    assert m.W.dtype == m.H.dtype == torch.float64
    assert bool(torch.isfinite(m.W).all() and torch.isfinite(m.H).all())


@pytest.mark.parametrize(
    "device, dtype, factory",
    [("cpu", torch.float32, "nmf_updater_factory_plain"),
     ("cuda", torch.float32, "nmf_updater_factory_fused"),
     ("cpu", torch.float64, "nmf_updater_factory_generic"),
     ("cuda", torch.float64, "nmf_updater_factory_generic")],
)
def test_factory_resolution(device, dtype, factory):
    got = fast_nmf.resolve_nmf_updater_factory(device, dtype)
    assert got is getattr(fast_nmf, factory)


def test_constructor_shapes_and_seeded_init():
    a = NMF((M, K), R, device="cpu",
            generator=torch.Generator().manual_seed(3))
    b = NMF((M, K), R, device="cpu",
            generator=torch.Generator().manual_seed(3))
    assert a.W.shape == (K, R) and a.H.shape == (M, R) and a.rank == R
    assert a().shape == (M, K)
    assert bool((a.W >= 0).all()) and torch.equal(a.W, b.W)
    assert NMF((M, K), device="cpu", generator=torch.Generator()).rank == K


@pytest.mark.parametrize(
    "kwargs",
    [dict(Vshape=(M, K, 3)), dict(Vshape=(M,)),
     dict(W=-np.ones((K, R), "f")), dict(W=np.ones((K, R), "f"),
                                         H=np.ones((M, R + 1), "f"))],
)
def test_invalid_construct(kwargs):
    with pytest.raises(ValueError):
        NMF(**kwargs, device="cpu")


def test_fit_rejects_factors_elsewhere(problem):
    """A fit runs in one dtype on one device: factors of two dtypes are
    refused (a float64 V is cast to the factors' dtype instead)."""
    m = nmf_from_numpy({"W": problem[1].astype("f8"), "H": problem[2]}, "cpu")
    with pytest.raises(ValueError, match="one dtype, on one device"):
        m.fit(torch.from_numpy(problem[0]))


@pytest.mark.parametrize("beta", [1, 0.5])
def test_float64_target_warns_and_matches_jax(problem, beta):
    """A float64 V (numpy's default) on a float32 model is cast to float32
    with a ``UserWarning``, as the JAX package casts it; the fits agree."""
    V, W0, H0 = problem
    V = V.astype("f8")
    with pytest.warns(UserWarning, match="float64 factors"):
        port = nmf_from_numpy({"W": W0, "H": H0}, "cpu")
        assert port.fit(V, beta=beta, tol=0, max_iter=30) == 30
    assert port.W.dtype == torch.float32
    with pytest.warns(UserWarning):
        ref = JNMF(W=W0, H=H0)
        ref.fit(V, beta=beta, tol=0, max_iter=30)
    _assert_factors(port, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("build", [
    lambda: NMF((M, K), R),
    lambda: NMF((M, K), R, device=None),
    lambda: NMFD((1, 20, 100), 5, T=7),
    lambda: nmf_from_numpy({"W": np.ones((K, R), "f"), "H": np.ones((M, R), "f")}),
])
def test_default_device_is_the_card(build):
    """``device=None`` means ``"cuda"``, for drawn and given inits alike:
    the factors land on the card, and without one the constructor raises
    instead of running on the CPU."""
    if torch.cuda.is_available():
        m = build()
        assert m.W.is_cuda and m.H.is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()


@pytest.mark.parametrize("device", [None, "cuda"])
def test_generator_on_another_device_raises(device):
    with pytest.raises(ValueError, match="generator"):
        NMF((M, K), R, device=device, generator=torch.Generator())


def test_fit_takes_numpy(problem):
    """``fit`` takes V as numpy (as the JAX package's does) and moves it to
    the factors' device: the same fit as from a tensor."""
    V, W0, H0 = problem
    a = nmf_from_numpy({"W": W0, "H": H0}, "cpu")
    b = nmf_from_numpy({"W": W0, "H": H0}, "cpu")
    assert a.fit(V, beta=0.5, tol=0, max_iter=10) == 10
    b.fit(torch.from_numpy(V), beta=0.5, tol=0, max_iter=10)
    assert torch.equal(a.W, b.W) and torch.equal(a.H, b.H)


@pytest.mark.cuda
def test_cuda_default_model_fits_numpy(problem):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    V, W0, H0 = problem
    m = nmf_from_numpy({"W": W0, "H": H0})
    assert m.fit(V, beta=1, tol=0, max_iter=10) == 10
    assert m.W.is_cuda and bool(torch.isfinite(m.W).all())


def test_verbose_reports_each_chunk(problem, capsys):
    m = nmf_from_numpy({"W": problem[1], "H": problem[2]}, "cpu")
    assert m.fit(torch.from_numpy(problem[0]), beta=1, tol=0, max_iter=20,
                 verbose=True) == 20
    captured = capsys.readouterr()
    assert "loss" in captured.err + captured.out


def test_import_leaves_jax_out():
    code = (
        "import sys, pytorch_nmf_tpu_torch\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('pytorch_nmf_tpu.') or m == 'pytorch_nmf_tpu']\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=Path(__file__).resolve().parents[1])

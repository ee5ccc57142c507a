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

import numpy as np
import pytest
import torch

from pytorch_nmf_tpu.models import nmf as jnmf
from pytorch_nmf_tpu.ops import recon as jrecon
from pytorch_nmf_tpu_torch.nmf import NMF2D, NMF3D, NMFD
from pytorch_nmf_tpu_torch.ops import fast_nmfd, fused_deconv, solver
from pytorch_nmf_tpu_torch.utils import nmf_from_numpy

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
def test_factory_resolution(device, dtype, want, nd):
    got = fast_nmfd.resolve_nmfd_updater_factory(device, dtype, nd)
    if want is None:
        assert got is None
    else:
        assert got is getattr(fast_nmfd, f"deconv_updater_factory_{want}")(nd)
    model = {1: NMFD, 2: NMF2D, 3: NMF3D}[nd]
    assert model._updater_resolver(device, dtype) is got


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

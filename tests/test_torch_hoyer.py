"""Hoyer sparseness-constrained fitting: the port's ``sparse_fit`` and
projection against the JAX package's, from the same numpy data and inits.

Tolerances: the projection within 1e-5 relative (at scales that overflow
float32's ``b*b``, on its finite entries, with NaN in the same places as
the JAX package's jitted projection); after 8 iterations, W and H within
1e-4 relative (``max|Δ|/max|ref|``), float32 reordering of the same sums.  The line search branches on ``new_loss > baseline``, so the seeds
here are ones where no decision sits at the edge (the port's decisions
were checked to match at 1e-6).  The JAX models run their own CPU path.

With both factors constrained at β=1 both packages reach NaN within a few
iterations on these inputs (an H column projected to zero, then renormed),
so that case is left out.

CUDA tests (marked ``cuda``, skipped without a card):
``python -m pytest --noconftest -m cuda tests/test_torch_hoyer.py``.
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pytorch_nmf_tpu_torch import metrics  # noqa: E402
from pytorch_nmf_tpu_torch.nmf import NMF, NMF2D, NMF3D, NMFD  # noqa: E402
from pytorch_nmf_tpu_torch.ops import fast_nmfd, fused_deconv, projection, solver  # noqa: E402
from pytorch_nmf_tpu_torch.ops.sparse import sparse_from_dense  # noqa: E402
from pytorch_nmf_tpu_torch.utils import nmf_from_numpy  # noqa: E402

RTOL_FIT = 1e-4
ITERS = 8


@pytest.fixture(scope="module")
def jx():
    """The JAX package's models and projection, imported only by the tests
    that compare with it: the CUDA tests need no JAX."""
    jax = pytest.importorskip("jax")
    from pytorch_nmf_tpu.models import nmf
    from pytorch_nmf_tpu.ops import projection as jproj
    from pytorch_nmf_tpu.ops import sparse as jsparse

    return SimpleNamespace(jax=jax, models=nmf, proj=jproj, sparse=jsparse)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


# the NMFD problem whose W the old projection turned to NaN in one iteration
# (V 2×12×40, R=3, T=5, every array ``rand + 0.01``), from numpy seed 0 or
# 1: the cases "NMFD probe 0" and "NMFD probe 1"
PROBE = ((2, 12, 40), (12, 3, 5), (2, 3, 36))


def _problem(name, seed=1):
    if name.startswith("NMFD probe"):
        rs = np.random.RandomState(int(name[-1]))
        return tuple(rs.rand(*s).astype("f") + 0.01 for s in PROBE)
    rs = np.random.RandomState(seed)
    if name == "NMF":
        shapes = (40, 30), (30, 5), (40, 5)
    elif name == "NMFD":
        shapes = (1, 12, 60), (12, 3, 5), (1, 3, 56)
    else:
        shapes = (1, 3, 12, 14), (3, 3, 3, 4), (1, 3, 10, 11)
    return tuple(rs.rand(*s).astype("f") + off
                 for s, off in zip(shapes, (0.01, 0.1, 0.1)))


def _fit_both(jx, name, V, W0, H0, trainable=(True, True), port_V=None,
              jax_V=None, **kw):
    tw, th = trainable
    ref = getattr(jx.models, name)(W=W0, H=H0, trainable_W=tw, trainable_H=th)
    ref_n = ref.sparse_fit(V if jax_V is None else jax_V, **kw)
    port = nmf_from_numpy({"W": W0, "H": H0}, "cpu", tw, th)
    port_n = port.sparse_fit(torch.from_numpy(V) if port_V is None else port_V,
                             **kw)
    return port, port_n, ref, ref_n


def _assert_factors(port, ref):
    assert _rel(port.W.detach().numpy(), ref.W.data) < RTOL_FIT
    assert _rel(port.H.detach().numpy(), ref.H.data) < RTOL_FIT


def _col_sparseness(x, axis=1):
    cols = x.detach().movedim(axis, 0).reshape(x.shape[axis], -1)
    return torch.stack([metrics.sparseness(c) for c in cols])


@pytest.mark.parametrize("s, N, R", [(0.3, 40, 5), (0.9, 500, 6)])
def test_proj_columns_matches_jax(jx, s, N, R):
    """Columns of random values to Hoyer sparseness ``s``; at 0.9 every
    column needs several rounds."""
    rs = np.random.RandomState(2)
    x = rs.rand(N, R).astype("f")
    L1 = projection.hoyer_l1_target(N, s)
    before = projection.proj_rows.reads
    got = projection.proj_columns(torch.from_numpy(x), L1)
    assert _rel(got.numpy(), jx.proj.proj_columns(x, L1)) < 1e-5
    if s == 0.9:
        assert projection.proj_rows.reads - before >= 2  # ≥ 4 rounds
    got = projection.proj_columns_explicit(torch.from_numpy(x), L1, 1.0)
    want = jx.proj.proj_columns_explicit(x, L1, 1.0)
    assert _rel(got.numpy(), want) < 1e-5
    np.testing.assert_allclose(_col_sparseness(got).numpy(), s, atol=1e-4)
    assert bool((got >= 0).all())
    v = rs.rand(3, 7).astype("f")
    assert _rel(projection.proj_func(torch.from_numpy(v), 3.0, 2.0).numpy(),
                jx.proj.proj_func(v, 3.0, 2.0)) < 1e-5
    assert projection.hoyer_l1_target(N, s) == jx.proj.hoyer_l1_target(N, s)


def test_plain_projection_counts_rounds_and_dispatches_by_device():
    """The plain version's rounds per row; the wrapper takes it for a CPU
    tensor and refuses a device with no kernel."""
    x = torch.from_numpy(np.random.RandomState(3).rand(4, 300).astype("f"))
    k1 = torch.full((4,), projection.hoyer_l1_target(300, 0.9))
    k2 = torch.ones(4)
    v, rounds = projection.plain_proj_rows(x, k1, k2, return_rounds=True)
    assert torch.equal(v, projection.proj_rows(x, k1, k2))
    assert bool((rounds >= 3).all() and (rounds <= 302).all())
    with pytest.raises(ValueError, match="no projection kernel"):
        projection.proj_rows(x.to("meta"), k1.to("meta"), k2.to("meta"))


# the H100's opt-in shared memory per block
# (cudaDevAttrMaxSharedMemoryPerBlockOptin), bytes
OPTIN_H100 = 232448


def _edges(itemsize, optin):
    """Column lengths at the edges of the kernel's regimes, from its layout:
    a CTA holds a 1024-byte header of sums, then its values (an even count),
    and a cluster has at most 16 CTAs, each a multiple of 32 values."""
    room = optin - 1024
    last_cta = room // itemsize // 2 * 2
    cap = room // (32 * itemsize) * 32
    return {"last cta": last_cta, "first cluster": last_cta + 1,
            "last cluster": 16 * cap, "first stream": 16 * cap + 1}


REGIME_EDGES = [("last cta", "cta"), ("first cluster", "cluster"),
                ("last cluster", "cluster"), ("first stream", "stream")]


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("edge, regime", REGIME_EDGES)
def test_projection_plan_at_regime_edges(edge, regime, itemsize):
    """The kernel's plan on the H100 at each regime's first or last column
    length, float32 and float64: the regime; a resident CTA's slice fits
    the shared memory it asks for, within the card's; the smallest cluster
    that holds the column, at most 16 CTAs."""
    N = _edges(itemsize, OPTIN_H100)[edge]
    plan = projection._plan(N, itemsize, OPTIN_H100)
    assert plan.regime == regime
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024
    assert 1 <= plan.cluster <= 16
    if regime == "stream":
        assert plan == ("stream", 1024, 1, 0, 0)
        return
    values = plan.slice + plan.slice % 2
    assert 1024 + values * itemsize <= plan.smem <= OPTIN_H100
    assert (plan.cluster - 1) * plan.slice < N <= plan.cluster * plan.slice
    cap = (OPTIN_H100 - 1024) // (32 * itemsize) * 32
    if regime == "cta":
        assert plan.cluster == 1 and plan.slice == N
    else:
        assert plan.slice % 32 == 0 and (plan.cluster - 1) * cap < N


@pytest.mark.parametrize("dtype", ["f", "d"])
def test_proj_columns_of_deconv_factors_matches_jax(jx, dtype):
    """Rank columns that are not contiguous (NMFD's W, C×R×T, along axis
    1), in float32 and float64, against the JAX package's projection
    (float32) within 1e-5 relative."""
    x = np.random.RandomState(4).rand(12, 3, 7).astype(dtype)
    L1 = projection.hoyer_l1_target(12 * 7, 0.6)
    got = projection.proj_columns(torch.from_numpy(x), L1)
    assert got.dtype == torch.from_numpy(x).dtype and got.shape == x.shape
    assert _rel(got.numpy(), jx.proj.proj_columns(x.astype("f"), L1)) < 1e-5
    np.testing.assert_allclose(_col_sparseness(got).numpy(), 0.6, atol=1e-4)


@pytest.mark.parametrize("scale", [1e9, 1e12, 1e15, 1e18])
def test_proj_columns_at_large_scales_matches_jax_jit(jx, scale):
    """Columns whose ``b*b`` overflows float32: the port's projection has
    NaN exactly where the JAX package's jitted one has it (XLA fuses the
    discriminant: ``b*b`` exact, NaN taken as 0), and its finite entries
    agree within 1e-5 relative (``max|Δ|/max|ref|``)."""
    x = (np.random.RandomState(0).randn(20, 4) * scale).astype("f")
    got = projection.proj_columns(torch.from_numpy(x), 0.5).numpy()
    want = np.asarray(jx.jax.jit(jx.proj.proj_columns,
                                 static_argnums=(1, 2))(x, 0.5, 1))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    assert np.isfinite(got[fin]).all()
    if fin.any():
        assert _rel(got[fin], want[fin]) < 1e-5


@pytest.mark.parametrize("name, beta, kw", [
    ("NMF", 2, dict(sW=0.5)),
    ("NMF", 2, dict(sH=0.5)),
    ("NMF", 2, dict(sW=0.5, sH=0.4)),
    ("NMFD", 2, dict(sW=0.5)),
    ("NMFD", 1, dict(sH=0.5)),
    ("NMFD", 2, dict(sW=0.5, sH=0.4)),
    ("NMF2D", 2, dict(sW=0.5, sH=0.4)),
    # β ∈ {0, 0.5}, where the projection's ``b*b`` can overflow float32;
    # "NMF seed 2" is ``_problem("NMF", 2)``.  From these inits most
    # draws diverge to NaN in both packages within 8 iterations; the seeds
    # are draws where the JAX fit stays finite.  "NMF seed 2" at β=0.5
    # with ``sH`` and the last three were NaN before the projection formed
    # its discriminant as XLA does.
    ("NMF seed 2", 0, dict(sW=0.5)),
    ("NMF seed 5", 0, dict(sH=0.5)),
    ("NMF seed 2", 0.5, dict(sW=0.5)),
    ("NMF seed 2", 0.5, dict(sH=0.5)),
    ("NMFD seed 0", 0, dict(sW=0.4)),
    ("NMFD seed 2", 0.5, dict(sW=0.5)),
    ("NMFD probe 0", 0.5, dict(sW=0.4)),
    ("NMFD probe 1", 0.5, dict(sW=0.4)),
])
def test_sparse_fit_matches_jax(jx, name, beta, kw):
    model, _, seed = name.partition(" seed ")
    V, W0, H0 = _problem(model, int(seed or 1))
    port, port_n, ref, ref_n = _fit_both(jx, model.split()[0], V, W0, H0,
                                         beta=beta, max_iter=ITERS, **kw)
    assert port_n == ref_n == ITERS
    for p in (port.W, port.H):
        assert bool(torch.isfinite(p).all())
    _assert_factors(port, ref)
    if "sW" in kw:
        torch.testing.assert_close(_col_sparseness(port.W),
                                   torch.full((port.rank,), kw["sW"]),
                                   atol=1e-3, rtol=0)


def test_frozen_factor_matches_jax(jx):
    """A frozen factor's sparseness is ignored, and a frozen W is still
    rescaled by the renorm onto unit-norm H, as in the JAX package and the
    reference."""
    V, W0, H0 = _problem("NMF", seed=3)
    port, _, ref, _ = _fit_both(jx, "NMF", V, W0, H0, (False, True), beta=2,
                                max_iter=ITERS, sW=0.5, sH=0.5)
    _assert_factors(port, ref)
    assert not port.W.requires_grad


@pytest.mark.parametrize("beta, kw", [(1, dict(sH=0.5))])
def test_sparse_target_matches_jax(jx, beta, kw):
    V, W0, H0 = _problem("NMF", seed=4)
    V = np.where(V > 0.6, V, 0).astype("f")
    port, _, ref, _ = _fit_both(
        jx, "NMF", V, W0, H0, port_V=sparse_from_dense(V),
        jax_V=jx.sparse.sparse_from_dense(V), beta=beta, max_iter=ITERS, **kw)
    _assert_factors(port, ref)


@pytest.mark.parametrize("kw", [dict(sH=0.5), {}])
def test_float64_matches_jax_x64(jx, kw):
    """The port's float64 factors against the JAX package under x64.  (The
    JAX projection runs in float32, so the constrained factor agrees to
    float32; with ``sW`` the JAX x64 fit raises a loop-carry dtype error.)"""
    V, W0, H0 = (x.astype("f8") for x in _problem("NMF", seed=5))
    with jx.jax.enable_x64(True):
        port, _, ref, _ = _fit_both(jx, "NMF", V, W0, H0, beta=2,
                                    max_iter=ITERS, **kw)
        ref_W, ref_H = np.asarray(ref.W.data), np.asarray(ref.H.data)
    assert port.W.dtype == port.H.dtype == torch.float64
    assert _rel(port.W.detach().numpy(), ref_W) < (RTOL_FIT if kw else 1e-10)
    assert _rel(port.H.detach().numpy(), ref_H) < (RTOL_FIT if kw else 1e-10)


def test_float64_sw_fit_matches_float32():
    fits = []
    for dt in ("f4", "f8"):
        V, W0, H0 = (x.astype(dt) for x in _problem("NMFD", seed=6))
        m = nmf_from_numpy({"W": W0, "H": H0}, "cpu")
        m.sparse_fit(torch.from_numpy(V), beta=2, max_iter=ITERS, sW=0.5)
        fits.append(m)
    assert fits[1].W.dtype == torch.float64
    assert _rel(fits[0].W.detach().numpy(), fits[1].W.detach().numpy()) < RTOL_FIT
    assert _rel(fits[0].H.detach().numpy(), fits[1].H.detach().numpy()) < RTOL_FIT


def test_float64_target_warns_and_matches_jax(jx):
    """C1: a float64 V on a float32 model is cast with a UserWarning, as the
    JAX package casts it."""
    V, W0, H0 = _problem("NMF", seed=7)
    V = V.astype("f8")
    with pytest.warns(UserWarning, match="float64 factors"):
        port = nmf_from_numpy({"W": W0, "H": H0}, "cpu")
        port.sparse_fit(V, beta=2, max_iter=ITERS, sW=0.5)
    with pytest.warns(UserWarning):
        ref = jx.models.NMF(W=W0, H=H0)
        ref.sparse_fit(V, beta=2, max_iter=ITERS, sW=0.5)
    assert port.W.dtype == torch.float32
    _assert_factors(port, ref)


@pytest.mark.parametrize("model", [NMF, NMFD, NMF2D, NMF3D])
@pytest.mark.parametrize("device, dtype, want", [
    ("cpu", torch.float32, "plain"), ("cuda", torch.float32, "fused"),
    ("cpu", torch.float64, None), ("cuda", torch.float64, None)])
def test_fit_recon2_resolution(model, device, dtype, want, monkeypatch):
    """The resolver the fit calls, at a shape below the tuning threshold (a
    stand-in target: the resolver reads only its shape, dtype and
    device)."""
    for name in ("PNT_NMFD_AUTOTUNE", "PNT_NMFD_PALLAS", "PNT_NMFD_UNFOLD"):
        monkeypatch.delenv(name, raising=False)
    nd = getattr(model, "_spatial_ndim", 0)
    V, H = (SimpleNamespace(shape=torch.Size(shape), dtype=dtype,
                            device=torch.device(device))
            for shape in (((1, 4) + (8,) * nd, (1, 2) + (6,) * nd) if nd
                          else ((6, 5), (6, 2))))
    got = model._resolve_fit_recon2(V, None, H, 2.0)
    if model is NMF or want is None:
        assert got is model.reconstruct
    else:
        assert got is (fast_nmfd.kernel_adjoint_deconv if want == "fused"
                       else fast_nmfd.plain_adjoint_deconv)


@pytest.fixture
def contraction_calls(monkeypatch):
    """Counts of the plain contractions that the kernel wrappers run on a
    CPU tensor."""
    calls = {"hgrad": 0, "wgrad": 0}
    for name in calls:
        fn = getattr(fused_deconv, f"plain_{name}")

        def counted(*args, _fn=fn, _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(fused_deconv, f"plain_{name}", counted)
    return calls


@pytest.mark.parametrize("wrt, want", [("H", (1, 0)), ("W", (0, 1)),
                                       ("HW", (1, 1))])
@pytest.mark.parametrize("N", [1, 2])
def test_adjoint_deconv_runs_only_the_asked_contraction(contraction_calls, wrt,
                                                       want, N):
    rs = np.random.RandomState(8)
    H = torch.from_numpy(rs.rand(N, 3, 40).astype("f")).requires_grad_("H" in wrt)
    W = torch.from_numpy(rs.rand(6, 3, 5).astype("f")).requires_grad_("W" in wrt)
    inputs = [x for x in (H, W) if x.requires_grad]
    got = torch.autograd.grad(fast_nmfd.kernel_adjoint_deconv(H, W).square().sum(),
                              inputs)
    assert (contraction_calls["hgrad"], contraction_calls["wgrad"]) == want
    ref = torch.autograd.grad(
        fast_nmfd.plain_adjoint_deconv(H, W).square().sum(), inputs)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("kw, per_iter", [(dict(sW=0.5), (2, 1)),
                                          (dict(sW=0.5, sH=0.5), (1, 1))])
def test_nmfd_hoyer_contractions_per_iteration(contraction_calls, kw, per_iter):
    """At β=2 an ``sW`` fit runs one W gradient (B4) and the two MU
    contractions of H (B3) per iteration; with ``sH`` too, one of each.
    The line search's attempts run the reconstruction only.  (The fit of a
    CUDA target, through the kernel Function, whose wrappers run the
    counted plain contractions on the CPU.)"""
    V, W0, H0 = _problem("NMFD", seed=9)
    fit = solver.get_hoyer_fit(
        fast_nmfd.kernel_adjoint_deconv, None, 2.0, ITERS, True, True,
        kw.get("sW"), kw.get("sH"), W0.size // W0.shape[1],
        H0.size // H0.shape[1])
    fit(*(torch.from_numpy(x) for x in (V, W0, H0)))
    assert (contraction_calls["hgrad"], contraction_calls["wgrad"]) == tuple(
        ITERS * n for n in per_iter)


def test_host_reads_per_line_search():
    V, W0, H0 = _problem("NMF", seed=10)
    before = solver._backtrack_project.reads
    nmf_from_numpy({"W": W0, "H": H0}, "cpu").sparse_fit(
        torch.from_numpy(V), beta=2, max_iter=ITERS, sW=0.5)
    reads = solver._backtrack_project.reads - before
    assert ITERS <= reads <= 10 * ITERS


def test_deconv_sparse_target_raises_and_verbose_reports(capsys):
    m = NMFD((1, 6, 30), 2, T=3, device="cpu", generator=torch.Generator())
    with pytest.raises(NotImplementedError):
        m.sparse_fit(sparse_from_dense(np.ones((6, 30), "f")), sW=0.5)
    V, W0, H0 = _problem("NMF", seed=11)
    assert nmf_from_numpy({"W": W0, "H": H0}, "cpu").sparse_fit(
        torch.from_numpy(V), max_iter=20, sW=0.5, verbose=True) == 20
    captured = capsys.readouterr()
    assert "loss" in captured.err + captured.out


# ----------------------------------------------------------------- the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["NMFD", "NMF2D"])
@pytest.mark.parametrize("kw, per_iter", [(dict(sW=0.5), (2, 1)),
                                          (dict(sW=0.5, sH=0.5), (1, 1))])
def test_cuda_hoyer_runs_the_kernels(cuda, name, kw, per_iter):
    """The deconv Hoyer fit on B3/B4 against its plain twin on the card:
    the launch counts per iteration, and the factors within 1e-4."""
    V, W0, H0 = _problem(name, seed=12)
    m = nmf_from_numpy({"W": W0, "H": H0}, cuda)
    b3, b4 = fused_deconv.hgrad.launches, fused_deconv.wgrad.launches
    p1, reads = projection.proj_rows.launches, projection.proj_rows.reads
    assert m.sparse_fit(V, beta=2, max_iter=ITERS, **kw) == ITERS
    assert (fused_deconv.hgrad.launches - b3,
            fused_deconv.wgrad.launches - b4) == tuple(ITERS * n for n in per_iter)
    # every projection is one kernel launch, with no host read
    assert projection.proj_rows.launches - p1 >= ITERS
    assert projection.proj_rows.reads == reads
    fit = solver.get_hoyer_fit(
        fast_nmfd.plain_adjoint_deconv, None, 2.0, ITERS, True, True,
        kw.get("sW"), kw.get("sH"), W0.size // W0.shape[1],
        H0.size // H0.shape[1])
    W, H, _ = fit(*(torch.from_numpy(x).to(cuda) for x in (V, W0, H0)))
    assert m.W.is_cuda and bool((m.W >= 0).all() and (m.H >= 0).all())
    assert _rel(m.W.detach().cpu(), W.cpu()) < RTOL_FIT
    assert _rel(m.H.detach().cpu(), H.cpu()) < RTOL_FIT


def _assert_same_projection(got, want, rtol=1e-5):
    """NaN in the same places, finite entries within ``rtol`` relative."""
    got, want = got.cpu(), want.cpu()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    fin = torch.isfinite(want)
    assert bool(torch.isfinite(got[fin]).all())
    if bool(fin.any()):
        scale = float(want[fin].abs().max())
        assert float((got[fin] - want[fin]).abs().max()) <= rtol * scale


def _check_kernel_columns(cuda, N, dtype, rs):
    """Columns of ``randn·scale`` at scales from 1e-3 to 1e18 (b*b
    overflows float32 from 1e9 on) with one all-zero column, and a column
    set to one value projected onto its own L1 norm (every coordinate at
    the maximum: v = m exactly, so w = v - m is zero and the step 0/0), by
    the kernel against the plain version on the card; one launch a
    projection and no host read."""
    R = 6
    for scale in (1e-3, 1.0, 1e9, 1e12, 1e15, 1e18):
        x = torch.from_numpy(rs.randn(N, R) * scale).to(cuda, dtype)
        x[:, 2] = 0
        L1 = projection.hoyer_l1_target(N, 0.5)
        n0, r0 = projection.proj_rows.launches, projection.proj_rows.reads
        got = projection.proj_columns(x, L1)
        assert projection.proj_rows.launches - n0 == 1
        assert projection.proj_rows.reads == r0
        norms = torch.sqrt(torch.sum(x * x, dim=0))
        want = projection.plain_proj_rows(x.T.contiguous(), L1 * norms,
                                          norms * norms).T
        _assert_same_projection(got, want)
        assert bool(torch.isnan(got[:, 2]).all()) == (N >= 1)
    # 0.5, a power of two: N·0.5 and every sum of the column are exact
    x = torch.full((N, 1), 0.5, dtype=dtype, device=cuda)
    k1, k2 = torch.full((1,), N * 0.5), torch.ones(1)
    got = projection.proj_columns_explicit(x, k1, k2)
    want = projection.plain_proj_rows(x.T.contiguous(), k1.to(cuda),
                                      k2.to(cuda)).T
    _assert_same_projection(got, want)
    assert bool(torch.isnan(got).all())


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 2, 1025, 5168, 410000])
def test_cuda_projection_kernel_matches_plain(cuda, N):
    """The kernel of ``csrc/hoyer_proj.cu`` against the plain version on
    the card (``_check_kernel_columns``), float32."""
    _check_kernel_columns(cuda, N, torch.float32, np.random.RandomState(N % 1000))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("edge, regime", REGIME_EDGES)
def test_cuda_projection_kernel_at_regime_edges(cuda, edge, regime, dtype):
    """The kernel at each regime's first or last column length on this
    card (its opt-in shared memory read from the card) against the plain
    version, as ``_check_kernel_columns`` checks it."""
    _, optin = projection._library(torch.device(cuda))
    itemsize = torch.empty((), dtype=dtype).element_size()
    N = _edges(itemsize, optin)[edge]
    assert projection._plan(N, itemsize, optin).regime == regime
    _check_kernel_columns(cuda, N, dtype, np.random.RandomState(N % 1000))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape, regime", [((257, 3, 40), "cta"),
                                           ((1025, 3, 100), "cluster"),
                                           ((2400, 2, 400), "stream")])
def test_cuda_projection_kernel_regimes_on_strided_columns(cuda, shape, regime,
                                                           dtype):
    """An NMFD-shaped W (C, R, T) projected along axis 1 where it lies, in
    each regime, against the plain version on the columns copied out."""
    W = torch.from_numpy(np.random.RandomState(6).rand(*shape)).to(cuda, dtype)
    assert projection.kernel_plan(W, 1).regime == regime
    R, N = shape[1], shape[0] * shape[2]
    L1 = projection.hoyer_l1_target(N, 0.5)
    got = projection.proj_columns(W, L1)
    cols = W.movedim(1, 0).reshape(R, N)
    norms = torch.sqrt(torch.sum(cols * cols, dim=1))
    want = projection.plain_proj_rows(cols, L1 * norms, norms * norms)
    _assert_same_projection(got.movedim(1, 0).reshape(R, N), want)
    assert got.dtype == dtype


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_projection_kernel_on_strided_columns(cuda, dtype):
    """NMFD's W (C, R, T) projected along axis 1 where it lies, against the
    plain version on the columns copied out; float32 and float64; explicit
    targets and ``proj_func`` too."""
    rs = np.random.RandomState(5)
    W = torch.from_numpy(rs.rand(257, 8, 40)).to(cuda, dtype)
    L1 = projection.hoyer_l1_target(257 * 40, 0.5)
    got = projection.proj_columns(W, L1)
    cols = W.movedim(1, 0).reshape(8, -1)
    norms = torch.sqrt(torch.sum(cols * cols, dim=1))
    want = projection.plain_proj_rows(cols, L1 * norms, norms * norms)
    _assert_same_projection(got.movedim(1, 0).reshape(8, -1), want)
    assert got.dtype == dtype
    got = projection.proj_columns_explicit(W, L1, 1.0)
    want = projection.plain_proj_rows(cols, torch.full_like(norms, L1),
                                      torch.ones_like(norms))
    _assert_same_projection(got.movedim(1, 0).reshape(8, -1), want)
    v = W[0]
    _assert_same_projection(projection.proj_func(v, 3.0, 2.0),
                            projection.plain_proj_rows(
                                v.reshape(1, -1), torch.full((1,), 3.0, device=cuda),
                                torch.full((1,), 2.0, device=cuda)).reshape(v.shape))
    with pytest.raises(TypeError, match="float32 or float64"):
        projection.proj_columns(W.half(), L1)

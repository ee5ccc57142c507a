"""The fits' compiled execution: the single-card dense MU fit (``NMF``,
``NMFD``, ``NMF2D``, ``NMF3D``) and the PLCA/SIPLCA EM fit run their chunk
loop as one in-place workload (``ops/solver._graphed_loop``), a device
loop over 10-iteration chunks: chunks 1-2 eagerly and one replay of a CUDA
graph for the rest (the loop a WHILE node), on the card; called directly
on the CPU.

CPU tests:

* the port's fits against the JAX package's jitted fits (explicit inits,
  numpy seeds): ``max_iter`` ∈ {0, 5, 10, 20, 25, 30, 47} (fewer than 3
  chunks, the capture boundary, a remainder), early stops at chunks 1, 2
  and 4 (a ``tol`` between two chunks' relative decreases, at their
  geometric mean), frozen factors and PLCA priors: the same ``n_iter`` and
  ``max|Δ|/max|ref| ≤ 1e-5`` for every factor;
* the in-place chunk against the plain eager loop (``_graph=False``): the
  same factors bit for bit, the same verbose reports and progress-handler
  calls in the same order, the loop's host reads; no host read inside a
  chunk (a ``TorchFunctionMode`` that raises on ``.item()``, ``bool()``,
  ``float()`` and host-data tensor factories);
* the sharded, sparse and sparse-target Hoyer fits never build a graph;
  the batched MU and EM fits (``tests/test_torch_compiled_batched.py``) and
  the dense Hoyer fit (``tests/test_torch_compiled_hoyer.py``) build one a
  fit.

CUDA tests (marked ``cuda``; skipped without a card) hold graphed fits
against eager ones on the card: the same ``n_iter``, factors within 1e-6,
one replay for chunks 3 on, the host reads of the two eager chunks and one
more, the kernels' launch counts (the replay's taken on the card) equal
to the eager fit's; every deconv engine; a host-reading updater raises;
nothing the fit took is kept alive after it returns.
``python -m pytest --noconftest -m cuda tests/test_torch_compiled_fits.py``.
"""

import weakref
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.overrides import TorchFunctionMode  # noqa: E402

from pytorch_nmf_tpu_torch.metrics import beta_div, kl_div  # noqa: E402
from pytorch_nmf_tpu_torch.nmf import NMF, NMF2D, NMF3D, NMFD  # noqa: E402
from pytorch_nmf_tpu_torch.ops import (fast_nmf, fast_nmfd, fast_plca,  # noqa: E402
                                       fused_deconv, fused_mu, graphs, solver)
from pytorch_nmf_tpu_torch.plca import PLCA, SIPLCA, SIPLCA2, SIPLCA3  # noqa: E402
from pytorch_nmf_tpu_torch.utils import nmf_from_numpy, plca_from_numpy  # noqa: E402

RTOL = 1e-5
CARD_RTOL = 1e-6
MODELS = {"NMF": NMF, "NMFD": NMFD, "NMF2D": NMF2D, "NMF3D": NMF3D,
          "PLCA": PLCA, "SIPLCA": SIPLCA, "SIPLCA2": SIPLCA2,
          "SIPLCA3": SIPLCA3}
# model → (N, C, S_in, kernel, R); NMF and PLCA: (M, K, R)
SHAPES = {"NMF": (40, 24, 4), "PLCA": (40, 24, 4),
          "NMFD": (1, 12, (60,), (5,), 3), "NMFD2": (2, 12, (60,), (5,), 3),
          "NMF2D": (1, 5, (9, 10), (3, 3), 3),
          "NMF3D": (1, 3, (5, 5, 4), (2, 2, 2), 2),
          "SIPLCA": (1, 12, (60,), (5,), 3),
          "SIPLCA2": (1, 5, (9, 10), (3, 3), 3),
          "SIPLCA3": (1, 3, (5, 5, 4), (2, 2, 2), 2)}
MAX_ITERS = [0, 5, 10, 20, 25, 30, 47]


@pytest.fixture(scope="module")
def jx():
    """The JAX package's models, imported only by the tests that compare
    with it: the CUDA tests need no JAX."""
    pytest.importorskip("jax")
    from pytorch_nmf_tpu.models import nmf, plca

    return SimpleNamespace(models={
        **{n: getattr(nmf, n) for n in ("NMF", "NMFD", "NMF2D", "NMF3D")},
        **{n: getattr(plca, n) for n in ("PLCA", "SIPLCA", "SIPLCA2",
                                         "SIPLCA3")}})


def _model(key):
    return key.rstrip("2") if key == "NMFD2" else key


def _problem(key, seed=0):
    """numpy ``(V, W0, H0)`` (``+ Z0`` for the PLCA family)."""
    rs = np.random.RandomState(seed)
    shape = SHAPES[key]
    if len(shape) == 3:
        M, K, R = shape
        V = np.abs(rs.randn(M, K)).astype("f") + 0.01
        W, H = rs.rand(K, R).astype("f") + 0.1, rs.rand(M, R).astype("f") + 0.1
    else:
        N, C, s_in, kernel, R = shape
        s_out = tuple(s + k - 1 for s, k in zip(s_in, kernel))
        V = rs.rand(N, C, *s_out).astype("f") + 0.01
        W = rs.rand(C, R, *kernel).astype("f") + 0.1
        H = rs.rand(N, R, *s_in).astype("f") + 0.1
    if "PLCA" in key:
        return V, W, H, rs.rand(R).astype("f") + 0.1
    return V, W, H


def _rel(got, ref):
    got, ref = np.asarray(got, "f8"), np.asarray(ref, "f8")
    scale = np.abs(ref).max()
    return float(np.abs(got - ref).max() / scale) if scale else float(
        np.abs(got - ref).max())


def _fit_both(jx, key, trainable=(True, True, True), fit_kw=None, seed=0):
    """The JAX model's ``fit`` and the port's from the same numpy arrays;
    returns ``(port, port_out, ref, ref_out)``."""
    arrays = _problem(key, seed)
    name = _model(key)
    plca = "PLCA" in key
    names = ("W", "H", "Z") if plca else ("W", "H")
    inits = dict(zip(names, arrays[1:]))
    flags = {f"trainable_{n}": t for n, t in zip(names, trainable)}
    ref = jx.models[name](**inits, **flags)
    ref_out = ref.fit(arrays[0], **fit_kw)
    port = (plca_from_numpy(inits, "cpu", *trainable) if plca else
            nmf_from_numpy(inits, "cpu", trainable_W=trainable[0],
                           trainable_H=trainable[1]))
    assert type(port).__name__ == name
    port_out = port.fit(torch.from_numpy(arrays[0]), **fit_kw)
    return port, port_out, ref, ref_out


def _assert_like_jax(port, port_out, ref, ref_out):
    if isinstance(ref_out, tuple):  # PLCA: (n_iter, norm)
        assert port_out[0] == int(ref_out[0])
        assert float(port_out[1]) == pytest.approx(float(ref_out[1]), rel=1e-6)
    else:
        assert port_out == int(ref_out)
    for name in ("W", "H", "Z"):
        p = getattr(port, name, None)
        if p is None:
            continue
        assert _rel(p.detach().numpy(), getattr(ref, name).data) <= RTOL, name


# ---------------------------------------------------------------- CPU: JAX
@pytest.mark.parametrize("key, beta, max_iter", [
    *[("NMF", b, 47) for b in (0, 0.5, 1, 1.5, 2)],
    *[("NMF", b, n) for b in (1, 0.5) for n in MAX_ITERS if n != 47],
    ("NMFD", 1, 20), ("NMFD", 1, 47), ("NMFD2", 1, 30), ("NMFD2", 0.5, 25),
    ("NMF2D", 1, 30), ("NMF3D", 1, 30), ("NMF3D", 2, 25),
])
def test_mu_fit_matches_jax(jx, key, beta, max_iter):
    port, port_out, ref, ref_out = _fit_both(
        jx, key, fit_kw=dict(beta=beta, tol=0, max_iter=max_iter))
    assert port_out == max_iter
    _assert_like_jax(port, port_out, ref, ref_out)


@pytest.mark.parametrize("key, max_iter", [
    *[("PLCA", n) for n in MAX_ITERS],
    ("SIPLCA", 30), ("SIPLCA", 47), ("SIPLCA2", 30), ("SIPLCA3", 25),
])
def test_em_fit_matches_jax(jx, key, max_iter):
    port, port_out, ref, ref_out = _fit_both(
        jx, key, fit_kw=dict(tol=0, max_iter=max_iter))
    assert port_out[0] == max_iter - 1
    _assert_like_jax(port, port_out, ref, ref_out)


def _chunk_losses(key, fit_kw):
    """The port's eager loss before the fit and after each chunk, from its
    verbose reports."""
    arrays = [torch.from_numpy(a) for a in _problem(key)]
    got = []
    solver.push_progress_handler(lambda k, loss, extra: got.append(loss))
    try:
        if "PLCA" in key:
            m = plca_from_numpy(dict(zip("WHZ", _problem(key)[1:])), "cpu")
            V = arrays[0]
            with torch.no_grad():
                init = float(torch.sqrt(2.0 * kl_div(m(norm=V.sum()), V)))
            fit = solver.get_plca_fit(type(m).reconstruct, 0.0, 100, True, True,
                                      True, False, False, False, True,
                                      _graph=False)
            one = V.new_ones(())
            fit(V, m.W.detach(), m.H.detach(), m.Z.detach(), one, one, one)
        else:
            cls = MODELS[_model(key)]
            V, W, H = arrays
            beta = fit_kw["beta"]
            init = float(torch.sqrt(2.0 * beta_div(cls.reconstruct(H, W), V,
                                                   beta)))
            solver.get_dense_fit(cls.reconstruct, beta, 0.0, 100, True, True,
                                 0.0, 0.0, True, _graph=False)(V, W, H)
    finally:
        solver.pop_progress_handler()
    return init, got


def _tol_stopping_at(key, chunk, fit_kw):
    """A ``tol`` at which the fit stops at ``chunk``: the geometric mean of
    that chunk's relative decrease and the smallest before it (2× the first
    chunk's for ``chunk`` 1), so no stop sits near the edge."""
    init, losses = _chunk_losses(key, fit_kw)
    d = -np.diff([init] + losses) / init
    if chunk == 1:
        return 2.0 * d[0]
    before = d[:chunk - 1].min()
    assert d[chunk - 1] < before / 1.5, d[:chunk]
    return float(np.sqrt(d[chunk - 1] * before))


@pytest.mark.parametrize("key, chunk", [
    ("NMF", 1), ("NMF", 2), ("NMF", 4), ("NMFD", 2), ("PLCA", 1),
    ("PLCA", 2), ("PLCA", 4), ("SIPLCA", 2)])
def test_early_stop_matches_jax(jx, key, chunk):
    fit_kw = {} if "PLCA" in key else dict(beta=1)
    tol = _tol_stopping_at(key, chunk, fit_kw)
    fit_kw.update(tol=tol, max_iter=47)
    port, port_out, ref, ref_out = _fit_both(jx, key, fit_kw=fit_kw)
    n = port_out[0] + 1 if "PLCA" in key else port_out
    assert n == 10 * chunk
    _assert_like_jax(port, port_out, ref, ref_out)


@pytest.mark.parametrize("key, trainable, fit_kw", [
    ("NMF", (False, True), dict(beta=0.5, tol=0, max_iter=30)),
    ("NMF", (True, False), dict(beta=1, tol=0, max_iter=35)),
    ("NMFD", (False, True), dict(beta=1, tol=0, max_iter=30)),
    ("PLCA", (True, True, False), dict(tol=0, max_iter=30, W_alpha=1.5,
                                       H_alpha=0.9)),
    ("PLCA", (True, True, True), dict(tol=0, max_iter=36, Z_alpha=1.2)),
    ("SIPLCA", (True, False, True), dict(tol=0, max_iter=30, W_alpha=1.2)),
])
def test_frozen_factors_and_priors_match_jax(jx, key, trainable, fit_kw):
    port, port_out, ref, ref_out = _fit_both(jx, key, trainable, fit_kw)
    _assert_like_jax(port, port_out, ref, ref_out)
    for name, t, x in zip("WHZ", trainable, _problem(key)[1:]):
        if not t and "PLCA" not in key:  # PLCA normalizes at construction
            np.testing.assert_array_equal(getattr(port, name).detach().numpy(),
                                          x)


# ------------------------------------------- CPU: in place against eager
def _run_fit(key, device, graph, tol, max_iter, verbose=False, beta=1.0,
             factory="model", engine=None, dtype=torch.float32):
    """A dense or EM fit through ``get_dense_fit``/``get_plca_fit``, as the
    models build it (``factory="model"``: the model's resolved updaters)."""
    arrays = [torch.from_numpy(a).to(device, dtype) for a in _problem(key)]
    cls = MODELS[_model(key)]
    if "PLCA" in key:
        V, W, H, Z = arrays
        m = plca_from_numpy({"W": W.cpu().numpy(), "H": H.cpu().numpy(),
                             "Z": Z.cpu().numpy()}, device)
        W, H, Z = (p.detach().to(dtype) for p in (m.W, m.H, m.Z))
        fit = solver.get_plca_fit(cls._resolve_fit_recon3(V, W, H, Z), tol,
                                  max_iter, True, True, True, False, False,
                                  False, verbose, em_engine=engine,
                                  _graph=graph)
        one = V.new_ones(())
        return fit(V, W, H, Z, one, one, one)
    V, W, H = arrays
    if factory == "model":
        factory = cls._resolve_updater_factory(V, W, H, beta)
    fit = solver.get_dense_fit(cls.reconstruct, beta, tol, max_iter, True,
                               True, 0.0, 0.0, verbose, factory, _graph=graph)
    return fit(V, W, H)


def _outputs(out):
    return [x for x in out if isinstance(x, torch.Tensor)], [
        x for x in out if not isinstance(x, torch.Tensor)]


IN_PLACE_CASES = [
    ("NMF", dict(beta=1.0)), ("NMF", dict(beta=0.5)), ("NMF", dict(beta=2.0)),
    ("NMF", dict(beta=1.5, factory=None)),
    ("NMFD", dict(beta=1.0)),
    ("NMFD2", dict(beta=0.5, factory=fast_nmfd.deconv_updater_factory_fused(1))),
    ("NMF2D", dict(beta=1.0, factory=fast_nmfd.deconv_updater_factory_fused(2))),
    ("NMF3D", dict(beta=1.0)),
    ("PLCA", {}), ("PLCA", dict(engine=fast_plca.plca_em_engine_plain)),
    ("SIPLCA", {}), ("SIPLCA2", {}), ("SIPLCA3", {}),
]


@pytest.mark.parametrize("key, kw", IN_PLACE_CASES,
                         ids=[f"{k}-{i}" for i, (k, _) in
                              enumerate(IN_PLACE_CASES)])
@pytest.mark.parametrize("verbose", [False, True])
def test_in_place_chunks_equal_the_eager_loop(key, kw, verbose):
    solver.compiled_cache_clear()  # the graphed fit is a cold one
    runs = {}
    for graph in (True, False):
        calls = []
        solver.push_progress_handler(lambda *a: calls.append(a))
        reads = solver._read.reads
        try:
            out = _run_fit(key, "cpu", graph, 0.0, 47, verbose, **kw)
        finally:
            solver.pop_progress_handler()
        runs[graph] = (out, calls, solver._read.reads - reads)
    (tg, og), (te, oe) = _outputs(runs[True][0]), _outputs(runs[False][0])
    assert og == oe
    for a, b in zip(tg, te):
        assert torch.equal(a, b)
    assert runs[True][1] == runs[False][1]
    assert len(runs[True][1]) == (4 if verbose else 0)
    per_chunk = 1 + verbose * (2 if "PLCA" in key else 1)
    assert runs[False][2] == 4 * per_chunk
    # the device loop reads its flag before each chunk of a call and once
    # after its last (chunks 1 and 2 a call each, as the card's warm-ups;
    # a reporting fit every chunk), and the fit reads (k, stop) once; a
    # reporting fit reads (k, stop) and its values after each chunk
    assert runs[True][2] == (4 * (per_chunk + 2) if verbose
                             else 2 + 2 + 3 + 1)


@pytest.mark.parametrize("key, chunk", [("NMF", 1), ("NMF", 2), ("NMF", 4),
                                        ("PLCA", 3)])
def test_in_place_chunks_stop_where_the_eager_loop_stops(key, chunk):
    kw = {} if "PLCA" in key else dict(beta=1.0)
    tol = _tol_stopping_at(key, chunk, kw)
    outs = [_run_fit(key, "cpu", graph, tol, 47, **kw) for graph in (True, False)]
    (tg, og), (te, oe) = _outputs(outs[0]), _outputs(outs[1])
    assert og == oe and og[0] + ("PLCA" in key) == 10 * chunk
    for a, b in zip(tg, te):
        assert torch.equal(a, b)


_HOST_DATA = {torch.tensor, torch.from_numpy}
_HOST_READS = {torch.Tensor.item, torch.Tensor.__bool__,
               torch.Tensor.__float__, torch.Tensor.__int__,
               torch.Tensor.__index__, torch.Tensor.tolist,
               torch.Tensor.numpy, torch.Tensor.cpu}


class _NoHostTraffic(TorchFunctionMode):
    """Raises on what would read the card's values on the host, or copy
    host data to it, on a CUDA tensor; except while ``allowed``: the
    device loop's own test of its flag between chunks
    (``graphs._host_read``, which a replay makes on the card)."""

    allowed = False

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if not _NoHostTraffic.allowed and (
                func in _HOST_READS or func in _HOST_DATA or (
                    func is torch.as_tensor
                    and not isinstance(args[0], torch.Tensor))):
            raise AssertionError(f"host traffic inside a chunk: {func}")
        return func(*args, **(kwargs or {}))


def _allowed(fn):
    def call(*args):
        _NoHostTraffic.allowed = True
        try:
            return fn(*args)
        finally:
            _NoHostTraffic.allowed = False

    return call


class _GuardedGraphs(graphs._Graphs):
    def __call__(self, k=0):
        with _NoHostTraffic():
            super().__call__(k)
        _GuardedGraphs.calls += 1


@pytest.mark.parametrize("key, kw", IN_PLACE_CASES,
                         ids=[f"{k}-{i}" for i, (k, _) in
                              enumerate(IN_PLACE_CASES)])
def test_chunks_do_no_host_traffic(monkeypatch, key, kw):
    monkeypatch.setattr(solver, "_Graphs", _GuardedGraphs)
    monkeypatch.setattr(graphs, "_host_read", _allowed(graphs._host_read))
    solver.compiled_cache_clear()  # a cold fit
    _GuardedGraphs.calls = 0
    _run_fit(key, "cpu", True, 0.0, 30, True, **kw)
    assert _GuardedGraphs.calls == 3


def test_graphs_module_counts_and_modes():
    """The counters' delta is kept per workload; the CPU calls directly."""
    hits = []
    g = graphs._Graphs([lambda: hits.append(1)], None, torch.device("cpu"),
                       "message")
    before = graphs._Graphs.replays
    for _ in range(3):
        g()
    assert hits == [1, 1, 1] and graphs._Graphs.replays == before
    counts = graphs._read_counters()
    graphs._add_counters([1] * len(counts))
    assert graphs._read_counters() == [c + 1 for c in counts]
    graphs._add_counters([-1] * len(counts))
    assert graphs._read_counters() == counts
    with pytest.raises(ValueError, match="device"):
        graphs._Graphs([], None, torch.device("meta"), "message")


def _raising(*args, **kwargs):
    raise AssertionError("a graph was built")


def test_sharded_sparse_hoyer_and_batched_fits_stay_eager(monkeypatch):
    """The halo fits stay eager (the sharded NMF, PLCA and sparse fits run
    the graphed loop: tests/test_torch_compiled_sharded.py); the sparse
    fits (each tier), the Hoyer fits (dense and sparse targets) and the
    batched MU and EM fits go through _Graphs, one instance a cache entry,
    each with device loops (the chunk loop's, the Hoyer line search's)."""
    from pytorch_nmf_tpu_torch.ops import sparse
    from pytorch_nmf_tpu_torch.parallel import halo, sharded, sharded_sparse

    assert halo._converging_loop is solver._converging_loop
    assert not hasattr(halo, "_graphed_loop")
    assert sharded._graphed_loop is solver._graphed_loop
    assert sharded_sparse._run_fit is sharded._run_fit
    monkeypatch.setattr(solver, "_Graphs", _raising)
    V, W, H = (torch.from_numpy(a) for a in _problem("NMF"))
    state, k, conv = solver._converging_loop(
        lambda s: (s[0] * 0.99, s[1]), lambda s: s[0].sum(), (W, H), 0.0, 30)
    assert k == 3 and not conv
    made = []

    class Recording(graphs._Graphs):
        def __init__(self, *args, **kwargs):
            made.append(kwargs.get("conditional", False))
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(solver, "_Graphs", Recording)
    Vs = V.to_sparse().coalesce()
    for tier in ("densify", "gather"):
        fit = solver.get_sparse_fit(sparse.nmf_sp_pos_neg, 1.0, 0.0, 30, True,
                                    True, 0.0, 0.0, False, tier,
                                    NMF.reconstruct)
        assert fit(Vs, W, H)[2] == 30
    ell = sparse.build_ell(Vs)
    fit = solver.get_sparse_fit(sparse.nmf_sp_pos_neg, 1.0, 0.0, 30, True,
                                True, 0.0, 0.0, False, "ell")
    assert fit(ell, W, H)[2] == 30
    assert made == [True] * 3
    hoyer = solver.get_hoyer_fit(None, sparse.nmf_sp_pos_neg, 2.0, 20, True,
                                 True, 0.5, None, W.shape[0], H.shape[0])
    assert hoyer(Vs, W, H)[2] == 20
    assert made == [True] * 4
    bat = solver.get_batched_dense_fit(NMF.reconstruct, 1.0, 0.0, 30, True,
                                       True, 0.0, 0.0)
    assert bat(V[None], W[None], H[None])[2].tolist() == [30]
    assert made == [True] * 5
    Vp, Wp, Hp, Zp = (torch.from_numpy(a) for a in _problem("PLCA"))
    batp = solver.get_batched_plca_fit(PLCA.reconstruct, 0.0, 30, True, True,
                                       True, False, False, False)
    one = Vp.new_ones(())
    assert batp(Vp[None], Wp[None], Hp[None], Zp[None], one, one,
                one)[3].tolist() == [29]
    assert made == [True] * 6
    dense = solver.get_hoyer_fit(NMF.reconstruct, None, 2.0, 20, True, True,
                                 0.5, None, W.shape[0], H.shape[0])
    assert dense(V, W, H)[2] == 20 and made == [True] * 7


@pytest.mark.parametrize("key", ["NMF", "NMFD", "PLCA", "SIPLCA"])
def test_nothing_outlives_the_fit_on_the_cpu(key):
    _nothing_outlives_the_fit(key, "cpu")


def _nothing_outlives_the_fit(key, device):
    arrays = _problem(key)
    V = torch.from_numpy(arrays[0]).to(device)
    names = "WHZ" if "PLCA" in key else "WH"
    inits = dict(zip(names, arrays[1:]))
    m = (plca_from_numpy(inits, device) if "PLCA" in key
         else nmf_from_numpy(inits, device))
    dead = weakref.ref(V)
    m.fit(V, tol=0, max_iter=40)
    del V
    assert dead() is None


# ---------------------------------------------------------------- CUDA
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # each test's first graphed fit of a configuration is a cold one
    solver.compiled_cache_clear()
    return "cuda"


def _card_rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _counts():
    return (fused_mu.fused_contractions.launches,
            fused_mu.fused_beta_loss.launches, fused_deconv.hgrad.launches,
            fused_deconv.wgrad.launches)


def _card_pair(key, cuda, tol, max_iter, **kw):
    """The graphed and the eager fit on the card: ``{graph: (out, counts,
    replays, reads)}``."""
    res = {}
    for graph in (True, False):
        c0, r0, h0 = _counts(), graphs._Graphs.replays, solver._read.reads
        out = _run_fit(key, cuda, graph, tol, max_iter, **kw)
        torch.cuda.synchronize()
        res[graph] = (out, [a - b for a, b in zip(_counts(), c0)],
                      graphs._Graphs.replays - r0, solver._read.reads - h0)
    return res


CARD_CASES = [("NMF", dict(beta=b)) for b in (0.5, 1.0, 2.0, 1.5)] + [
    ("NMFD", dict(beta=1.0)), ("NMFD2", dict(beta=0.5)),
    ("NMF2D", dict(beta=1.0)), ("NMF3D", dict(beta=1.0)), ("PLCA", {}),
    ("PLCA", dict(engine=fast_plca.plca_em_engine_fused)),
    ("SIPLCA", {}), ("SIPLCA2", {}), ("SIPLCA3", {})]


@pytest.mark.cuda
@pytest.mark.parametrize("key, kw", CARD_CASES,
                         ids=[f"{k}-{i}" for i, (k, _) in enumerate(CARD_CASES)])
@pytest.mark.parametrize("max_iter", [20, 30, 47, 100])
def test_cuda_graphed_fit_matches_eager(cuda, key, kw, max_iter):
    res = _card_pair(key, cuda, 0.0, max_iter, **kw)
    (tg, og), (te, oe) = _outputs(res[True][0]), _outputs(res[False][0])
    assert og == oe
    for a, b in zip(tg, te):
        assert a.is_cuda and _card_rel(a, b) <= CARD_RTOL
    chunks = max_iter // 10
    # a cold fit: chunks 1-2 eager (the loop's flag read before and after
    # each), the capture, one replay for the rest; one read of (k, stop)
    assert res[True][2] == (chunks > 2) and res[False][2] == 0
    assert res[True][3] == 2 + 2 + 1 and res[False][3] == chunks
    assert res[True][1] == res[False][1]


@pytest.mark.cuda
@pytest.mark.parametrize("key", ["NMF", "PLCA"])
def test_cuda_graphed_fit_stops_where_eager_stops(cuda, key):
    kw = {} if key == "PLCA" else dict(beta=1.0)
    res = _card_pair(key, cuda, 1e-3, 200, **kw)
    (tg, og), (te, oe) = _outputs(res[True][0]), _outputs(res[False][0])
    assert og == oe
    for a, b in zip(tg, te):
        assert _card_rel(a, b) <= CARD_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["fused", "fused_w", "unfold", "plain",
                                    "fft", "autocorr"])
def test_cuda_every_deconv_engine_captures(cuda, engine):
    beta = 2.0 if engine in ("fft", "autocorr") else 1.0
    factory = {"fft": fast_nmfd.nmfd_fft_updater_factory,
               "autocorr": fast_nmfd.nmfd_autocorr_updater_factory}.get(engine)
    if factory is None:
        factory = getattr(fast_nmfd, f"deconv_updater_factory_{engine}")(1)
    res = _card_pair("NMFD", cuda, 0.0, 40, beta=beta, factory=factory)
    (tg, og), (te, oe) = _outputs(res[True][0]), _outputs(res[False][0])
    assert og == oe and res[True][2] == 1
    for a, b in zip(tg, te):
        assert _card_rel(a, b) <= CARD_RTOL
    assert res[True][1] == res[False][1]


@pytest.mark.cuda
def test_cuda_bf16_target_graphed(cuda):
    arrays = _problem("NMF")
    V = torch.from_numpy(arrays[0]).to(cuda).bfloat16()
    out = []
    for graph in (True, False):
        W, H = (torch.from_numpy(a).to(cuda) for a in arrays[1:])
        factory = NMF._resolve_updater_factory(V, W, H, 0.5)
        out.append(solver.get_dense_fit(NMF.reconstruct, 0.5, 0.0, 40, True,
                                        True, 0.0, 0.0, False, factory,
                                        _graph=graph)(V, W, H))
    assert out[0][2] == out[1][2] == 40
    for a, b in zip(out[0][:2], out[1][:2]):
        assert _card_rel(a, b) <= CARD_RTOL


@pytest.mark.cuda
def test_cuda_host_reading_updater_raises(cuda):
    V, W, H = (torch.from_numpy(a).to(cuda) for a in _problem("NMF"))

    def factory(beta, gamma, l1_reg, l2_reg):
        upd_W, upd_H, loss = fast_nmf.nmf_updater_factory_fused(
            beta, gamma, l1_reg, l2_reg)

        def reading(V, W, H):
            if float(W.sum()) < 0:  # a host read
                raise AssertionError
            return upd_W(V, W, H)

        return reading, upd_H, loss

    with pytest.raises(RuntimeError, match="cannot be captured"):
        solver.get_dense_fit(NMF.reconstruct, 1.0, 0.0, 30, True, True, 0.0,
                             0.0, False, factory)(V, W, H)
    _, _, n = solver.get_dense_fit(NMF.reconstruct, 1.0, 0.0, 30, True, True,
                                   0.0, 0.0, False, factory,
                                   _graph=False)(V, W, H)
    assert n == 30


@pytest.mark.cuda
@pytest.mark.parametrize("key", ["NMF", "NMFD", "PLCA", "SIPLCA"])
def test_cuda_nothing_outlives_the_fit(cuda, key):
    _nothing_outlives_the_fit(key, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("key", ["NMF", "NMFD", "PLCA", "SIPLCA"])
def test_cuda_graphed_fits_keep_no_memory(cuda, key):
    """A graphed fit keeps only its cache entry on the card: fits that
    differ only in ``max_iter`` share it, so none after the first adds
    anything, and ``compiled_cache_clear`` (then ``empty_cache``) gives the
    card back its allocated (and reserved) memory."""
    arrays = _problem(key)
    V = torch.from_numpy(arrays[0]).to(cuda)
    names = "WHZ" if "PLCA" in key else "WH"
    inits = dict(zip(names, arrays[1:]))
    m = (plca_from_numpy(inits, cuda) if "PLCA" in key
         else nmf_from_numpy(inits, cuda))
    m.fit(V, tol=0, max_iter=40)  # builds, workspaces, lazy imports
    solver.compiled_cache_clear()
    # cuBLAS keeps a workspace for each stream that ran a product eagerly
    # (a hit's initial loss): not the fit's; dropped before each reading
    clear_workspaces = torch._C._cuda_clearCublasWorkspaces
    torch.cuda.synchronize()
    clear_workspaces()
    torch.cuda.empty_cache()
    allocated, reserved = torch.cuda.memory_allocated(), \
        torch.cuda.memory_reserved()
    after = []
    for max_iter in (40, 50, 30, 40, 50, 30):
        m.fit(V, tol=0, max_iter=max_iter)
        torch.cuda.synchronize()
        clear_workspaces()
        after.append(torch.cuda.memory_allocated())
    assert allocated < after[0]
    assert after[1:] == [after[0]] * 5  # hits
    solver.compiled_cache_clear()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == allocated
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved() == reserved


@pytest.mark.cuda
def test_cuda_models_fit_graphed(cuda):
    """The models and ``functional`` take the graphed loop: a 50-iteration
    fit replays once (chunks 3-5), and the same fit through ``functional``
    on the same target is a cache hit that replays once (all 5)."""
    from pytorch_nmf_tpu_torch import functional

    V, W, H = (torch.from_numpy(a).to(cuda) for a in _problem("NMF"))
    r0 = graphs._Graphs.replays
    m = nmf_from_numpy({"W": W.cpu().numpy(), "H": H.cpu().numpy()}, cuda)
    assert m.fit(V, beta=1, tol=0, max_iter=50) == 50
    assert graphs._Graphs.replays - r0 == 1
    _, _, n = functional.nmf_fit(V, W, H, beta=1, tol=0, max_iter=50)
    assert n == 50 and graphs._Graphs.replays - r0 == 2

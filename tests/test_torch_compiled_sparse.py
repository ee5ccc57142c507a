"""The sparse fits' compiled execution: the sparse MU fit (each tier:
densify, ELL, gather) runs its chunk loop as one in-place workload
(``ops/solver._graphed_loop``), as the dense fits do: chunks 1-2 eagerly
and one replay of a CUDA graph for the rest (the loop a WHILE node), on
the card; the sparse-target Hoyer fit its 10-iteration chunk
(``_graphed_hoyer_loop``), a replay a chunk from chunk 3 on; called
directly on the CPU.

CPU tests: the graphed fit and the eager loop (``_graph=False``) against
the JAX package's jitted fits (``NMF.fit`` on a sparse target, each tier
forced through the switches both packages read; ``NMF.sparse_fit`` on a
sparse target, whose pair is ``pos_neg``) from shared numpy inits, the
same ``n_iter`` and ``max|Δ|/max|ref| ≤ 1e-5``; graphed against eager bit
for bit; no host read inside a chunk.  One intra-op thread: these small
fits run several times faster on it.

CUDA tests (marked ``cuda``; skipped without a card): graphed against
``_graph=False`` on the card, replays and captures counted, the gather
tier's scatter-adds within 1e-4 and the same ``n_iter`` at ``tol=1e-4``.
``python -m pytest --noconftest -m cuda tests/test_torch_compiled_sparse.py``.
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.overrides import TorchFunctionMode  # noqa: E402

from pytorch_nmf_tpu_torch.nmf import NMF  # noqa: E402
from pytorch_nmf_tpu_torch.ops import graphs, solver, sparse  # noqa: E402
from pytorch_nmf_tpu_torch.utils import nmf_from_numpy  # noqa: E402

RTOL = 1e-5
TIERS = {  # tier → the environment that forces it in both packages
    "densify": {"PNT_SPARSE_DENSIFY": "1"},
    "ell": {"PNT_SPARSE_DENSIFY": "0", "PNT_SPARSE_ELL": "1",
            "PNT_SPARSE_ELL_MAX_PAD": "1e9"},
    "gather": {"PNT_SPARSE_DENSIFY": "0", "PNT_SPARSE_ELL": "0"},
}
BETAS = [0.5, 1.0, 1.5, 2.0]
MAX_ITERS = [0, 5, 10, 25, 47]


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's NMF and sparse module, imported only by the tests
    that compare with it: the CUDA tests need no JAX."""
    pytest.importorskip("jax")
    from pytorch_nmf_tpu.models import nmf
    from pytorch_nmf_tpu.ops import sparse as jsparse

    return SimpleNamespace(NMF=nmf.NMF, sparse=jsparse)


def _problem(M=36, K=28, R=3, keep=0.8, seed=0):
    rs = np.random.RandomState(seed)
    V = rs.rand(M, K).astype("f")
    V = np.where(V > keep, V, 0.0).astype("f")
    return V, rs.rand(K, R).astype("f") + 0.1, rs.rand(M, R).astype("f") + 0.1


def _hoyer_problem(seed=4):
    """``tests/test_torch_hoyer.py``'s sparse target (40×30, R=5, the
    entries of ``rand + 0.01`` above 0.6), whose line searches decide no
    step at the edge of float32 rounding."""
    rs = np.random.RandomState(seed)
    V, W0, H0 = (rs.rand(*s).astype("f") + off for s, off in zip(
        ((40, 30), (30, 5), (40, 5)), (0.01, 0.1, 0.1)))
    return np.where(V > 0.6, V, 0).astype("f"), W0, H0


def _set_tier(monkeypatch, tier):
    for name in ("PNT_SPARSE_DENSIFY", "PNT_SPARSE_ELL",
                 "PNT_SPARSE_ELL_MAX_PAD"):
        monkeypatch.delenv(name, raising=False)
    for name, value in TIERS[tier].items():
        monkeypatch.setenv(name, value)


def _rel(got, ref):
    got, ref = np.asarray(got, "f8"), np.asarray(ref, "f8")
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _sparse_fit(V, W0, H0, tier, beta, tol, max_iter, graph, device="cpu"):
    """``get_sparse_fit`` as ``NMF.fit`` builds it for ``tier``."""
    Vs = sparse.sparse_from_dense(torch.from_numpy(V).to(device))
    W, H = (torch.from_numpy(x).to(device) for x in (W0, H0))
    target = sparse.build_ell(Vs) if tier == "ell" else Vs
    factory = (NMF._resolve_updater_factory(Vs, W, H, beta)
               if tier == "densify" else None)
    fit = solver.get_sparse_fit(NMF._sp_pos_neg, beta, tol, max_iter, True,
                                True, 0.0, 0.0, False, tier, NMF.reconstruct,
                                factory, _graph=graph)
    return fit(target, W, H)


@pytest.mark.parametrize("max_iter", MAX_ITERS)
@pytest.mark.parametrize("beta", BETAS)
@pytest.mark.parametrize("tier", list(TIERS))
def test_sparse_fit_matches_jax(jx, monkeypatch, tier, beta, max_iter):
    V, W0, H0 = _problem(seed=1)
    _set_tier(monkeypatch, tier)
    ref = jx.NMF(W=W0, H=H0)
    ref_n = int(ref.fit(jx.sparse.sparse_from_dense(V), beta=beta, tol=0,
                        max_iter=max_iter))
    port = nmf_from_numpy({"W": W0, "H": H0}, "cpu")
    assert port.fit(sparse.sparse_from_dense(V), beta=beta, tol=0,
                    max_iter=max_iter) == ref_n == max_iter
    outs = [_sparse_fit(V, W0, H0, tier, beta, 0.0, max_iter, graph)
            for graph in (True, False)]
    for W, H, n in outs:
        assert n == ref_n
        assert _rel(W.numpy(), ref.W.data) <= RTOL
        assert _rel(H.numpy(), ref.H.data) <= RTOL
    for a, b in zip(outs[0][:2], outs[1][:2]):
        assert torch.equal(a, b)
    assert torch.equal(port.W.detach(), outs[0][0])


@pytest.mark.parametrize("tier", list(TIERS))
def test_sparse_fit_stops_like_jax(jx, monkeypatch, tier):
    V, W0, H0 = _problem(seed=2)
    _set_tier(monkeypatch, tier)
    ref = jx.NMF(W=W0, H=H0)
    ref_n = int(ref.fit(jx.sparse.sparse_from_dense(V), beta=1, tol=1e-3,
                        max_iter=200))
    outs = [_sparse_fit(V, W0, H0, tier, 1.0, 1e-3, 200, graph)
            for graph in (True, False)]
    assert outs[0][2] == outs[1][2] == ref_n < 200
    for a, b, r in zip(outs[0][:2], outs[1][:2], (ref.W.data, ref.H.data)):
        assert torch.equal(a, b) and _rel(a.numpy(), r) <= RTOL


@pytest.mark.parametrize("kw", [dict(beta=1, sW=0.5), dict(beta=1.5, sH=0.5),
                                dict(beta=2, sW=0.4, sH=0.6)],
                         ids=["b1-sW", "b1.5-sH", "b2-sWsH"])
@pytest.mark.parametrize("max_iter", [5, 25, 47])
def test_sparse_hoyer_fit_matches_jax(jx, kw, max_iter):
    V, W0, H0 = _hoyer_problem()
    ref = jx.NMF(W=W0, H=H0)
    ref.sparse_fit(jx.sparse.sparse_from_dense(V), max_iter=max_iter, **kw)
    port = nmf_from_numpy({"W": W0, "H": H0}, "cpu")
    assert port.sparse_fit(sparse.sparse_from_dense(V), max_iter=max_iter,
                           **kw) == max_iter
    assert _rel(port.W.detach().numpy(), ref.W.data) <= RTOL
    assert _rel(port.H.detach().numpy(), ref.H.data) <= RTOL
    Vs = sparse.sparse_from_dense(V)
    W, H = torch.from_numpy(W0), torch.from_numpy(H0)
    outs = [solver.get_hoyer_fit(
        None, NMF._sp_pos_neg, float(kw["beta"]), max_iter, True, True,
        kw.get("sW"), kw.get("sH"), W.shape[0], H.shape[0], _graph=graph)(
            Vs, W, H) for graph in (True, False)]
    for a, b, p in zip(outs[0][:2], outs[1][:2], (port.W, port.H)):
        assert torch.equal(a, b) and torch.equal(a, p.detach())


class _NoHostTraffic(TorchFunctionMode):
    """Raises on what would read the card's values on the host, except
    while ``allowed``: inside the device loop's own counted read
    (``graphs._host_read``) and the CPU's plain projection (P1 reads
    nothing on the card)."""

    READS = {torch.Tensor.item, torch.Tensor.__bool__, torch.Tensor.__float__,
             torch.Tensor.__int__, torch.Tensor.__index__,
             torch.Tensor.tolist, torch.Tensor.numpy, torch.Tensor.cpu}
    allowed = False

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if not _NoHostTraffic.allowed and (
                func in self.READS or func in (torch.tensor,
                                               torch.from_numpy)):
            raise AssertionError(f"host traffic inside a chunk: {func}")
        return func(*args, **(kwargs or {}))


def _guard(monkeypatch):
    """Every chunk under :class:`_NoHostTraffic`; returns the list of the
    chunks called."""
    calls = []

    class Guarded(graphs._Graphs):
        def __call__(self, k=0):
            with _NoHostTraffic():
                super().__call__(k)
            calls.append(k)

    monkeypatch.setattr(solver, "_Graphs", Guarded)
    solver.compiled_cache_clear()  # a cold fit: chunks 1-2 a call each
    return calls


def _allowed(fn):
    def call(*args):
        _NoHostTraffic.allowed = True
        try:
            return fn(*args)
        finally:
            _NoHostTraffic.allowed = False

    return call


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("beta", [1.0, 1.5])
def test_sparse_chunks_do_no_host_traffic(monkeypatch, tier, beta):
    calls = _guard(monkeypatch)
    monkeypatch.setattr(graphs, "_host_read", _allowed(graphs._host_read))
    V, W0, H0 = _problem(seed=4)
    # a spill on both ELL sides: the hybrid's remainder reductions run too
    V[3] = 0.5
    V[:, 4] = 0.5
    monkeypatch.setattr(sparse, "_ell_cap", lambda nnz, n, f=None: 2)
    _sparse_fit(V, W0, H0, tier, beta, 0.0, 30, True)
    assert calls == [0, 0, 0]


def test_sparse_hoyer_chunks_read_the_host_only_through_the_loop(
        monkeypatch):
    from pytorch_nmf_tpu_torch.ops import projection

    calls = _guard(monkeypatch)
    monkeypatch.setattr(graphs, "_host_read", _allowed(graphs._host_read))
    monkeypatch.setattr(projection, "plain_proj_rows",
                        _allowed(projection.plain_proj_rows))
    V, W0, H0 = _problem(seed=5)
    W, H = torch.from_numpy(W0), torch.from_numpy(H0)
    fit = solver.get_hoyer_fit(None, NMF._sp_pos_neg, 2.0, 30, True, True,
                               0.5, 0.5, W.shape[0], H.shape[0])
    assert fit(sparse.sparse_from_dense(V), W, H)[2] == 30
    assert calls == [0, 0, 0]


# ---------------------------------------------------------------- CUDA
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    solver.compiled_cache_clear()
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("beta", [1.0, 1.5, 0.5, 2.0])
@pytest.mark.parametrize("tier", list(TIERS))
def test_cuda_sparse_fit_graphed_matches_eager(cuda, tier, beta):
    V, W0, H0 = _problem(M=300, K=200, R=8, keep=0.9, seed=6)
    res = {}
    for graph in (True, False):
        r0, c0 = graphs._Graphs.replays, graphs._Graphs.captures
        out = _sparse_fit(V, W0, H0, tier, beta, 0.0, 50, graph, cuda)
        torch.cuda.synchronize()
        res[graph] = (out, graphs._Graphs.replays - r0,
                      graphs._Graphs.captures - c0)
    (g, rg, cg), (e, re_, ce) = res[True], res[False]
    assert g[2] == e[2] == 50
    assert (rg, cg) == (1, 1) and (re_, ce) == (0, 0)  # chunks 3-5: one
    for a, b in zip(g[:2], e[:2]):
        if tier == "gather":  # scatter-adds by atomics
            assert float((a - b).abs().max() / b.abs().max()) <= 1e-4
        else:
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_gather_tier_stops_where_eager_stops(cuda):
    V, W0, H0 = _problem(M=300, K=200, R=8, keep=0.9, seed=7)
    outs = [_sparse_fit(V, W0, H0, "gather", 1.0, 1e-4, 300, graph, cuda)
            for graph in (True, False)]
    assert outs[0][2] == outs[1][2]
    for a, b in zip(outs[0][:2], outs[1][:2]):
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-4


@pytest.mark.cuda
def test_cuda_sparse_hoyer_fit_graphed_matches_eager(cuda):
    V, W0, H0 = _problem(M=300, K=200, R=8, keep=0.9, seed=8)
    Vs = sparse.sparse_from_dense(torch.from_numpy(V).to(cuda))
    W, H = (torch.from_numpy(x).to(cuda) for x in (W0, H0))
    outs = []
    for graph in (True, False):
        r0 = solver._backtrack_project.reads
        outs.append(solver.get_hoyer_fit(
            None, NMF._sp_pos_neg, 2.0, 40, True, True, 0.5, None,
            W.shape[0], H.shape[0], _graph=graph)(Vs, W, H))
        outs[-1] += (solver._backtrack_project.reads - r0,)
    for a, b in zip(outs[0][:2], outs[1][:2]):
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-4
    # chunks 1-2 eager (one read an attempt), chunks 3-4 replayed (none)
    assert 0 < outs[0][3] < outs[1][3]

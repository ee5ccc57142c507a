"""The batched Hoyer fit as one batched program (``ops/solver.
get_batched_hoyer_fit``; ``functional.nmf_hoyer_fit_batched``): the JAX
package's ``vmap`` of the single fit.  Each problem's loss and line search
are its own (``_batched_backtrack_project``: a problem takes a round's step
only while its last attempt was worse and it made fewer than 10), every
projection of the batch is one call over all B·R rank columns (one P1
launch on the card), and the chunk loop runs through ``_graphed_hoyer_loop``:
one capture a fit, the loop a CUDA-graph WHILE node whose body holds the
rounds 2-10 as WHILE nodes on "any problem is active".

CPU tests:

* the port's batched fit against the JAX package's jitted
  ``nmf_hoyer_fit_batched`` (numpy seeds): NMF and NMFD with ``sW``,
  ``sH`` and both, ``max_iter`` ∈ {0, 9, 10, 30}: the same ``n_iter`` and
  ``max|Δ|/max|ref| ≤ 1e-5`` for each factor;
* the chunked loop against the eager one (``_graph=False``): the same
  factors bit for bit, each problem's attempts, the rounds and the host
  reads; a chunk reads the host only through the loop's own counted reads
  (a ``TorchFunctionMode`` that raises on any other);
* each problem of an NMF batch equal to its single fit, with its attempts.

CUDA tests (marked ``cuda``; skipped without a card): graphed against
eager on the card bit for bit, each problem's attempts, one capture a fit,
one replay of the chunk loop after two eager chunks (a warm fit one replay
and no host read), P1 launches equal to the constrained factors plus
the rounds (not × B), line-search host reads only in the eager chunks,
allocated memory flat over three fits.
``python -m pytest --noconftest -m cuda tests/test_torch_compiled_batched_hoyer.py``.
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.func import vmap  # noqa: E402
from torch.overrides import TorchFunctionMode  # noqa: E402

from pytorch_nmf_tpu_torch import functional as F  # noqa: E402
from pytorch_nmf_tpu_torch.nmf import NMF, NMFD  # noqa: E402
from pytorch_nmf_tpu_torch.ops import graphs, projection, solver  # noqa: E402

RTOL = 1e-5
SPARSENESS = [dict(sW=0.5), dict(sH=0.5), dict(sW=0.5, sH=0.4)]
KW_IDS = ["+".join(kw) for kw in SPARSENESS]
MODELS = {"NMF": NMF, "NMFD": NMFD}


@pytest.fixture(scope="module")
def jx():
    """The JAX package's functional API and models, imported only by the
    tests that compare with it: the CUDA tests need no JAX."""
    pytest.importorskip("jax")
    from pytorch_nmf_tpu import functional
    from pytorch_nmf_tpu.models import nmf

    return SimpleNamespace(F=functional, models={"NMF": nmf.NMF,
                                                 "NMFD": nmf.NMFD})


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these small fits are many small operations,
    which more threads only slow down (several times over when the workers
    of a parallel test run share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(name, seed=8):
    """numpy ``(V, W0, H0)`` of a batch: every array ``rand`` plus 0.01 (V)
    or 0.1 (the factors)."""
    rs = np.random.RandomState(seed)
    shapes = (((4, 30, 20), (4, 20, 3), (4, 30, 3)) if name == "NMF"
              else ((3, 1, 12, 60), (3, 12, 3, 5), (3, 1, 3, 56)))
    return tuple(rs.rand(*s).astype("f") + off
                 for s, off in zip(shapes, (0.01, 0.1, 0.1)))


def _rel(got, ref):
    got, ref = np.asarray(got, "f8"), np.asarray(ref, "f8")
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _fit(name, device, graph, max_iter, kw, seed=8):
    """The batched fit as ``functional`` builds it, with ``_graph``: ``(W,
    H, n_iter, attempts)``."""
    V, W, H = (torch.from_numpy(a).to(device) for a in _problem(name, seed))
    cls = MODELS[name]
    fit = solver.get_batched_hoyer_fit(
        cls.reconstruct if name == "NMF" else vmap(cls.reconstruct), 2.0,
        max_iter, True, True, kw.get("sW"), kw.get("sH"),
        W[0].numel() // W.shape[2], H[0].numel() // H.shape[2], _graph=graph)
    return fit(V, W, H, _attempts=True)


def _counts():
    bt = solver._batched_backtrack_project
    return (bt.rounds, bt.reads, projection.proj_rows.launches,
            solver._backtrack_project.attempts)


def _both_ways(name, device, max_iter, kw):
    """``{graph: (out, counts' increase)}``."""
    runs = {}
    for graph in (True, False):
        c0 = _counts()
        out = _fit(name, device, graph, max_iter, kw)
        if device != "cpu":
            torch.cuda.synchronize()
        runs[graph] = (out, [a - b for a, b in zip(_counts(), c0)])
    return runs


# ---------------------------------------------------------------- CPU: JAX
@pytest.mark.parametrize("name", ["NMF", "NMFD"])
@pytest.mark.parametrize("kw", SPARSENESS, ids=KW_IDS)
@pytest.mark.parametrize("max_iter", [0, 9, 10, 30])
def test_batched_hoyer_fit_matches_jax(jx, name, kw, max_iter):
    V, W0, H0 = _problem(name)
    W, H, n = F.nmf_hoyer_fit_batched(
        *(torch.from_numpy(a) for a in (V, W0, H0)), beta=2,
        max_iter=max_iter, model_cls=MODELS[name], **kw)
    jW, jH, jn = jx.F.nmf_hoyer_fit_batched(V, W0, H0, beta=2,
                                            max_iter=max_iter,
                                            model_cls=jx.models[name], **kw)
    assert n.tolist() == np.asarray(jn).tolist() == [max_iter] * len(V)
    assert _rel(W, jW) <= RTOL and _rel(H, jH) <= RTOL


# ---------------------------------------- CPU: chunked against the eager loop
@pytest.mark.parametrize("name", ["NMF", "NMFD"])
@pytest.mark.parametrize("kw", SPARSENESS, ids=KW_IDS)
@pytest.mark.parametrize("max_iter", [0, 1, 9, 10, 20, 25, 30, 47])
def test_chunks_equal_the_eager_loop(name, kw, max_iter):
    runs = _both_ways(name, "cpu", max_iter, kw)
    (g, gc), (e, ec) = runs[True], runs[False]
    for a, b in zip(g, e):
        assert torch.equal(a, b)
    assert g[2].tolist() == [max_iter] * len(g[2])
    assert gc == ec and gc[3] == 0  # no single-problem line search ran
    rounds, reads = gc[:2]
    constrained = len(kw)
    assert rounds >= max_iter * constrained and reads == rounds
    # every problem's attempts: at least one a search, at most ten
    assert bool((g[3] >= max_iter * constrained).all())
    assert bool((g[3] <= 10 * max_iter * constrained).all())


@pytest.mark.parametrize("kw", SPARSENESS, ids=KW_IDS)
def test_each_problem_is_its_single_fit(kw):
    """An NMF batch's problems equal their single fits, attempt for attempt
    (each problem's line search is its own)."""
    W, H, _, att = _fit("NMF", "cpu", True, 30, kw)
    for b, (V, W0, H0) in enumerate(zip(*_problem("NMF"))):
        a0 = solver._backtrack_project.attempts
        w, h, _ = F.nmf_hoyer_fit(*(torch.from_numpy(x) for x in (V, W0, H0)),
                                  beta=2, max_iter=30, **kw)
        assert int(att[b]) == solver._backtrack_project.attempts - a0
        assert _rel(W[b], w) <= 1e-6 and _rel(H[b], h) <= 1e-6


_HOST_DATA = {torch.tensor, torch.from_numpy}
_HOST_READS = {torch.Tensor.item, torch.Tensor.__bool__,
               torch.Tensor.__float__, torch.Tensor.__int__,
               torch.Tensor.__index__, torch.Tensor.tolist,
               torch.Tensor.numpy, torch.Tensor.cpu}


class _NoHostTraffic(TorchFunctionMode):
    """Raises on what would read the card's values on the host, or copy
    host data to it, on a CUDA tensor, except while ``allowed``: inside the
    loop's own counted read (``graphs._host_read``) and the CPU's plain
    projection, whose ``done`` reads ``proj_rows.reads`` counts."""

    allowed = False

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if not _NoHostTraffic.allowed and (
                func in _HOST_READS or func in _HOST_DATA or (
                    func is torch.as_tensor
                    and not isinstance(args[0], torch.Tensor))):
            raise AssertionError(f"host traffic inside a chunk: {func}")
        return func(*args, **(kwargs or {}))


class _GuardedGraphs(graphs._Graphs):
    made = 0

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        _GuardedGraphs.made += 1

    def __call__(self, k=0):
        with _NoHostTraffic():
            super().__call__(k)
        _GuardedGraphs.calls += 1


def _allowed(fn, log=None):
    def call(*args, **kwargs):
        _NoHostTraffic.allowed = True
        try:
            out = fn(*args, **kwargs)
        finally:
            _NoHostTraffic.allowed = False
        if log is not None:
            log.append(out)
        return out

    return call


@pytest.mark.parametrize("name", ["NMF", "NMFD"])
@pytest.mark.parametrize("kw", SPARSENESS[2:], ids=KW_IDS[2:])
def test_chunks_read_the_host_only_through_the_loop(monkeypatch, name, kw):
    reads = []
    monkeypatch.setattr(solver, "_Graphs", _GuardedGraphs)
    monkeypatch.setattr(graphs, "_host_read", _allowed(graphs._host_read, reads))
    monkeypatch.setattr(projection, "plain_proj_rows",
                        _allowed(projection.plain_proj_rows))
    _GuardedGraphs.calls = _GuardedGraphs.made = 0
    solver.compiled_cache_clear()
    r0 = solver._batched_backtrack_project.reads
    _fit(name, "cpu", True, 30, kw)
    assert _GuardedGraphs.calls == 3 and _GuardedGraphs.made == 1
    # the line searches' flags and the chunk loop's: a call for chunk 1 and
    # one for chunk 2 (two reads each), then one for chunk 3 (two)
    line_search = solver._batched_backtrack_project.reads - r0
    assert len(reads) == line_search + 6 and line_search > 0


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


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["NMF", "NMFD"])
@pytest.mark.parametrize("kw", SPARSENESS, ids=KW_IDS)
@pytest.mark.parametrize("max_iter", [20, 30, 47])
def test_cuda_graphed_batched_hoyer_fit_matches_eager(cuda, monkeypatch, name,
                                                     kw, max_iter):
    captures, capture = [], graphs._Graphs._capture

    def counted(self, fn):
        captures.append(fn)
        return capture(self, fn)

    monkeypatch.setattr(graphs._Graphs, "_capture", counted)
    p0 = graphs._Graphs.replays
    runs = _both_ways(name, cuda, max_iter, kw)
    (g, gc), (e, ec) = runs[True], runs[False]
    for a, b in zip(g, e):
        assert a.is_cuda and torch.equal(a, b)
    chunks = max_iter // 10
    # chunks 1-2 eager, then one replay of the chunk loop for the rest
    assert graphs._Graphs.replays - p0 == int(chunks >= 3)
    assert len(captures) == (chunks >= 3)  # one capture for the whole batch
    rounds, reads, p1 = gc[:3]
    assert rounds == ec[0] and p1 == ec[2]
    # one launch a round and one a constrained factor's first projection,
    # for the whole batch
    assert p1 == len(kw) + rounds
    assert ec[1] == rounds
    assert (0 < reads < rounds) if chunks >= 3 else reads == rounds


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["NMF", "NMFD"])
def test_cuda_warm_batched_hoyer_fit_is_one_replay(cuda, name):
    """A warm fit of the batch (other inits on the kept entry) is one
    replay, no capture and no host read, bit for bit its eager twin with
    the same rounds and P1 launches (counted on the card through the
    chunk loop's nested bodies)."""
    kw = dict(sW=0.5)
    cls = MODELS[name]
    V, W, H = (torch.from_numpy(a).to(cuda) for a in _problem(name))
    fit = {graph: solver.get_batched_hoyer_fit(
        cls.reconstruct if name == "NMF" else vmap(cls.reconstruct), 2.0, 30,
        True, True, 0.5, None, W[0].numel() // W.shape[2],
        H[0].numel() // H.shape[2], _graph=graph) for graph in (True, False)}
    fit[True](V, W, H)  # cold
    out = {}
    for graph in (True, False):
        c0, p0 = _counts(), graphs._Graphs.replays
        k0, r0 = graphs._Graphs.captures, solver._read.reads
        got = fit[graph](V, W.roll(1, 1), H.roll(1, 1), _attempts=True)
        torch.cuda.synchronize()
        out[graph] = (got, [a - b for a, b in zip(_counts(), c0)],
                      (graphs._Graphs.replays - p0,
                       graphs._Graphs.captures - k0,
                       solver._read.reads - r0))
    (g, gc, gl), (e, ec, _) = out[True], out[False]
    for a, b in zip(g, e):
        assert torch.equal(a, b)
    assert gl == (1, 0, 0) and gc[1] == 0  # no line-search read either
    assert (gc[0], gc[2]) == (ec[0], ec[2]) and gc[2] == len(kw) + gc[0]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["NMF", "NMFD"])
def test_cuda_graphed_batched_hoyer_fits_keep_no_memory(cuda, name):
    kw = dict(sW=0.5)
    _fit(name, cuda, True, 40, kw)  # lazy imports, workspaces
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated()
    for max_iter in (40, 50, 30):
        out = _fit(name, cuda, True, max_iter, kw)
        del out
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated() == allocated

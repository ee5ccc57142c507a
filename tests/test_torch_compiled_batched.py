"""The batched MU and EM fits' compiled execution: ``nmf_fit_batched`` and
``plca_fit_batched`` run their chunk loop over every problem at once as
one in-place workload (``ops/solver._graphed_batched_loop``), a device loop:
chunks 1-2 eagerly and one replay of a CUDA graph for the rest (the loop a
WHILE node), on the card; called directly on the CPU.  A converged problem's factors freeze; the chunk count
is a tensor on the device, so a replayed chunk records each problem's own
chunk of convergence.

CPU tests:

* the port's batched fits against the JAX package's jitted batched fits
  (numpy seeds): NMF at β ∈ {0, 0.5, 1, 1.5, 2} and ``max_iter`` ∈ {0, 5,
  10, 25, 30, 47}, NMFD, PLCA and SIPLCA; a batch whose problems stop at
  different chunks, one at chunk 3 or later (a ``tol`` between the
  per-problem relative decreases of the port's eager run, none within 15%
  of it): the same ``n_iter`` per problem and ``max|Δ|/max|ref| ≤ 1e-5``;
* the chunked loop against the eager one (``_graph=False``): the same
  factors and ``n_iter`` bit for bit, the loop's host reads (its flag's);
  no host read inside a chunk (a ``TorchFunctionMode`` that raises).

CUDA tests (marked ``cuda``; skipped without a card) hold the graphed fits
against the eager ones on the card: bit for bit, one replay for chunks 3
on, the eager chunks' host reads only, staggered stops at chunks ≥ 3 kept, allocated memory
flat over three fits.
``python -m pytest --noconftest -m cuda tests/test_torch_compiled_batched.py``.
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.func import vmap  # noqa: E402
from torch.overrides import TorchFunctionMode  # noqa: E402

from pytorch_nmf_tpu_torch import functional as F  # noqa: E402
from pytorch_nmf_tpu_torch.metrics import beta_div, kl_div  # noqa: E402
from pytorch_nmf_tpu_torch.nmf import NMF, NMFD  # noqa: E402
from pytorch_nmf_tpu_torch.ops import graphs, solver  # noqa: E402
from pytorch_nmf_tpu_torch.ops.fast_nmf import nmf_updater_factory_generic  # noqa: E402
from pytorch_nmf_tpu_torch.plca import PLCA, SIPLCA  # noqa: E402

RTOL = 1e-5
BETAS = [0, 0.5, 1, 1.5, 2]
MAX_ITERS = [0, 5, 10, 25, 30, 47]
# the stagger's tol sits at least this factor from every relative decrease
MARGIN = 1.15


@pytest.fixture(scope="module")
def jx():
    """The JAX package's functional API and models, imported only by the
    tests that compare with it: the CUDA tests need no JAX."""
    pytest.importorskip("jax")
    from pytorch_nmf_tpu import functional
    from pytorch_nmf_tpu.models import nmf, plca

    return SimpleNamespace(F=functional, models={
        "NMF": nmf.NMF, "NMFD": nmf.NMFD, "PLCA": plca.PLCA,
        "SIPLCA": plca.SIPLCA})


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these small fits are many small operations,
    which more threads only slow down (several times over when the workers
    of a parallel test run share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MODELS = {"NMF": NMF, "NMFD": NMFD, "PLCA": PLCA, "SIPLCA": SIPLCA}


def _problem(key, seed=5):
    """numpy ``(V, W0, H0)`` of a batch (``+ Z0`` for the PLCA family, whose
    W and H start normalized and Z uniform)."""
    rs = np.random.RandomState(seed)
    if key in ("NMF", "PLCA"):
        shapes, axes = ((4, 30, 20), (4, 20, 3), (4, 30, 3)), (1,)
    else:
        shapes, axes = ((3, 1, 6, 40), (3, 6, 2, 4), (3, 1, 2, 37)), (1, 3)
    V, W, H = (rs.rand(*s).astype("f") + off
               for s, off in zip(shapes, (0.01, 0.1, 0.1)))
    if "PLCA" not in key:
        return V, W, H
    W = W / W.sum(axes, keepdims=True)
    H = H / H.sum(axes, keepdims=True)
    return V, W, H, np.full(W.shape[:1] + W.shape[2:3], 1 / W.shape[2], "f")


def _rel(got, ref):
    got, ref = np.asarray(got, "f8"), np.asarray(ref, "f8")
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _fit(key, device, graph, tol, max_iter, beta=1.0, seed=5):
    """The batched fit as ``functional`` builds it, through the solver with
    ``_graph``: ``(W, H, n_iter)`` (``(W, H, Z, n_iter, norm)`` for the
    PLCA family)."""
    arrays = [torch.from_numpy(a).to(device) for a in _problem(key, seed)]
    cls = MODELS[key]
    recon = cls.reconstruct if key in ("NMF", "PLCA") else vmap(cls.reconstruct)
    if "PLCA" in key:
        fit = solver.get_batched_plca_fit(cls.reconstruct, tol, max_iter, True,
                                          True, True, False, False, False,
                                          _graph=graph)
        one = arrays[0].new_ones(())
        return fit(*arrays, one, one, one)
    fit = solver.get_batched_dense_fit(
        recon, float(beta), tol, max_iter, True, True, 0.0, 0.0,
        nmf_updater_factory_generic if key == "NMF" else None, _graph=graph)
    return fit(*arrays)


def _losses(key, device, chunks, beta=1.0):
    """Each problem's loss before the fit and after each of ``chunks``
    chunks of the eager loop, ``(chunks + 1, B)``."""
    arrays = [torch.from_numpy(a).to(device) for a in _problem(key)]
    cls = MODELS[key]
    recon = cls.reconstruct if key in ("NMF", "PLCA") else vmap(cls.reconstruct)
    if "PLCA" in key:
        V = arrays[0]
        norm = V.reshape(V.shape[0], -1).sum(1)
        Vn = V / norm.reshape((-1,) + (1,) * (V.ndim - 1))
        loss_b = vmap(lambda vn, w, h, z, n: torch.sqrt(
            2.0 * kl_div(cls.reconstruct(h, w, z) * n, vn * n)))

        def loss(out):
            return loss_b(Vn, *out[:3], norm)
    else:
        div_b = vmap(lambda wh, v: beta_div(wh, v, beta))

        def loss(out):
            return torch.sqrt(2.0 * div_b(recon(out[1], out[0]), arrays[0]))

    rows = [loss(tuple(arrays[1:]))]
    for c in range(1, chunks + 1):
        rows.append(loss(_fit(key, device, False, 0.0, 10 * c, beta)))
    return torch.stack(rows).cpu().double().numpy()


def _staggered_tol(losses):
    """A ``tol`` at which the problems stop at different chunks, one at
    chunk 3 or later, with every chunk's relative decrease at least
    :data:`MARGIN` from it; and each problem's chunk of stopping (0: none
    within the losses' chunks)."""
    d = -np.diff(losses, axis=0) / losses[0]
    best = None
    for tol in np.sqrt(np.sort(d[1:].ravel())[1:] * np.sort(d[1:].ravel())[:-1]):
        if np.min(np.maximum(d / tol, tol / d)) < MARGIN:
            continue
        below = d < tol
        stops = np.where(below.any(0), below.argmax(0) + 1, 0)
        if len(set(stops.tolist())) > 1 and stops.max() >= 3 and (
                best is None or len(set(stops.tolist())) > len(set(best[1]))):
            best = (float(tol), stops.tolist())
    assert best is not None, d
    return best


def _outputs(out):
    return [x for x in out if isinstance(x, torch.Tensor)]


# ---------------------------------------------------------------- CPU: JAX
@pytest.mark.parametrize("beta", BETAS)
@pytest.mark.parametrize("max_iter", MAX_ITERS)
def test_batched_mu_fit_matches_jax(jx, beta, max_iter):
    V, W0, H0 = _problem("NMF")
    W, H, n = F.nmf_fit_batched(*(torch.from_numpy(a) for a in (V, W0, H0)),
                                beta=beta, tol=0, max_iter=max_iter)
    jW, jH, jn = jx.F.nmf_fit_batched(V, W0, H0, beta=beta, tol=0,
                                      max_iter=max_iter)
    assert n.tolist() == np.asarray(jn).tolist() == [max_iter] * 4
    assert _rel(W, jW) <= RTOL and _rel(H, jH) <= RTOL


@pytest.mark.parametrize("key", ["NMF", "NMFD", "PLCA", "SIPLCA"])
def test_staggered_stops_match_jax(jx, key):
    """The problems stop at different chunks, one at chunk 3 or later:
    each with JAX's ``n_iter`` and factors."""
    beta = 1.0
    tol, stops = _staggered_tol(_losses(key, "cpu", 4, beta))
    arrays = _problem(key)
    port = [torch.from_numpy(a) for a in arrays]
    if "PLCA" in key:
        out = F.plca_fit_batched(*port, model_cls=MODELS[key], tol=tol,
                                 max_iter=47)
        ref = jx.F.plca_fit_batched(*arrays, model_cls=jx.models[key],
                                    tol=tol, max_iter=47)
        n, jn, pairs = out[3], ref[3], zip(out[:3], ref[:3])
        want = [10 * s - 1 if s else 46 for s in stops]
    else:
        out = F.nmf_fit_batched(*port, beta=beta, tol=tol, max_iter=47,
                                model_cls=MODELS[key])
        ref = jx.F.nmf_fit_batched(*arrays, beta=beta, tol=tol, max_iter=47,
                                   model_cls=jx.models[key])
        n, jn, pairs = out[2], ref[2], zip(out[:2], ref[:2])
        want = [10 * s if s else 47 for s in stops]
    assert n.tolist() == np.asarray(jn).tolist() == want
    for a, b in pairs:
        assert _rel(a, b) <= RTOL


@pytest.mark.parametrize("max_iter", [10, 30])
def test_batched_nmfd_and_em_fits_match_jax(jx, max_iter):
    arrays = _problem("NMFD")
    W, H, n = F.nmf_fit_batched(*(torch.from_numpy(a) for a in arrays),
                                beta=0.5, tol=0, max_iter=max_iter,
                                model_cls=NMFD)
    jW, jH, jn = jx.F.nmf_fit_batched(*arrays, beta=0.5, tol=0,
                                      max_iter=max_iter,
                                      model_cls=jx.models["NMFD"])
    assert n.tolist() == np.asarray(jn).tolist()
    assert _rel(W, jW) <= RTOL and _rel(H, jH) <= RTOL
    for key in ("PLCA", "SIPLCA"):
        arrays = _problem(key)
        out = F.plca_fit_batched(*(torch.from_numpy(a) for a in arrays),
                                 model_cls=MODELS[key], tol=0,
                                 max_iter=max_iter)
        ref = jx.F.plca_fit_batched(*arrays, model_cls=jx.models[key], tol=0,
                                    max_iter=max_iter)
        assert out[3].tolist() == np.asarray(ref[3]).tolist() == [
            max_iter - 1] * len(arrays[0])
        for a, b in zip(out[:3] + out[4:], ref[:3] + ref[4:]):
            assert _rel(a, b) <= RTOL


# ------------------------------------------- CPU: in place against eager
CASES = [("NMF", 0.5), ("NMF", 1.0), ("NMF", 1.5), ("NMF", 2.0),
         ("NMFD", 1.0), ("PLCA", None), ("SIPLCA", None)]
CASE_IDS = [f"{k}-{b}" for k, b in CASES]


def _loop_reads(chunks):
    """The CPU's host reads of the batched device loop over ``chunks``
    chunks run: its flag before each chunk of a call and once after the
    call's last, chunks 1 and 2 a call each (as the card's warm-ups), the
    rest one call; a call that finds the flag down reads it once."""
    if chunks == 0:
        return 0
    if chunks == 1:  # all converged: the second call finds the flag down
        return 2 + 1
    return 2 + 2 + chunks - 2 + 1


def _both_ways(key, device, tol, max_iter, beta):
    """``{graph: (outputs, host reads)}``, the graphed fit a
    configuration's first (cold)."""
    solver.compiled_cache_clear()
    runs = {}
    for graph in (True, False):
        r0 = solver._read.reads
        out = _fit(key, device, graph, tol, max_iter, beta or 1.0)
        runs[graph] = (out, solver._read.reads - r0)
    return runs


@pytest.mark.parametrize("key, beta", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("max_iter", [0, 9, 30, 47])
def test_chunks_equal_the_eager_loop(key, beta, max_iter):
    runs = _both_ways(key, "cpu", 0.0, max_iter, beta)
    (g, gr), (e, er) = runs[True], runs[False]
    for a, b in zip(_outputs(g), _outputs(e)):
        assert torch.equal(a, b)
    chunks = max_iter // 10
    assert er == chunks and gr == (_loop_reads(chunks) if chunks > 2
                                   else 2 * chunks)


@pytest.mark.parametrize("key", ["NMF", "PLCA"])
def test_chunks_stop_where_the_eager_loop_stops(key):
    tol, stops = _staggered_tol(_losses(key, "cpu", 4))
    runs = _both_ways(key, "cpu", tol, 47, 1.0)
    (g, gr), (e, er) = runs[True], runs[False]
    for a, b in zip(_outputs(g), _outputs(e)):
        assert torch.equal(a, b)
    chunks = max(4 if 0 in stops else 0, max(stops))
    assert er == chunks and gr == _loop_reads(chunks)


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


@pytest.mark.parametrize("key, beta", CASES, ids=CASE_IDS)
def test_chunks_do_no_host_traffic(monkeypatch, key, beta):
    monkeypatch.setattr(solver, "_Graphs", _GuardedGraphs)
    monkeypatch.setattr(graphs, "_host_read", _allowed(graphs._host_read))
    solver.compiled_cache_clear()  # a cold fit: chunks 1-2 a call each
    _GuardedGraphs.calls = 0
    _fit(key, "cpu", True, 0.0, 30, beta or 1.0)
    assert _GuardedGraphs.calls == 3


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


def _card_both_ways(key, tol, max_iter, beta):
    """``{graph: (outputs, host reads, replays)}`` on the card."""
    runs = {}
    for graph in (True, False):
        r0, p0 = solver._read.reads, graphs._Graphs.replays
        out = _fit(key, "cuda", graph, tol, max_iter, beta or 1.0)
        torch.cuda.synchronize()
        runs[graph] = (out, solver._read.reads - r0,
                       graphs._Graphs.replays - p0)
    return runs


@pytest.mark.cuda
@pytest.mark.parametrize("key, beta", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("max_iter", [20, 47, 100])
def test_cuda_graphed_batched_fit_matches_eager(cuda, key, beta, max_iter):
    runs = _card_both_ways(key, 0.0, max_iter, beta)
    (g, gr, gp), (e, er, ep) = runs[True], runs[False]
    for a, b in zip(_outputs(g), _outputs(e)):
        assert a.is_cuda and torch.equal(a, b)
    chunks = max_iter // 10
    # chunks 1-2 eager (two flag reads each), one replay after
    assert er == chunks and gr == 4
    assert gp == (chunks > 2) and ep == 0


@pytest.mark.cuda
@pytest.mark.parametrize("key", ["NMF", "NMFD", "PLCA", "SIPLCA"])
def test_cuda_staggered_stops_keep_their_chunk(cuda, key):
    """Problems stopping at chunks ≥ 3 (replays) keep their own ``n_iter``:
    a chunk index baked into the graph would give them the capture's."""
    tol, stops = _staggered_tol(_losses(key, "cuda", 4))
    runs = _card_both_ways(key, tol, 47, 1.0)
    (g, gr, gp), (e, er, _) = runs[True], runs[False]
    n = g[3] if "PLCA" in key else g[2]
    want = [10 * s - ("PLCA" in key) if s else 47 - ("PLCA" in key)
            for s in stops]
    assert n.tolist() == want and max(stops) >= 3
    for a, b in zip(_outputs(g), _outputs(e)):
        assert torch.equal(a, b)
    assert gr == 4 and gp == 1  # two eager chunks, then one replay


@pytest.mark.cuda
@pytest.mark.parametrize("key", ["NMF", "PLCA"])
def test_cuda_graphed_batched_fits_keep_no_memory(cuda, key):
    _fit(key, "cuda", True, 0.0, 40)  # lazy imports, workspaces
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated()
    for max_iter in (40, 50, 30):
        out = _fit(key, "cuda", True, 0.0, max_iter)
        del out
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated() == allocated

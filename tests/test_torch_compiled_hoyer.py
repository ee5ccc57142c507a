"""The Hoyer fit's compiled execution: the fit runs its chunk loop as one
in-place workload (``ops/solver._graphed_hoyer_loop`` on
``_loop_workload``): on the card chunks 1-2 eagerly, then the capture and
one replay of the loop for the rest, a CUDA-graph WHILE node whose body
is the 10-iteration chunk, with each line search's attempts 2-10 a WHILE
node nested in it on the device flag "the last attempt was worse"
(``ops/graphs._device_while``); called directly on the CPU.  The step sizes
are 0-d float32 tensors, multiplied in float32 as the JAX package does.

CPU tests:

* the line search against the JAX package's (``_backtrack_project``) over
  a few hundred grow/halve steps, every attempt count from 1 to 10 among
  them: the same step size bit for bit;
* the port's Hoyer fits against the JAX package's jitted fits (explicit
  inits from the numpy seeds of ``test_torch_hoyer.py``): NMF and NMFD with
  ``sW``, ``sH``, both and a frozen factor, ``max_iter`` ∈ {0, 1, 9, 10,
  20, 25, 47}, verbose on and off: the same ``n_iter`` and ``max|Δ|/max|ref|
  ≤ 1e-5`` for each factor;
* the chunked loop against the eager one (``_graph=False``) at the same
  ``max_iter``: the same factors bit for bit, the same progress-handler
  calls, attempts and line-search reads, and the chunk loop's own flag
  reads besides; a chunk reads the host only through the loops' own
  counted reads (a ``TorchFunctionMode`` that raises on any other); the
  dense, sparse-target and batched fits run ``_loop_workload``;
* the sparse-target fit keeps the eager loop; the batched fit is one
  chunked fit for the whole batch.

CUDA tests (marked ``cuda``; skipped without a card) hold graphed fits
against eager ones on the card: factors bit for bit at ``max_iter`` ∈ {20,
30, 47, 100}, one replay of the chunk loop after two eager chunks (a
reporting fit one a chunk), a warm fit and a fit on a new V one replay
and no host read, line-search host reads only in the eager chunks, P1 launches equal to the constrained factors plus the
attempts, the same B3/B4 launches both ways, nothing kept alive after the
fit, allocated memory flat across graphed fits, and a chunk that reads the
host refused.
``python -m pytest --noconftest -m cuda tests/test_torch_compiled_hoyer.py``.
"""

import itertools
import weakref
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.overrides import TorchFunctionMode  # noqa: E402

from pytorch_nmf_tpu_torch.nmf import NMF, NMFD  # noqa: E402
from pytorch_nmf_tpu_torch.ops import (fast_nmfd, fused_deconv, graphs,  # noqa: E402
                                       projection, solver)
from pytorch_nmf_tpu_torch.ops.sparse import sparse_from_dense  # noqa: E402
from pytorch_nmf_tpu_torch.utils import nmf_from_numpy  # noqa: E402

RTOL = 1e-5
MAX_ITERS = [0, 1, 9, 10, 20, 25, 47]
# (model, numpy seed of test_torch_hoyer's problem, sparseness, trainable)
CASES = [
    ("NMF", 1, dict(sW=0.5), (True, True)),
    ("NMF", 1, dict(sH=0.5), (True, True)),
    ("NMF", 1, dict(sW=0.5, sH=0.4), (True, True)),
    ("NMF", 3, dict(sW=0.5, sH=0.5), (False, True)),
    ("NMFD", 1, dict(sW=0.5), (True, True)),
    ("NMFD", 1, dict(sH=0.5), (True, True)),
    ("NMFD", 1, dict(sW=0.5, sH=0.4), (True, True)),
    ("NMFD", 1, dict(sW=0.5), (True, False)),
]
CASE_IDS = [f"{m}-s{seed}-{'+'.join(kw)}-{'W' if t[0] else ''}"
            f"{'H' if t[1] else ''}" for m, seed, kw, t in CASES]


@pytest.fixture(scope="module")
def jx():
    """The JAX package's models and solver, imported only by the tests that
    compare with it: the CUDA tests need no JAX."""
    jax = pytest.importorskip("jax")
    from pytorch_nmf_tpu.models import nmf
    from pytorch_nmf_tpu.ops import solver as jsolver

    return SimpleNamespace(jax=jax, jnp=jax.numpy, models=nmf, solver=jsolver)


def _problem(name, seed):
    """``test_torch_hoyer.py``'s problems: ``(V, W0, H0)``, every array
    ``rand`` plus 0.01 (V) or 0.1 (the factors)."""
    rs = np.random.RandomState(seed)
    shapes = (((40, 30), (30, 5), (40, 5)) if name == "NMF"
              else ((1, 12, 60), (12, 3, 5), (1, 3, 56)))
    return tuple(rs.rand(*s).astype("f") + off
                 for s, off in zip(shapes, (0.01, 0.1, 0.1)))


def _rel(got, ref):
    got, ref = np.asarray(got, "f8"), np.asarray(ref, "f8")
    scale = np.abs(ref).max()
    return float(np.abs(got - ref).max() / scale) if scale else float(
        np.abs(got).max())


# ------------------------------------------------------ CPU: the step size
def test_step_size_matches_jax_bit_for_bit(jx):
    """C7: a 0-d float32 step grown by 1.2 in float32, as JAX's weak-typed
    product, where a float64 product rounded once differs by an ulp.  The
    candidate's sum is the L1 target ``L1·‖p - ss·g‖`` with ``p ⟂ g`` unit
    vectors, so the loss falls with each halving and a baseline between two
    attempts' losses picks the attempt that succeeds, far from any edge."""
    jnp = jx.jnp
    rs = np.random.RandomState(0)
    N = 8
    p = rs.rand(N)
    g = rs.randn(N)
    g -= (g @ p) / (p @ p) * p
    p, g = (x / np.linalg.norm(x) for x in (p, g))
    p, g = p.astype("f")[:, None], g.astype("f")[:, None]
    L1 = projection.hoyer_l1_target(N, 0.5)
    search = jx.jax.jit(lambda base, ss: jx.solver._backtrack_project(
        base, jnp.sum, jnp.asarray(p), jnp.asarray(g), ss, L1))
    pt, gt = torch.from_numpy(p), torch.from_numpy(g)
    ss_t, ss_j = torch.ones(()), jnp.float32(1.0)
    old_rule_differs = 0
    seen = set()
    # grow the step past 40, then take attempt counts in turn until it is
    # below 0.5; a count the step cannot reach far from an edge waits
    wanted = itertools.cycle([2, 3, 4, 5, 6, 7, 8, 9, 10, 1])
    want, grow = next(wanted), True
    for step in range(300):
        ss = float(ss_t)
        grow = ss < 40 if grow else ss < 0.5
        if grow or not (want in (1, 10) or ss * 0.5 ** (want - 1) >= 0.05):
            k = 1
        else:
            k, want = want, next(wanted)
        if k == 1:
            base = 1e30
        elif k == 10:
            base = -1.0  # every attempt fails
        else:
            base = L1 * np.sqrt(1 + (1.5 * ss * 0.5 ** (k - 1)) ** 2)
        a0 = solver._backtrack_project.attempts
        _, ss_t = solver._backtrack_project(torch.tensor(base, dtype=torch.float32),
                                            torch.sum, pt, gt, ss_t, L1)
        assert solver._backtrack_project.attempts - a0 == k, step
        _, ss_j = search(jnp.float32(base), ss_j)
        assert ss_t.dtype == torch.float32
        assert ss_t.numpy().tobytes() == np.float32(ss_j).tobytes(), step
        before = np.float32(ss * 0.5 ** (k if k == 10 else k - 1))
        old_rule_differs += solver._f32(float(before) * 1.2) != float(ss_t)
        seen.add(k)
    assert seen == set(range(1, 11))
    assert old_rule_differs > 0  # the float64 product rounded once would fail


def test_step_growth_is_jax_float32_product(jx):
    """C7's probe: 2,000 float32 step sizes from U[1e-6, 10] (numpy seed 0),
    each the step of a search whose first attempt succeeds, grown by 1.2.
    The port's step equals JAX's on all; the float64 product rounded once
    (the port's rule before) is one ulp off on 895 of them."""
    jnp = jx.jnp
    steps = np.random.RandomState(0).uniform(1e-6, 10, 2000).astype("f")
    p = torch.from_numpy(np.random.RandomState(1).rand(6, 2).astype("f"))
    g = torch.zeros_like(p)
    L1 = projection.hoyer_l1_target(6, 0.5)
    search = jx.jax.jit(lambda ss: jx.solver._backtrack_project(
        jnp.float32(1e30), jnp.sum, jnp.asarray(p.numpy()),
        jnp.asarray(g.numpy()), ss, L1)[1])
    base = torch.tensor(1e30)
    got = np.array([float(solver._backtrack_project(
        base, torch.sum, p, g, torch.tensor(x), L1)[1]) for x in steps], "f")
    want = np.asarray([search(jnp.float32(x)) for x in steps], "f")
    np.testing.assert_array_equal(got, want)
    old = np.array([solver._f32(float(x) * 1.2) for x in steps], "f")
    assert int((old != want).sum()) == 895


# ----------------------------------------------------------- CPU: JAX fits
def _fit_both(jx, case, max_iter, verbose=False):
    name, seed, kw, trainable = case
    V, W0, H0 = _problem(name, seed)
    ref = getattr(jx.models, name)(W=W0, H=H0, trainable_W=trainable[0],
                                   trainable_H=trainable[1])
    ref_n = ref.sparse_fit(V, beta=2, max_iter=max_iter, verbose=verbose, **kw)
    port = nmf_from_numpy({"W": W0, "H": H0}, "cpu", *trainable)
    port_n = port.sparse_fit(torch.from_numpy(V), beta=2, max_iter=max_iter,
                             verbose=verbose, **kw)
    return port, port_n, ref, ref_n


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("max_iter", MAX_ITERS)
def test_hoyer_fit_matches_jax(jx, case, max_iter):
    port, port_n, ref, ref_n = _fit_both(jx, case, max_iter)
    assert port_n == int(ref_n) == max_iter
    assert _rel(port.W.detach().numpy(), ref.W.data) <= RTOL
    assert _rel(port.H.detach().numpy(), ref.H.data) <= RTOL


@pytest.mark.parametrize("case", CASES[::3], ids=CASE_IDS[::3])
@pytest.mark.parametrize("max_iter", [10, 25, 47])
def test_verbose_hoyer_fit_matches_jax(jx, case, max_iter):
    port, port_n, ref, ref_n = _fit_both(jx, case, max_iter, verbose=True)
    assert port_n == int(ref_n) == max_iter
    assert _rel(port.W.detach().numpy(), ref.W.data) <= RTOL
    assert _rel(port.H.detach().numpy(), ref.H.data) <= RTOL


# ---------------------------------------- CPU: chunked against the eager loop
def _counts():
    return (solver._backtrack_project.attempts, solver._backtrack_project.reads,
            projection.proj_rows.launches, fused_deconv.hgrad.launches,
            fused_deconv.wgrad.launches, solver._read.reads)


def _run_fit(case, device, graph, max_iter, verbose=False, recon=None):
    """The Hoyer fit through ``get_hoyer_fit``, as the models build it, on
    ``device``: ``(W, H, n_iter)``."""
    name, seed, kw, (tw, th) = case
    V, W, H = (torch.from_numpy(a).to(device) for a in _problem(name, seed))
    cls = NMF if name == "NMF" else NMFD
    if recon is None:
        recon = cls._resolve_fit_recon2(V, W, H, 2.0)
    fit = solver.get_hoyer_fit(
        recon, None, 2.0, max_iter, tw, th, kw.get("sW") if tw else None,
        kw.get("sH") if th else None, W.numel() // W.shape[1],
        H.numel() // H.shape[1], verbose, _graph=graph)
    return fit(V, W, H)


def _both_ways(case, device, max_iter, verbose=False, **kw):
    """``{graph: (out, calls, counts)}``: the chunked and the eager fit,
    each with its progress-handler calls and its counts' increase."""
    runs = {}
    for graph in (True, False):
        if graph:  # a cold fit: chunks 1-2 eager, then the loop's capture
            solver.compiled_cache_clear()
        calls = []
        solver.push_progress_handler(lambda *a: calls.append(a))
        c0 = _counts()
        try:
            out = _run_fit(case, device, graph, max_iter, verbose, **kw)
        finally:
            solver.pop_progress_handler()
        if device != "cpu":
            torch.cuda.synchronize()
        runs[graph] = (out, calls, [a - b for a, b in zip(_counts(), c0)])
    return runs


def _flag_reads(chunks, verbose):
    """The chunk loop's flag reads in a cold fit on the CPU: a call for
    chunk 1 and one for chunk 2 (two reads each), then one call for the
    rest (a read before each chunk and one after); a reporting fit one call
    a chunk."""
    if verbose or chunks <= 2:
        return 2 * chunks
    return 2 * 2 + chunks - 2 + 1


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("max_iter", MAX_ITERS)
@pytest.mark.parametrize("verbose", [False, True])
def test_chunks_equal_the_eager_loop(case, max_iter, verbose):
    runs = _both_ways(case, "cpu", max_iter, verbose)
    (g, gcalls, gcounts), (e, ecalls, ecounts) = runs[True], runs[False]
    assert g[2] == e[2] == max_iter
    assert torch.equal(g[0], e[0]) and torch.equal(g[1], e[1])
    assert gcalls == ecalls and len(gcalls) == (max_iter // 10 if verbose else 0)
    # the same counts, but for the chunk loop's own flag reads (eagerly
    # one before each chunk of a call and one after its last)
    assert gcounts[:5] == ecounts[:5]
    assert gcounts[5] - ecounts[5] == _flag_reads(max_iter // 10, verbose)
    constrained = sum(1 for s, t in zip(("sW", "sH"), case[3])
                      if t and s in case[2])
    assert gcounts[0] >= max_iter * constrained
    assert gcounts[1] == gcounts[0]  # one host read an attempt, eagerly


_HOST_DATA = {torch.tensor, torch.from_numpy}
_HOST_READS = {torch.Tensor.item, torch.Tensor.__bool__,
               torch.Tensor.__float__, torch.Tensor.__int__,
               torch.Tensor.__index__, torch.Tensor.tolist,
               torch.Tensor.numpy, torch.Tensor.cpu}


class _NoHostTraffic(TorchFunctionMode):
    """Raises on what would read the card's values on the host, or copy
    host data to it, on a CUDA tensor, except while ``allowed``: inside the
    loop's own counted read (``graphs._host_read``) and the CPU's plain
    projection, whose ``done`` reads ``proj_rows.reads`` counts (P1 reads
    nothing on the card)."""

    allowed = False

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if not _NoHostTraffic.allowed and (
                func in _HOST_READS or func in _HOST_DATA or (
                    func is torch.as_tensor
                    and not isinstance(args[0], torch.Tensor))):
            raise AssertionError(f"host traffic inside a chunk: {func}")
        return func(*args, **(kwargs or {}))


class _GuardedGraphs(graphs._Graphs):
    def __call__(self, k=0):
        with _NoHostTraffic():
            super().__call__(k)
        _GuardedGraphs.calls += 1


@pytest.mark.parametrize("case", CASES[:1] + CASES[2:3] + CASES[4:5],
                         ids=CASE_IDS[:1] + CASE_IDS[2:3] + CASE_IDS[4:5])
def test_chunks_read_the_host_only_through_the_loop(monkeypatch, case):
    reads = []

    def allowed(fn, log=None):
        def call(*args):
            _NoHostTraffic.allowed = True
            try:
                out = fn(*args)
            finally:
                _NoHostTraffic.allowed = False
            if log is not None:
                log.append(out)
            return out

        return call

    monkeypatch.setattr(solver, "_Graphs", _GuardedGraphs)
    monkeypatch.setattr(graphs, "_host_read", allowed(graphs._host_read, reads))
    monkeypatch.setattr(projection, "plain_proj_rows",
                        allowed(projection.plain_proj_rows))
    _GuardedGraphs.calls = 0
    solver.compiled_cache_clear()
    r0 = solver._backtrack_project.reads
    _run_fit(case, "cpu", True, 30, verbose=True)
    assert _GuardedGraphs.calls == 3
    # the line searches' flags and the chunk loop's (two a reporting call)
    line_search = solver._backtrack_project.reads - r0
    assert len(reads) == line_search + _flag_reads(3, True) and line_search > 0


def test_hoyer_fits_run_the_chunk_loop_workload(monkeypatch):
    """The dense-target, sparse-target and batched Hoyer fits run their
    chunk loop as ``_loop_workload``'s device loop (its body the chunk, its
    flag ``~stop & (k < limit)`` with a stop flag that never rises), one
    workload an entry, from the first chunk; a fit of fewer than 10
    iterations runs none."""
    made = []
    loop_workload = solver._loop_workload

    def spy(c, stop, chunk, device):
        made.append(bool(stop))
        loop_workload(c, stop, chunk, device)

    monkeypatch.setattr(solver, "_loop_workload", spy)
    solver.compiled_cache_clear()
    V, W, H = (torch.from_numpy(a) for a in _problem("NMF", 1))
    # the 47-iteration fit is a hit of the 30-iteration fit's entry
    for max_iter, n in ((9, 0), (30, 1), (47, 1)):
        dense = solver.get_hoyer_fit(NMF.reconstruct, None, 2.0, max_iter,
                                     True, True, 0.5, None, W.shape[0],
                                     H.shape[0])
        assert dense(V, W, H)[2] == max_iter and made == [False] * n
    Vs = sparse_from_dense(torch.where(V > 0.6, V, 0).numpy())
    sp = solver.get_hoyer_fit(None, NMF._sp_pos_neg, 1.0, 20, True, True,
                              None, 0.5, W.shape[0], H.shape[0])
    assert sp(Vs, W, H)[2] == 20 and made == [False] * 2
    from pytorch_nmf_tpu_torch import functional

    Wb, Hb, nb = functional.nmf_hoyer_fit_batched(V[None], W[None], H[None],
                                                  max_iter=20, sW=0.5)
    assert nb.tolist() == [20] and made == [False] * 3


def test_device_loop_and_counts_on_the_cpu():
    """Eagerly the loop reads its flag before each run; ``_Counted``
    passes its calls through and keeps its counts as attributes."""
    flag, n = torch.ones((), dtype=torch.bool), torch.zeros((), dtype=torch.int32)

    def body():
        n.add_(1)
        flag.copy_(n < 3)

    assert graphs._device_while(flag, body) == 4 and int(n) == 3
    assert graphs._device_while(flag, body) == 1 and int(n) == 3
    counted = graphs._Counted(lambda x: 2 * x, on_card=("hits",), hits=0,
                              reads=5)
    counted.add("hits", 2)
    assert counted(3) == 6 and counted.hits == 2 and counted.reads == 5
    assert projection.proj_rows.__name__ == "proj_rows"
    # scratch warm-ups take device loops too (SparsityProj); the CPU calls
    # the workload directly
    flag.fill_(True)
    g = graphs._Graphs([lambda: graphs._device_while(flag, body)], [n],
                       torch.device("cpu"), "m", conditional=True)
    g()
    assert int(n) == 4 and not bool(flag) and g.graphs is None


def test_sparse_target_keeps_the_eager_loop(monkeypatch):
    """A sparse target's Hoyer fit runs the chunked loop too (one _Graphs
    with device loops), equal to its eager loop (``_graph=False``) bit for
    bit."""
    made = []

    class Recording(graphs._Graphs):
        def __init__(self, *args, **kwargs):
            made.append(kwargs.get("conditional", False))
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(solver, "_Graphs", Recording)
    V, W, H = _problem("NMF", 4)
    V = np.where(V > 0.6, V, 0).astype("f")
    m = nmf_from_numpy({"W": W, "H": H}, "cpu")
    assert m.sparse_fit(sparse_from_dense(V), beta=1, max_iter=25, sH=0.5) == 25
    assert made == [True]
    Vs = sparse_from_dense(V)
    Wt, Ht = torch.from_numpy(W), torch.from_numpy(H)
    outs = [solver.get_hoyer_fit(None, NMF._sp_pos_neg, 1.0, 25, True, True,
                                 None, 0.5, Wt.shape[0], Ht.shape[0],
                                 _graph=graph)(Vs, Wt, Ht)
            for graph in (True, False)]
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    assert torch.equal(outs[0][1], m.H.detach())


def test_batched_hoyer_fit_runs_the_chunked_fit_per_problem(monkeypatch):
    """The batch is one chunked fit (one capture on the card), each of its
    problems that fit alone, attempt for attempt
    (``tests/test_torch_compiled_batched_hoyer.py``)."""
    made = []

    class Recording(graphs._Graphs):
        def __init__(self, *args, **kwargs):
            made.append(kwargs.get("conditional"))
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(solver, "_Graphs", Recording)
    from pytorch_nmf_tpu_torch import functional

    probs = [[torch.from_numpy(a) for a in _problem("NMF", s)] for s in (1, 2)]
    Vb, Wb, Hb = (torch.stack(x) for x in zip(*probs))
    W, H, n = functional.nmf_hoyer_fit_batched(Vb, Wb, Hb, max_iter=30, sW=0.5)
    assert n.tolist() == [30, 30] and made == [True]
    _, _, _, att = solver.get_batched_hoyer_fit(
        NMF.reconstruct, 2.0, 30, True, True, 0.5, None, Wb.shape[1],
        Hb.shape[1])(Vb, Wb, Hb, _attempts=True)
    for b, (V, W0, H0) in enumerate(probs):
        a0 = solver._backtrack_project.attempts
        Wa, Ha, _ = functional.nmf_hoyer_fit(V, W0, H0, max_iter=30, sW=0.5)
        assert int(att[b]) == solver._backtrack_project.attempts - a0
        assert _rel(W[b].numpy(), Wa.numpy()) <= 1e-6
        assert _rel(H[b].numpy(), Ha.numpy()) <= 1e-6


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


CARD_CASES = [CASES[0], CASES[2], CASES[3], CASES[4], CASES[6], CASES[7]]
CARD_IDS = [CASE_IDS[i] for i in (0, 2, 3, 4, 6, 7)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES, ids=CARD_IDS)
@pytest.mark.parametrize("max_iter", [20, 30, 47, 100])
def test_cuda_graphed_hoyer_fit_matches_eager(cuda, case, max_iter):
    r0 = graphs._Graphs.replays
    runs = _both_ways(case, cuda, max_iter, verbose=max_iter == 47)
    replays = graphs._Graphs.replays - r0
    (g, gcalls, gc), (e, ecalls, ec) = runs[True], runs[False]
    assert g[0].is_cuda and g[2] == e[2] == max_iter
    assert torch.equal(g[0], e[0]) and torch.equal(g[1], e[1])
    assert gcalls == ecalls
    chunks = max_iter // 10
    # chunks 1-2 eager; then one replay of the chunk loop for the rest (a
    # reporting fit one a chunk)
    verbose = max_iter == 47
    assert replays == (max(chunks - 2, 0) if verbose else int(chunks > 2))
    attempts, reads, p1, b3, b4, _ = gc
    assert (attempts, p1, b3, b4) == (ec[0], ec[2], ec[3], ec[4])
    constrained = sum(1 for s, t in zip(("sW", "sH"), case[3])
                      if t and s in case[2])
    assert p1 == constrained + attempts
    # the eager fit reads once an attempt; the graphed one only outside
    # the replayed chunks
    assert ec[1] == attempts
    if chunks >= 3:
        assert 0 < reads < attempts
    else:
        assert reads == attempts
    if case[0] == "NMFD":  # B4 for W's gradient, B3 for H's updates
        assert b4 > 0 and (b3 > 0) == case[3][1]


@pytest.mark.cuda
@pytest.mark.parametrize("case", [CASES[0], CASES[2], CASES[4], CASES[6]],
                         ids=[CASE_IDS[i] for i in (0, 2, 4, 6)])
def test_cuda_warm_hoyer_fit_is_one_replay(cuda, case):
    """A warm fit (other inits on the kept entry) and a fit on a new V
    (one capture) are one replay of the whole chunk loop, the line
    searches' WHILE nodes nested in its body, with no host read; the cold
    fit two eager chunks, one capture and one replay.  Each is bit for bit
    its eager twin, with the same attempts and B3/B4 launches and P1
    launches equal to the constrained factors plus the attempts, counted on
    the card through the nested bodies."""
    name, seed, kw, (tw, th) = case
    V, W, H = (torch.from_numpy(a).to(cuda) for a in _problem(name, seed))
    V2 = V.clone()
    cls = NMF if name == "NMF" else NMFD
    recon = cls._resolve_fit_recon2(V, W, H, 2.0)
    sW, sH = kw.get("sW") if tw else None, kw.get("sH") if th else None
    constrained = (sW is not None) + (sH is not None)

    def fit(graph, X, W0, H0):
        c0, r0 = _counts(), graphs._Graphs.replays
        k0 = graphs._Graphs.captures
        out = solver.get_hoyer_fit(
            recon, None, 2.0, 30, tw, th, sW, sH, W.numel() // W.shape[1],
            H.numel() // H.shape[1], _graph=graph)(X, W0, H0)
        torch.cuda.synchronize()
        counts = [a - b for a, b in zip(_counts(), c0)]
        return out, counts, (graphs._Graphs.replays - r0,
                             graphs._Graphs.captures - k0)

    Wb, Hb = W.roll(1, 0), H.roll(1, 0)
    runs = {"cold": fit(True, V, W, H), "warm": fit(True, V, Wb, Hb),
            "new V": fit(True, V2, W, H)}
    twins = {"cold": fit(False, V, W, H), "warm": fit(False, V, Wb, Hb)}
    twins["new V"] = twins["cold"]
    assert runs["cold"][2] == (1, 1)
    assert runs["warm"][2] == (1, 0) and runs["new V"][2] == (1, 1)
    for how, (out, counts, _) in runs.items():
        ref, rc, _ = twins[how]
        assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
        attempts, reads, p1, b3, b4, loop_reads = counts
        assert (attempts, p1, b3, b4) == (rc[0], rc[2], rc[3], rc[4]), how
        assert p1 == constrained + attempts and attempts >= 30 * constrained
        if how != "cold":  # nothing read on the host
            assert reads == loop_reads == 0, how


@pytest.mark.cuda
def test_cuda_replayed_chunks_read_nothing(cuda):
    """A 30-iteration fit's third chunk is a replay: its line searches add
    no host read, and the first two chunks read as the eager fit's do."""
    case = CASES[0]
    r0 = solver._backtrack_project.reads
    _run_fit(case, cuda, True, 20)
    twenty = solver._backtrack_project.reads - r0
    r0 = solver._backtrack_project.reads
    _run_fit(case, cuda, True, 30)
    assert solver._backtrack_project.reads - r0 == twenty


@pytest.mark.cuda
def test_cuda_host_reading_chunk_raises(cuda):
    V, W, H = (torch.from_numpy(a).to(cuda) for a in _problem("NMF", 1))

    def reading(h, w):
        if float(w.sum()) < 0:  # a host read
            raise AssertionError
        return NMF.reconstruct(h, w)

    with pytest.raises(RuntimeError, match="cannot be captured"):
        solver.get_hoyer_fit(reading, None, 2.0, 30, True, True, 0.5, None,
                             W.shape[0], H.shape[0])(V, W, H)
    assert solver.get_hoyer_fit(reading, None, 2.0, 30, True, True, 0.5, None,
                                W.shape[0], H.shape[0],
                                _graph=False)(V, W, H)[2] == 30


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["NMF", "NMFD"])
def test_cuda_nothing_outlives_the_hoyer_fit(cuda, name):
    V, W0, H0 = _problem(name, 1)
    V = torch.from_numpy(V).to(cuda)
    m = nmf_from_numpy({"W": W0, "H": H0}, cuda)
    dead = weakref.ref(V)
    m.sparse_fit(V, beta=2, max_iter=40, sW=0.5)
    del V
    assert dead() is None


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["NMF", "NMFD"])
def test_cuda_graphed_hoyer_fits_keep_no_memory(cuda, name):
    """A graphed Hoyer fit keeps only its cache entry on the card (the
    bodies' pool and count freed with it): a hit adds nothing, and
    ``compiled_cache_clear`` gives the allocated memory back; its counts
    are read only after."""
    V, W0, H0 = _problem(name, 1)
    V = torch.from_numpy(V).to(cuda)
    m = nmf_from_numpy({"W": W0, "H": H0}, cuda)
    m.sparse_fit(V, beta=2, max_iter=40, sW=0.5)  # builds, workspaces
    solver.compiled_cache_clear()
    # cuBLAS keeps a workspace for each stream that ran a product eagerly:
    # not the fit's; dropped before each reading
    clear_workspaces = torch._C._cuda_clearCublasWorkspaces
    torch.cuda.synchronize()
    clear_workspaces()
    allocated = torch.cuda.memory_allocated()
    after = []
    for max_iter in (40, 50, 30, 40, 50, 30):
        m.sparse_fit(V, beta=2, max_iter=max_iter, sW=0.5)
        torch.cuda.synchronize()
        clear_workspaces()
        after.append(torch.cuda.memory_allocated())
    assert after[3:] == [after[2]] * 3  # hits
    solver.compiled_cache_clear()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == allocated
    assert projection.proj_rows.launches > 0


@pytest.mark.cuda
def test_cuda_deconv_hoyer_graphed_on_the_kernels(cuda):
    """The NMFD fit on B3/B4 (``kernel_adjoint_deconv``) graphed against
    eager: bit for bit, with the same kernel launches."""
    case = CASES[6]
    runs = _both_ways(case, cuda, 30, recon=fast_nmfd.kernel_adjoint_deconv)
    (g, _, gc), (e, _, ec) = runs[True], runs[False]
    assert torch.equal(g[0], e[0]) and torch.equal(g[1], e[1])
    assert gc[0] == ec[0] and gc[2:5] == ec[2:5]
    assert gc[3] == 30 and gc[4] == 30  # one B3 and one B4 an iteration

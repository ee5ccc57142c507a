"""The fits' chunk loop as one device loop (``ops/solver._graphed_loop``,
``_graphed_batched_loop``), as JAX's ``lax.while_loop``: the five factories
that run it (``get_dense_fit``, ``get_sparse_fit`` at each tier,
``get_plca_fit`` with either E-step, ``get_batched_dense_fit``,
``get_batched_plca_fit``) run their 10-iteration chunks as the body of
``graphs._device_while`` on ``~stop & (k < limit)`` (the batched fits
``~done & (k < limit)``), with ``k`` counted and ``limit`` loaded on the
device: on the card a CUDA-graph WHILE node, a warm fit one replay; on the
CPU the same workload runs eagerly, reading the flag before each chunk.

CPU tests, from numpy seeds at small sizes:

* every factory's fit equals its ``_graph=False`` twin bit for bit with
  the same ``n_iter``, and the JAX package's jitted fit within 1e-5 with
  its ``n_iter``, at ``max_iter`` ∈ {0, 5, 10, 47, 100};
* a ``tol`` that stops the fit mid-fit, at chunk 3 or 4 (between two
  chunks' relative decreases, at their geometric mean, every decrease at
  least 15% from it), against the eager twin and JAX;
* a NaN loss (NaN compares False: every chunk runs, ``n_iter`` is
  ``max_iter``), against the eager twin;
* one cache entry across fits of 100, 30 and 200 iterations (``limit``
  loaded a fit): one cold miss and two hits, each bit for bit its twin;
* a verbose fit's progress events (chunk, loss, PLCA's log-probability)
  equal the JAX fit's progress handler's;
* a batch whose problems converge at different chunks, one at chunk 3 or
  later: each problem's ``n_iter`` and factors JAX's;
* the loop's host reads: its flag's (before each chunk of a call, and
  after the call's last) and one ``(k, stop)`` a fit;
* nested device loops (the Hoyer fits' chunk loop holds its line
  searches'): an outer loop whose body runs two inner ones gives a plain
  Python loop's results and reads; the bodies at one depth must launch
  the same kernels, and each depth keeps its own increase an execution.

CUDA tests (marked ``cuda``; skipped without a card) run the same cases
on the card against ``_graph=False``: bit for bit (the gather tier within
1e-4: scatter-adds by atomics), a cold fit two eager chunks, one capture
and one replay, a warm fit one replay, no capture and one host read (the
batched fits none), the kernels' launch counts (the replay's taken on the
card) equal to the eager fit's; the nested loops captured (WHILE nodes
in a WHILE node's body) against eager, their bodies' executions and a
count they move counted on the card at each depth.
``python -m pytest --noconftest -m cuda tests/test_torch_device_loop.py``.
"""

import contextlib
import os
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pytorch_nmf_tpu_torch.metrics import beta_div, kl_div  # noqa: E402
from pytorch_nmf_tpu_torch.nmf import NMF  # noqa: E402
from pytorch_nmf_tpu_torch.ops import (fast_plca, fused_deconv, fused_mu,  # noqa: E402
                                       graphs, solver, sparse)
from pytorch_nmf_tpu_torch.ops.fast_nmf import nmf_updater_factory_generic  # noqa: E402
from pytorch_nmf_tpu_torch.plca import PLCA  # noqa: E402
from pytorch_nmf_tpu_torch.utils import plca_from_numpy  # noqa: E402

RTOL = 1e-5
MAX_ITERS = [0, 5, 10, 47, 100]
# kind → the environment that forces it in both packages (sparse tiers)
TIERS = {"densify": {"PNT_SPARSE_DENSIFY": "1"},
         "ell": {"PNT_SPARSE_DENSIFY": "0", "PNT_SPARSE_ELL": "1",
                 "PNT_SPARSE_ELL_MAX_PAD": "1e9"},
         "gather": {"PNT_SPARSE_DENSIFY": "0", "PNT_SPARSE_ELL": "0"}}
KINDS = ["dense", "sparse-densify", "sparse-ell", "sparse-gather",
         "plca", "plca-fused", "batched-dense", "batched-plca"]
SINGLE = KINDS[:6]
BATCHED = KINDS[6:]
BETA = 1.0
# a tol sits at least this factor from every chunk's relative decrease
MARGIN = 1.15


@pytest.fixture(scope="module")
def jx():
    """The JAX package's models, sparse ops, functional API and solver,
    imported only by the tests that compare with it."""
    pytest.importorskip("jax")
    from pytorch_nmf_tpu import functional
    from pytorch_nmf_tpu.models import nmf, plca
    from pytorch_nmf_tpu.ops import solver as jsolver
    from pytorch_nmf_tpu.ops import sparse as jsparse

    return SimpleNamespace(NMF=nmf.NMF, PLCA=plca.PLCA, F=functional,
                           sparse=jsparse, solver=jsolver)


@pytest.fixture(autouse=True)
def fresh():
    """One intra-op thread (these small fits run several times faster on
    it), an empty cache before and after each test (each first fit cold),
    and the sparse tiers' switches unset."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    solver.compiled_cache_clear()
    yield
    solver.compiled_cache_clear()
    torch.set_num_threads(threads)


@contextlib.contextmanager
def _tier(kind):
    """The sparse tier's switches set for both packages."""
    env = TIERS.get(kind.split("-")[-1], {}) if kind.startswith("sparse") \
        else {}
    names = ("PNT_SPARSE_DENSIFY", "PNT_SPARSE_ELL", "PNT_SPARSE_ELL_MAX_PAD")
    saved = {k: os.environ.pop(k, None) for k in names}
    os.environ.update(env)
    try:
        yield
    finally:
        for k in names:
            os.environ.pop(k, None)
            if saved[k] is not None:
                os.environ[k] = saved[k]


def _arrays(kind, seed=0, nan=False):
    """numpy ``(V, W0, H0)`` (``+ Z0`` for PLCA): a 30×20 target, rank 3
    (the batched kinds 4 problems, mixing ``rand`` with a rank-3 product);
    the sparse kinds keep the entries of ``rand`` above 0.5.  ``nan``: one entry of V (of the last problem) is
    NaN."""
    rs = np.random.RandomState(seed)
    B = (4,) if kind.startswith("batched") else ()
    V = rs.rand(*B, 30, 20).astype("f") + 0.01
    if B:  # a rank-3 product's share rising across the batch: the problems
        # converge at different rates
        low = np.einsum("bmr,bkr->bmk", rs.rand(4, 30, 3),
                        rs.rand(4, 20, 3)).astype("f") / 3
        share = np.linspace(0, 1, 4).astype("f")[:, None, None]
        V = (share * low + (1 - share) * V).astype("f")
    if kind.startswith("sparse"):
        V = np.where(V > 0.5, V, 0).astype("f")
    W = rs.rand(*B, 20, 3).astype("f") + 0.1
    H = rs.rand(*B, 30, 3).astype("f") + 0.1
    if nan:
        V[(-1, 3, 4) if B else (3, 4)] = np.nan
    if "plca" not in kind:
        return V, W, H
    axis = len(B)
    W = W / W.sum(axis, keepdims=True)
    H = H / H.sum(axis, keepdims=True)
    return V, W, H, np.full(B + (3,), 1 / 3, "f")


def _problem(kind, device="cpu", seed=0, nan=False):
    """The port's target (a sparse kind's COO tensor, the ELL tier's layout)
    and inits (PLCA's normalized by the model) on ``device``: one target,
    so that fits on it share a cache entry."""
    arrays = [torch.from_numpy(a).to(device) for a in _arrays(kind, seed, nan)]
    if kind.startswith("sparse"):
        Vs = sparse.sparse_from_dense(arrays[0].nan_to_num(1.0))
        if nan:  # a stored value (sparse_from_dense keeps V > 0 only)
            Vs._values()[5] = float("nan")
        arrays[0] = sparse.build_ell(Vs) if kind.endswith("ell") else Vs
    if kind.startswith("plca"):
        m = plca_from_numpy({k: a.cpu().numpy() for k, a in zip(
            "WHZ", arrays[1:])}, device)
        arrays[1:] = [p.detach() for p in (m.W, m.H, m.Z)]
    return arrays


def _port(kind, graph, tol, max_iter, device="cpu", verbose=False, seed=0,
          nan=False, problem=None):
    """The port's fit of ``kind`` on ``problem`` (:func:`_problem`, made
    anew if ``None``) through its factory, as the models and ``functional``
    build it, with ``_graph``: ``(tensors, n_iter)`` (``n_iter`` a list for
    the batched kinds)."""
    arrays = problem or _problem(kind, device, seed, nan)
    if kind == "dense":
        V, W, H = arrays
        fit = solver.get_dense_fit(
            NMF.reconstruct, BETA, tol, max_iter, True, True, 0.0, 0.0,
            verbose, NMF._resolve_updater_factory(V, W, H, BETA),
            _graph=graph)
        W, H, n = fit(V, W, H)
        return [W, H], n
    if kind.startswith("sparse"):
        target, W, H = arrays
        tier = kind.split("-")[1]
        factory = (NMF._resolve_updater_factory(target, W, H, BETA)
                   if tier == "densify" else None)
        with _tier(kind):
            fit = solver.get_sparse_fit(
                NMF._sp_pos_neg, BETA, tol, max_iter, True, True, 0.0, 0.0,
                verbose, tier, NMF.reconstruct, factory, _graph=graph)
            W, H, n = fit(target, W, H)
        return [W, H], n
    if kind.startswith("plca"):
        V, W, H, Z = arrays
        engine = (fast_plca.plca_em_engine_fused if kind == "plca-fused"
                  else None)
        fit = solver.get_plca_fit(PLCA._resolve_fit_recon3(V, W, H, Z), tol,
                                  max_iter, True, True, True, False, False,
                                  False, verbose, em_engine=engine,
                                  _graph=graph)
        one = V.new_ones(())
        *f, n, norm = fit(V, W, H, Z, one, one, one)
        return f + [norm], n
    if kind == "batched-dense":
        fit = solver.get_batched_dense_fit(NMF.reconstruct, BETA, tol,
                                           max_iter, True, True, 0.0, 0.0,
                                           nmf_updater_factory_generic,
                                           _graph=graph)
        W, H, n = fit(*arrays)
        return [W, H], n.tolist()
    fit = solver.get_batched_plca_fit(PLCA.reconstruct, tol, max_iter, True,
                                      True, True, False, False, False,
                                      _graph=graph)
    one = arrays[0].new_ones(())
    *f, n, norm = fit(*arrays, one, one, one)
    return f + [norm], n.tolist()


def _jax(jx, kind, tol, max_iter, seed=0):
    """The JAX package's fit from the same numpy arrays: ``(arrays,
    n_iter)``, the factors (and PLCA's norm) as numpy arrays."""
    arrays = _arrays(kind, seed)
    if kind == "dense" or kind.startswith("sparse"):
        V, W, H = arrays
        ref = jx.NMF(W=W, H=H)
        target = jx.sparse.sparse_from_dense(V) if kind.startswith(
            "sparse") else V
        with _tier(kind):
            n = ref.fit(target, beta=BETA, tol=tol, max_iter=max_iter)
        return [np.asarray(ref.W.data), np.asarray(ref.H.data)], int(n)
    if kind.startswith("plca"):
        V, W, H, Z = arrays
        ref = jx.PLCA(W=W, H=H, Z=Z)
        n, norm = ref.fit(V, tol=tol, max_iter=max_iter)
        return [np.asarray(ref.W.data), np.asarray(ref.H.data),
                np.asarray(ref.Z.data), np.asarray(norm)], int(n)
    if kind == "batched-dense":
        W, H, n = jx.F.nmf_fit_batched(*arrays, beta=BETA, tol=tol,
                                       max_iter=max_iter)
        return [np.asarray(W), np.asarray(H)], np.asarray(n).tolist()
    W, H, Z, n, norm = jx.F.plca_fit_batched(*arrays, tol=tol,
                                             max_iter=max_iter)
    return [np.asarray(x) for x in (W, H, Z, norm)], np.asarray(n).tolist()


def _rel(got, ref):
    got, ref = np.asarray(got, "f8"), np.asarray(ref, "f8")
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _full(kind, max_iter):
    """``n_iter`` of a fit that runs every chunk (PLCA's raw index)."""
    n = max_iter - kind.startswith(("plca", "batched-plca"))
    return [n] * 4 if kind.startswith("batched") else n


def _assert_twins(got, ref, kind="", device="cpu"):
    """Bit for bit (NaN where the twin has NaN); the gather tier on the
    card within 1e-4 where finite (scatter-adds by atomics), NaN where the
    twin has NaN."""
    for a, b in zip(got, ref):
        if kind == "sparse-gather" and device != "cpu":
            assert torch.equal(a.isnan(), b.isnan())
            fin = ~b.isnan()
            if fin.any():
                assert float((a[fin] - b[fin]).abs().max()
                             / b[fin].abs().max()) <= 1e-4
        else:
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def _cold_reads(kind, chunks, n_chunks):
    """The CPU's host reads of a cold fit that ran ``chunks`` of
    ``n_chunks`` chunks, not verbose: the device loop's flag before each
    chunk of a call and after the call's last (chunks 1 and 2 a call each,
    as the card's warm-ups, the rest one call; a call that finds the flag
    down reads it once), and one read of ``(k, stop)`` (not the batched
    fits, which read nothing else)."""
    if n_chunks == 0:
        return 0
    status = 0 if kind.startswith("batched") else 1
    if chunks < n_chunks and chunks <= 2:  # stopped: the next call reads 1
        flags = 2 * chunks + 1
    else:
        flags = 2 * min(chunks, 2) + (chunks - 1 if chunks > 2 else 0)
    return flags + status


# ---------------------------------------------------------------- CPU: JAX
@pytest.mark.parametrize("max_iter", MAX_ITERS)
@pytest.mark.parametrize("kind", KINDS)
def test_loop_fit_matches_eager_and_jax(jx, kind, max_iter):
    r0 = solver._read.reads
    got, n = _port(kind, True, 0.0, max_iter)
    reads = solver._read.reads - r0
    ref, rn = _port(kind, False, 0.0, max_iter)
    _assert_twins(got, ref)
    assert n == rn == _full(kind, max_iter)
    chunks = max_iter // 10
    assert reads == _cold_reads(kind, chunks, chunks)
    want, jn = _jax(jx, kind, 0.0, max_iter)
    assert jn == n
    for a, b in zip(got, want):
        assert _rel(a.numpy(), b) <= RTOL


def _stop_tol(kind):
    """A tol at which the fit of 100 iterations stops mid-fit: a single fit
    at chunk 3 or 4, a batch's problems at different chunks, one at 3 or
    later; and each problem's stop (0: none)."""
    if kind.startswith("batched"):
        return _tol(_losses(kind, 10),
                    lambda s: len(set(s)) > 1 and max(s) >= 3)
    return _tol(_losses(kind, 5), lambda s: s[0] in (3, 4))


def _losses(kind, chunks=5):
    """The eager fit's loss before the fit and after each of ``chunks``
    chunks, ``(chunks + 1, B)`` (B = 1 for a single fit)."""
    arrays = [torch.from_numpy(a) for a in _arrays(kind)]
    V = arrays[0]
    if kind.startswith(("plca", "batched-plca")):
        lead = V.shape[:1] if kind.startswith("batched") else ()
        norm = V.reshape(*lead, -1).sum(-1)
        Vn = V / norm.reshape(lead + (1, 1))

        def loss(f):
            w, h, z = f[:3]
            one = (lambda v, w, h, z, n: torch.sqrt(
                2.0 * kl_div(PLCA.reconstruct(h, w, z) * n, v * n)))
            if lead:
                return torch.func.vmap(one)(Vn, w, h, z, norm)
            return one(Vn, w, h, z, norm)[None]
    elif kind.startswith("sparse"):
        Vs = sparse.sparse_from_dense(V)

        def loss(f):
            pos, neg = sparse.nmf_sp_pos_neg(Vs, f[1], f[0], BETA)
            return torch.sqrt(2.0 * (sparse.get_V_norm(Vs, BETA) + pos
                                     - neg))[None]
    else:
        def loss(f):
            if kind.startswith("batched"):
                return torch.sqrt(2.0 * torch.func.vmap(
                    lambda wh, v: beta_div(wh, v, BETA))(
                        NMF.reconstruct(f[1], f[0]), V))
            return torch.sqrt(2.0 * beta_div(NMF.reconstruct(f[1], f[0]), V,
                                             BETA))[None]

    start = arrays[1:] if "plca" not in kind else None
    if start is None:  # PLCA's normalized inits
        start = _port(kind, False, 0.0, 0)[0]
    rows = [loss(start)]
    for c in range(1, chunks + 1):
        rows.append(loss(_port(kind, False, 0.0, 10 * c)[0]))
    return torch.stack(rows).double().numpy()


def _tol(losses, want):
    """A ``tol`` whose stops (each problem's first chunk whose relative
    decrease is under it; 0: none) satisfy ``want(stops)``, with every
    decrease at least :data:`MARGIN` from it: the geometric means of
    neighbouring decreases, tried in order."""
    d = -np.diff(losses, axis=0) / losses[0]
    flat = np.sort(d.ravel())
    for tol in np.sqrt(flat[1:] * flat[:-1]):
        if tol <= 0 or np.min(np.maximum(d / tol, tol / d)) < MARGIN:
            continue
        below = d < tol
        stops = np.where(below.any(0), below.argmax(0) + 1, 0).tolist()
        if want(stops):
            return float(tol), stops
    raise AssertionError(f"no tol: {d}")


@pytest.mark.parametrize("kind", KINDS)
def test_tol_stops_the_loop_where_eager_and_jax_stop(jx, kind):
    """Single fits stop at chunk 3 or 4; the batched fits' problems at
    different chunks, one at 3 or later (the rest of the batch frozen)."""
    tol, stops = _stop_tol(kind)
    r0 = solver._read.reads
    got, n = _port(kind, True, tol, 100)
    reads = solver._read.reads - r0
    ref, rn = _port(kind, False, tol, 100)
    _assert_twins(got, ref)
    plca = "plca" in kind
    want_n = [10 * s - plca if s else 100 - plca for s in stops]
    assert n == rn == (want_n if kind.startswith("batched") else want_n[0])
    run = 10 if 0 in stops else max(stops)
    assert reads == _cold_reads(kind, run, 10)
    want, jn = _jax(jx, kind, tol, 100)
    assert jn == n
    for a, b in zip(got, want):
        assert _rel(a.numpy(), b) <= RTOL


@pytest.mark.parametrize("kind", ["dense", "sparse-gather", "plca",
                                  "batched-dense"])
def test_nan_loss_runs_every_chunk(kind):
    """A NaN in V makes the loss NaN, whose stop test is False: the loop
    runs every chunk (the batch's other problems stop on their own)."""
    got, n = _port(kind, True, 1e-3, 47, nan=True)
    ref, rn = _port(kind, False, 1e-3, 47, nan=True)
    _assert_twins(got, ref)
    assert n == rn
    if kind.startswith("batched"):
        assert n[-1] == 47
        assert not torch.isnan(got[0][0]).any() and torch.isnan(
            got[0][-1]).any()
    else:
        assert n == _full(kind, 47) and torch.isnan(got[0]).any()


@pytest.mark.parametrize("kind", KINDS)
def test_one_entry_across_max_iter(kind):
    """Fits of 100, 30 and 200 iterations on one target share one entry
    (``max_iter`` is not in the key): the limit is loaded at each, so each
    runs its own chunks, bit for bit its twin."""
    problem = _problem(kind)
    info = solver.compiled_cache_info()
    for max_iter in (100, 30, 200):
        got, n = _port(kind, True, 0.0, max_iter, problem=problem)
        ref, rn = _port(kind, False, 0.0, max_iter, problem=problem)
        _assert_twins(got, ref)
        assert n == rn == _full(kind, max_iter)
    now = solver.compiled_cache_info()
    assert (now["cold_misses"] - info["cold_misses"],
            now["hits"] - info["hits"]) == (1, 2)


@pytest.mark.parametrize("kind", KINDS)
def test_warm_fit_is_one_call_of_the_loop(kind, monkeypatch):
    """A fit on a kept entry runs the loop workload once (on the card one
    replay), reading its flag before each chunk and once after, and ``(k,
    stop)`` once (the batched fits nothing more); a cold fit calls it for
    chunk 1, chunk 2 and the rest."""
    calls = []
    run = graphs._Graphs.__call__

    def counting(self, k=0):
        calls.append(k)
        run(self, k)

    monkeypatch.setattr(graphs._Graphs, "__call__", counting)
    problem = _problem(kind)
    _port(kind, True, 0.0, 47, problem=problem)
    assert len(calls) == 3
    calls.clear()
    r0 = solver._read.reads
    _port(kind, True, 0.0, 47, problem=problem)
    assert len(calls) == 1
    assert solver._read.reads - r0 == 4 + 1 + (not kind.startswith(
        "batched"))


@pytest.mark.parametrize("kind", SINGLE)
@pytest.mark.parametrize("stop", [False, True])
def test_verbose_events_match_jax(jx, kind, stop):
    """A verbose fit reports each chunk (the loop one chunk a call): the
    same events as JAX's progress handler, the same as the eager twin's,
    at ``tol=0`` and at a ``tol`` that stops at chunk 3 or 4."""
    import jax

    tol, stops = _stop_tol(kind) if stop else (0.0, [4])
    events = {}
    for how in ("graph", "eager", "jax"):
        got = []
        push, pop = ((jx.solver.push_progress_handler,
                      jx.solver.pop_progress_handler) if how == "jax" else
                     (solver.push_progress_handler,
                      solver.pop_progress_handler))
        push(lambda k, loss, extra: got.append((k, loss, extra)))
        try:
            if how == "jax":
                arrays = _arrays(kind)
                if kind.startswith("plca"):
                    jx.PLCA(W=arrays[1], H=arrays[2], Z=arrays[3]).fit(
                        arrays[0], tol=tol, max_iter=47, verbose=True)
                else:
                    target = (jx.sparse.sparse_from_dense(arrays[0])
                              if kind.startswith("sparse") else arrays[0])
                    with _tier(kind):
                        jx.NMF(W=arrays[1], H=arrays[2]).fit(
                            target, beta=BETA, tol=tol, max_iter=47,
                            verbose=True)
                jax.effects_barrier()  # the callbacks have run
            else:
                _port(kind, how == "graph", tol, 47, verbose=True)
        finally:
            pop()
        events[how] = got
    assert events["graph"] == events["eager"]
    assert [e[0] for e in events["graph"]] == [e[0] for e in events["jax"]] \
        == list(range(1, stops[0] + 1))
    for (_, loss, extra), (_, jloss, jextra) in zip(events["graph"],
                                                   events["jax"]):
        assert loss == pytest.approx(jloss, rel=RTOL)
        assert (extra is None) == (jextra is None)
        if extra is not None:
            assert extra == pytest.approx(jextra, rel=RTOL)


def test_settle_done_only_adds_the_finished_counts(monkeypatch):
    """A fit's end hands its bodies' count to ``graphs._PENDING``; past
    ``_PENDING_MAX`` entries the next end adds in those whose copies are
    done (``_settle(done_only=True)``) and keeps the rest, so many fits
    with no read of a count hold few; a read adds in all."""

    class Event:
        def __init__(self, done):
            self.done = done

        def query(self):
            return self.done

        def synchronize(self):
            self.done = True

    counter = SimpleNamespace(n=0)
    monkeypatch.setattr(graphs, "_kernel_counters", lambda: ((counter, "n"),))
    monkeypatch.setattr(graphs, "_PENDING", [])
    graphs._PENDING.extend((torch.tensor(c), Event(c != 3), [2])
                           for c in (1, 3, 5))
    graphs._settle(done_only=True)
    assert vars(counter)["n"] == 2 * (1 + 5) and len(graphs._PENDING) == 1
    graphs._settle()
    assert vars(counter)["n"] == 2 * 9 and not graphs._PENDING


def _nested(device, seen=None):
    """A workload of nested device loops: an outer loop on ``k < 3`` whose
    body runs two inner loops, on ``m < 2 + k`` and ``m < 3 + k`` (9 and
    12 runs in all), each run halving and adding to ``acc``; ``runs``
    counts the bodies' runs (outer, inner 1, inner 2) on the device, and
    the bodies move ``seen["outer"]``/``seen["inner"]`` on the host once a
    run (once at capture on the card).  Returns ``(work, acc, runs,
    reads)``: ``work()`` returns the outer loop's reads and adds the inner
    loops' to ``reads``."""
    k = torch.zeros((), dtype=torch.int64, device=device)
    go = torch.zeros((), dtype=torch.bool, device=device)
    ms = [torch.zeros((), dtype=torch.int64, device=device) for _ in range(2)]
    again = [torch.zeros((), dtype=torch.bool, device=device)
             for _ in range(2)]
    acc = torch.zeros(6, device=device)
    step = torch.arange(1.0, 7.0, device=device)
    runs = torch.zeros(3, dtype=torch.int64, device=device)
    reads = []

    def inner(i):
        def body():
            acc.mul_(0.5).add_(step * (i + 1))
            ms[i].add_(1)
            runs[1 + i].add_(1)
            torch.lt(ms[i], k + 2 + i, out=again[i])
            if seen is not None:
                seen["inner"] += 1

        return body

    def outer():
        for i in range(2):
            ms[i].zero_()
            again[i].fill_(True)
            reads.append(graphs._device_while(again[i], inner(i)))
        acc.add_(1.0)
        k.add_(1)
        runs[0].add_(1)
        torch.lt(k, 3, out=go)
        if seen is not None:
            seen["outer"] += 1

    def work():
        k.zero_()
        acc.zero_()
        runs.zero_()
        torch.lt(k, 3, out=go)
        return graphs._device_while(go, outer)

    return work, acc, runs, reads


def _nested_plain():
    """:func:`_nested`'s loops in plain Python: ``(acc, runs, outer reads,
    inner reads)``."""
    acc, runs, inner_reads = np.zeros(6, "f"), [0, 0, 0], 0
    step = np.arange(1.0, 7.0, dtype="f")
    for k in range(3):
        for i in range(2):
            m = 0
            inner_reads += 1
            while True:
                acc = acc * np.float32(0.5) + step * np.float32(i + 1)
                m += 1
                runs[1 + i] += 1
                inner_reads += 1
                if not m < k + 2 + i:
                    break
        acc = acc + np.float32(1.0)
        runs[0] += 1
    return acc, runs, 3 + 1, inner_reads


def test_nested_device_loops_on_the_cpu():
    """Eagerly a nested device loop is nested Python loops: the same
    values and runs, each loop reading its flag before each run and once
    after its last (the outer loop 4 reads, the inner loops' 9 + 12 runs
    and 6 last reads)."""
    work, acc, runs, reads = _nested("cpu")
    outer_reads = work()
    plain, plain_runs, plain_outer, plain_inner = _nested_plain()
    np.testing.assert_array_equal(acc.numpy(), plain)
    assert runs.tolist() == plain_runs == [3, 9, 12]
    assert outer_reads == plain_outer == 4
    assert sum(reads) == plain_inner == 9 + 12 + 6
    # the workload of a _Graphs on the CPU runs the same, directly
    work2, acc2, runs2, _ = _nested("cpu")
    g = graphs._Graphs([work2], None, torch.device("cpu"), "m",
                       conditional=True)
    for _ in range(3):
        g()
        assert torch.equal(acc2, acc) and torch.equal(runs2, runs)


def test_bodies_at_one_depth_launch_the_same_kernels(monkeypatch):
    """Each depth keeps the increase an execution of its first body; a
    later body at that depth that launches other kernels raises, one at
    another depth may differ; a body may move only counts kept on the
    card."""
    probe = graphs._Counted(lambda: None, on_card=("card",), card=0, host=0)
    monkeypatch.setattr(graphs, "_kernel_counters",
                        lambda: ((probe, "card"), (probe, "host")))
    bodies = graphs._Bodies.__new__(graphs._Bodies)
    bodies.deltas = [None] * graphs._MAX_DEPTH
    for depth, delta in ((0, [2, 0]), (1, [1, 0]), (1, [1, 0]), (0, [2, 0])):
        bodies.take(depth, delta)
    assert bodies.deltas == [[2, 0], [1, 0]] + [None] * (graphs._MAX_DEPTH - 2)
    with pytest.raises(RuntimeError, match="at one depth"):
        bodies.take(1, [2, 0])
    bodies.deltas = [None] * graphs._MAX_DEPTH
    with pytest.raises(RuntimeError, match="counts only on the host"):
        bodies.take(0, [0, 1])


# ---------------------------------------------------------------- CUDA
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    solver.compiled_cache_clear()
    return "cuda"


def _counts():
    """The kernels' launch counts and the ELL tier's reductions (those of a
    replay taken on the card when read)."""
    return (fused_mu.fused_contractions.launches,
            fused_mu.fused_beta_loss.launches, fused_deconv.hgrad.launches,
            fused_deconv.wgrad.launches, sparse.ell_neg_grad.reductions)


def _card(kind, graph, tol, max_iter, **kw):
    """``(out, n, launches, replays, captures, reads)`` of one fit on the
    card."""
    c0, r0 = _counts(), graphs._Graphs.replays
    k0, h0 = graphs._Graphs.captures, solver._read.reads
    out, n = _port(kind, graph, tol, max_iter, "cuda", **kw)
    torch.cuda.synchronize()
    return (out, n, [a - b for a, b in zip(_counts(), c0)],
            graphs._Graphs.replays - r0, graphs._Graphs.captures - k0,
            solver._read.reads - h0)


@pytest.mark.cuda
@pytest.mark.parametrize("max_iter", [5, 20, 47, 100])
@pytest.mark.parametrize("kind", KINDS)
def test_cuda_loop_fit_matches_eager(cuda, kind, max_iter):
    """A cold fit (chunks 1-2 eager, the capture, one replay), then a warm
    one (one replay, no capture, one host read; the batched fits none),
    each against ``_graph=False``."""
    problem = _problem(kind, cuda)
    cold = _card(kind, True, 0.0, max_iter, problem=problem)
    warm = _card(kind, True, 0.0, max_iter, problem=problem)
    ref = _card(kind, False, 0.0, max_iter, problem=problem)
    chunks = max_iter // 10
    status = int(not kind.startswith("batched"))
    for got in (cold, warm):
        _assert_twins(got[0], ref[0], kind, cuda)
        assert got[1] == ref[1] == _full(kind, max_iter)
        assert got[2] == ref[2]  # launches, the replay's counted on the card
    if chunks:
        # (replays, captures, host reads): chunks 1-2 eager, the flag read
        # before and after each; the capture when a third chunk follows
        assert cold[3:] == (int(chunks > 2), int(chunks > 2),
                            2 * min(chunks, 2) + status)
        # a hit: the entry's chunk captured now if the cold fit did not
        assert warm[3:] == (1, int(chunks <= 2), status)
    assert ref[3:] == (0, 0, chunks)


@pytest.mark.cuda
def test_cuda_nested_device_loops_match_eager(cuda, monkeypatch):
    """The nested loops captured (two WHILE nodes in a WHILE node's body),
    replayed once: the eager run's values and runs; the bodies'
    executions on the card at each depth (3 outer, 9 + 12 inner), and a
    count the bodies move settled from them (its capture's ticks taken
    back)."""
    graphs._settle()  # earlier fits' counts, before the counts' table moves
    seen = {"outer": 0, "inner": 0}
    monkeypatch.setattr(graphs, "_REGISTERED", [(seen, "outer"),
                                                (seen, "inner")])
    work, acc, runs, _ = _nested(cuda, seen)
    g = graphs._Graphs([work], None, torch.device(cuda), "cannot be captured",
                       conditional=True)
    g()
    ref = (acc.clone(), runs.clone())
    g()  # the second warm-up, synchronizing operations raising
    assert seen == {"outer": 6, "inner": 42}
    g.capture()
    assert seen == {"outer": 6, "inner": 42}
    acc.zero_()
    runs.zero_()
    r0 = graphs._Graphs.replays
    g()
    assert graphs._Graphs.replays == r0 + 1
    assert g.cond.count.tolist()[:2] == [3, 21]
    g.flush()
    torch.cuda.synchronize()
    assert torch.equal(acc, ref[0]) and torch.equal(runs, ref[1])
    graphs._settle()
    assert seen == {"outer": 9, "inner": 63}
    g.close()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_cuda_tol_and_nan_stop_where_eager_stops(cuda, kind):
    """A tol that stops mid-fit, then a NaN target (every chunk runs): the
    loop on the card stops where the eager twin stops."""
    tol, _ = _stop_tol(kind)  # the CPU's eager decreases, MARGIN away
    for nan in (False, True):
        problem = _problem(kind, cuda, nan=nan)
        got = _card(kind, True, tol, 100, problem=problem)
        ref = _card(kind, False, tol, 100, problem=problem)
        _assert_twins(got[0], ref[0], kind, cuda)
        assert got[1] == ref[1] and got[2] == ref[2]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_cuda_one_entry_across_max_iter(cuda, kind):
    """100, 30 and 200 iterations on one target's entry: one capture, one
    replay a fit, each fit bit for bit its twin."""
    problem = _problem(kind, cuda)
    res = []
    for max_iter in (100, 30, 200):
        got = _card(kind, True, 0.0, max_iter, problem=problem)
        ref = _card(kind, False, 0.0, max_iter, problem=problem)
        _assert_twins(got[0], ref[0], kind, cuda)
        assert got[1] == ref[1] == _full(kind, max_iter)
        assert got[2] == ref[2]
        res.append(got[3:5])
    assert res == [(1, 1), (1, 0), (1, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", SINGLE)
def test_cuda_verbose_fit_reports_each_chunk(cuda, kind):
    """A verbose fit replays one chunk at a time and reads ``(k, stop)`` and
    its values after each: the eager twin's events."""
    got, ref = [], []
    problem = _problem(kind, cuda)
    for sink, graph in ((got, True), (ref, False)):
        solver.push_progress_handler(lambda *e, sink=sink: sink.append(e))
        try:
            res = _card(kind, graph, 0.0, 47, verbose=True, problem=problem)
        finally:
            solver.pop_progress_handler()
        if graph:
            # chunks 1-2 eager, then a replay a chunk for chunks 3-4
            assert res[3:5] == (2, 1)
    assert [e[0] for e in got] == [1, 2, 3, 4]
    if kind != "sparse-gather":
        assert got == ref

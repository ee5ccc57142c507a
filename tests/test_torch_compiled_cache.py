"""The compiled fits kept across fits (``ops/solver``'s cache): the
factories cached on their arguments as the JAX package's ``lru_cache``, and
one cache of entries, keyed by the target's identity (weakly held, its
address and version counter) and the chunk configuration (what the chunk
reads: not ``max_iter``), holding the chunk's graph, its static tensors
and what the fit derives from the target.

CPU tests (the "graph" is the direct call; the key, the statics and the
derived tensors are the same as on the card):

* a warm fit (a hit, from other inits), a cold fit and a fit on a new
  target of the same configuration (a warm miss) each equal the eager loop
  (``_graph=False``) bit for bit: dense NMF, NMFD, PLCA (generic and fused
  E-step), SIPLCA, the Hoyer fit, the batched MU, EM and Hoyer fits, the
  sparse fits at each tier and the sparse-target Hoyer fit;
* misses: a target changed in place (a stale ``Vn``, ``Vd``, ELL layout or
  padded copy would show), another β, ``tol``, ``l1_reg``, a frozen factor,
  another ``PNT_*`` switch; PLCA's priors are copied in, not keyed;
* sharing: fits that differ only in ``max_iter`` (or, where the chunk
  does not report, ``verbose``) share one entry, a factory's
  ``cache_clear`` included;
* lifetime: an entry goes with its target, past 8 entries in all or past
  a card's byte budget (the least recently used go first), and at
  ``compiled_cache_clear``, which leaves an entry a fit is running in
  another thread until that fit ends; the factories return one object for
  equal arguments; an out-of-memory error empties the cache, a fit that
  found an entry kept runs once more, and the sparse fit's retry runs on
  the ELL tier, graphed.

CUDA tests (marked ``cuda``; skipped without a card): exact replays and
captures (cold: one replay and one capture; warm: one replay, none; a new
target: one replay, one capture; the Hoyer fits a replay a chunk: cold
``chunks - 2``, warm and a new target ``chunks``), the warm
fits bit for bit the eager ones, an out-of-memory error inside a capture
leaving the allocated memory where it was, the held bytes freed by
``compiled_cache_clear``, a second configuration that fits on the card
only without the first one's entry run after it.
``python -m pytest --noconftest -m cuda tests/test_torch_compiled_cache.py``.
"""

import gc
import threading
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pytorch_nmf_tpu_torch.nmf import NMF, NMFD  # noqa: E402
from pytorch_nmf_tpu_torch.ops import (fast_nmfd, fast_plca, graphs, solver,  # noqa: E402
                                       sparse)
from pytorch_nmf_tpu_torch.plca import PLCA, SIPLCA  # noqa: E402
from pytorch_nmf_tpu_torch.utils import nmf_from_numpy  # noqa: E402


@pytest.fixture(autouse=True)
def fresh_cache():
    """One intra-op thread (these small fits run several times faster on
    it) and an empty cache before and after each test."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    solver.compiled_cache_clear()
    yield
    solver.compiled_cache_clear()
    torch.set_num_threads(threads)


def _counts():
    info = solver.compiled_cache_info()
    return {k: info[k] for k in ("hits", "warm_misses", "cold_misses")}


def _delta(before):
    now = _counts()
    return tuple(now[k] - before[k] for k in ("hits", "warm_misses",
                                              "cold_misses"))


def _arrays(shapes, seed, offs):
    rs = np.random.RandomState(seed)
    return [rs.rand(*s).astype("f") + o for s, o in zip(shapes, offs)]


# kind → (V shape, factor shapes); every array ``rand`` plus an offset
SHAPES = {
    "nmf": ((30, 20), ((20, 3), (30, 3))),
    "nmfd": ((1, 8, 40), ((8, 2, 4), (1, 2, 37))),
    "plca": ((30, 20), ((20, 3), (30, 3), (3,))),
    "siplca": ((1, 8, 40), ((8, 2, 4), (1, 2, 37), (2,))),
    "batched_nmf": ((3, 30, 20), ((3, 20, 3), (3, 30, 3))),
    "batched_plca": ((3, 30, 20), ((3, 20, 3), (3, 30, 3), (3, 3))),
}


class Case(SimpleNamespace):
    """``kind`` (its shapes, :data:`SHAPES`); ``fit(graph, device)`` builds
    the fit function; ``target(V)`` (optional) makes the target from a
    numpy V; ``run(fit, target, inits)`` calls it."""


def _dense_case(kind, factory_of, beta=1.0, max_iter=47):
    cls = NMF if kind == "nmf" else NMFD

    def fit(graph, device="cpu"):
        return solver.get_dense_fit(cls.reconstruct, beta, 0.0, max_iter,
                                    True, True, 0.0, 0.0, False,
                                    factory_of(device), _graph=graph)

    return Case(kind=kind, fit=fit, run=lambda f, V, x: f(V, *x))


def _plca_case(kind, engine=None, max_iter=47):
    def fit(graph, device="cpu"):
        recon3 = (PLCA.reconstruct if kind == "plca" else
                  fast_nmfd.resolve_plca_recon3(SIPLCA, device, torch.float32))
        return solver.get_plca_fit(recon3, 0.0, max_iter, True, True, True,
                                   False, True, False, em_engine=engine,
                                   _graph=graph)

    def run(f, V, x):
        one = V.new_ones(())
        return f(V, *x, one, one * 1.5, one)

    return Case(kind=kind, fit=fit, run=run)


def _hoyer_case(max_iter=30):
    W_dim, H_dim = SHAPES["nmf"][1][0][0], SHAPES["nmf"][1][1][0]

    def fit(graph, device="cpu"):
        return solver.get_hoyer_fit(NMF.reconstruct, None, 2.0, max_iter, True,
                                    True, 0.5, None, W_dim, H_dim,
                                    _graph=graph)

    return Case(kind="nmf", fit=fit, run=lambda f, V, x: f(V, *x))


def _batched_case(kind, max_iter=47):
    def fit(graph, device="cpu"):
        if kind == "batched_nmf":
            return solver.get_batched_dense_fit(NMF.reconstruct, 1.0, 0.0,
                                                max_iter, True, True, 0.0,
                                                0.0, _graph=graph)
        return solver.get_batched_plca_fit(PLCA.reconstruct, 0.0, max_iter,
                                           True, True, True, False, False,
                                           False, _graph=graph)

    def run(f, V, x):
        if kind == "batched_nmf":
            return f(V, *x)
        one = V.new_ones(())
        return f(V, *x, one, one, one)

    return Case(kind=kind, fit=fit, run=run)


def _batched_hoyer_case(max_iter=30):
    def fit(graph, device="cpu"):
        return solver.get_batched_hoyer_fit(
            NMF.reconstruct, 2.0, max_iter, True, True, 0.5, None, 20, 30,
            _graph=graph)

    return Case(kind="batched_nmf", fit=fit, run=lambda f, V, x: f(V, *x))


def _sparse_case(tier, beta=1.0, max_iter=47):
    def fit(graph, device="cpu"):
        factory = (NMF._resolve_updater_factory(
            torch.zeros(1, device=device), None, None, beta)
            if tier == "densify" else None)
        return solver.get_sparse_fit(NMF._sp_pos_neg, beta, 0.0, max_iter,
                                     True, True, 0.0, 0.0, False, tier,
                                     NMF.reconstruct, factory, _graph=graph)

    def target(V):
        Vs = sparse.sparse_from_dense(torch.from_numpy(
            np.where(V > 0.6, V, 0).astype("f")))
        return sparse.build_ell(Vs) if tier == "ell" else Vs

    return Case(kind="nmf", fit=fit, target=target,
                run=lambda f, V, x: f(V, *x))


def _sparse_hoyer_case(max_iter=30):
    def fit(graph, device="cpu"):
        return solver.get_hoyer_fit(None, NMF._sp_pos_neg, 2.0, max_iter,
                                    True, True, 0.5, None, 20, 30,
                                    _graph=graph)

    def target(V):
        return sparse.sparse_from_dense(torch.from_numpy(
            np.where(V > 0.6, V, 0).astype("f")))

    return Case(kind="nmf", fit=fit, target=target,
                run=lambda f, V, x: f(V, *x))


def _nmf_factory(device):
    return NMF._resolve_updater_factory(torch.zeros(1, device=device), None,
                                        None, 1.0)


def _nmfd_factory(device):
    return fast_nmfd.resolve_nmfd_updater_factory(device, torch.float32, 1)


CASES = {
    "nmf-b1": _dense_case("nmf", _nmf_factory),
    "nmf-b0.5": _dense_case("nmf", _nmf_factory, beta=0.5),
    "nmf-b2": _dense_case("nmf", _nmf_factory, beta=2.0),
    "nmfd": _dense_case("nmfd", _nmfd_factory),
    "nmfd-unfold": _dense_case(
        "nmfd", lambda d: fast_nmfd.deconv_updater_factory_unfold(1),
        beta=0.5),
    "plca": _plca_case("plca"),
    "plca-fused": _plca_case("plca", fast_plca.plca_em_engine_plain),
    "siplca": _plca_case("siplca"),
    "hoyer": _hoyer_case(),
    "batched-nmf": _batched_case("batched_nmf"),
    "batched-plca": _batched_case("batched_plca"),
    "batched-hoyer": _batched_hoyer_case(),
    "sparse-densify": _sparse_case("densify"),
    "sparse-ell": _sparse_case("ell", beta=1.5),
    "sparse-gather": _sparse_case("gather", beta=0.5),
    "sparse-hoyer": _sparse_hoyer_case(),
}


def _target(case, seed=0, device="cpu"):
    shape = SHAPES[case.kind][0]
    (V,) = _arrays([shape], seed, [0.01])
    if getattr(case, "target", None) is not None:
        return case.target(V)
    return torch.from_numpy(V).to(device)


def _inits(case, seed, device="cpu"):
    shapes = SHAPES[case.kind][1]
    return [torch.from_numpy(a).to(device)
            for a in _arrays(shapes, seed, [0.1] * len(shapes))]


def _same_target(V):
    """A new target of the same configuration and values."""
    if isinstance(V, sparse.SparseELL):
        return sparse.build_ell(_same_target(V.coo))
    if V.layout == torch.sparse_coo:
        return torch.sparse_coo_tensor(V.indices().clone(), V.values().clone(),
                                       V.shape, is_coalesced=True)
    return V.clone()


def _tensors(out):
    return [x for x in out if isinstance(x, torch.Tensor)]


def _assert_equal(a, b):
    assert [type(x) for x in a] == [type(x) for x in b]
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        else:
            assert x == y


@pytest.mark.parametrize("name", list(CASES))
def test_warm_fit_equals_cold_and_eager(name):
    case = CASES[name]
    fit, eager = case.fit(True), case.fit(False)
    assert case.fit(True) is fit  # the factory's cache
    V = _target(case)
    A, B = _inits(case, 1), _inits(case, 2)
    c0 = _counts()
    cold = case.run(fit, V, A)
    assert _delta(c0) == (0, 0, 1)
    warm = case.run(fit, V, B)
    assert _delta(c0) == (1, 0, 1)
    new = case.run(fit, _same_target(V), A)
    assert _delta(c0) == (1, 1, 1)
    again = case.run(fit, V, A)  # the first entry is kept
    assert _delta(c0) == (2, 1, 1)
    ref_A, ref_B = case.run(eager, V, A), case.run(eager, V, B)
    _assert_equal(cold, ref_A)
    _assert_equal(warm, ref_B)
    _assert_equal(new, ref_A)
    _assert_equal(again, ref_A)
    # the outputs are the caller's: the next fit does not write them
    assert all(t.data_ptr() not in {u.data_ptr() for u in _tensors(warm)}
               for t in _tensors(again))


def _model_fit(V, W0, H0, **kw):
    m = nmf_from_numpy({"W": W0, "H": H0}, "cpu",
                       trainable_W=kw.pop("trainable_W", True))
    n = m.fit(V, **kw)
    return n, m.W.detach().clone(), m.H.detach().clone()


def _mutate(V):
    """Changes the target's values in place (its version counter moves)."""
    with torch.no_grad():
        if V.layout == torch.sparse_coo:
            V.values().mul_(1.5)
        else:
            V.mul_(1.5)


@pytest.mark.parametrize("name", ["nmf-b1", "nmfd", "plca", "plca-fused",
                                  "siplca", "batched-nmf", "batched-plca",
                                  "sparse-densify", "sparse-gather",
                                  "sparse-hoyer", "hoyer"])
def test_target_changed_in_place_misses(name):
    """A stale derived tensor (PLCA's ``Vn``, the densified target, a padded
    copy) or a stale replay would give the old target's factors."""
    case = CASES[name]
    fit, eager = case.fit(True), case.fit(False)
    V = _target(case)
    A = _inits(case, 1)
    first = case.run(fit, V, A)
    _mutate(V)
    c0 = _counts()
    got = case.run(fit, V, A)
    assert _delta(c0) == (0, 1, 0)  # not a hit: a new entry, seen before
    _assert_equal(got, case.run(eager, V, A))
    assert not torch.equal(_tensors(got)[0], _tensors(first)[0])


@pytest.mark.parametrize("tier", ["densify", "ell", "gather"])
def test_sparse_target_changed_in_place_misses_through_the_model(
        monkeypatch, tier):
    """Through ``NMF.fit``: the ELL layout cached on the target is laid out
    again, and the densify tier's dense copy made again."""
    monkeypatch.setenv("PNT_SPARSE_DENSIFY", "1" if tier == "densify" else "0")
    monkeypatch.setenv("PNT_SPARSE_ELL", "1" if tier == "ell" else "0")
    V, W0, H0 = _arrays(((30, 20), (20, 3), (30, 3)), 3, (0.01, 0.1, 0.1))
    Vs = sparse.sparse_from_dense(np.where(V > 0.6, V, 0).astype("f"))
    first = _model_fit(Vs, W0, H0, beta=1, tol=0, max_iter=30)
    again = _model_fit(Vs, W0, H0, beta=1, tol=0, max_iter=30)
    _assert_equal(first, again)
    _mutate(Vs)
    got = _model_fit(Vs, W0, H0, beta=1, tol=0, max_iter=30)
    fresh = sparse.sparse_from_dense(np.where(V > 0.6, V, 0).astype("f") * 1.5)
    solver.compiled_cache_clear()
    _assert_equal(got, _model_fit(fresh, W0, H0, beta=1, tol=0, max_iter=30))


@pytest.mark.parametrize("change", ["beta", "tol", "l1_reg", "frozen_W",
                                    "env"])
def test_configuration_changes_miss(monkeypatch, change):
    V, W0, H0 = _arrays(((30, 20), (20, 3), (30, 3)), 4, (0.01, 0.1, 0.1))
    V = torch.from_numpy(V)
    base = dict(beta=1, tol=1e-6, max_iter=30)
    _model_fit(V, W0, H0, **base)
    kw = dict(base)
    if change == "beta":
        kw["beta"] = 0.5
    elif change == "tol":
        kw["tol"] = 1e-3
    elif change == "l1_reg":
        kw.update(alpha=0.1, l1_ratio=1.0)
    elif change == "frozen_W":
        kw["trainable_W"] = False
    else:  # a switch some fit reads: in the key of every fit
        monkeypatch.setenv("PNT_NMFD_UNFOLD_MAX_BYTES", "1")
    c0 = _counts()
    got = _model_fit(V, W0, H0, **kw)
    hits, warm, cold = _delta(c0)
    assert hits == 0 and warm + cold == 1
    solver.compiled_cache_clear()
    _assert_equal(got, _model_fit(V.clone(), W0, H0, **kw))


def test_an_environment_switch_reaches_the_updaters(monkeypatch):
    """The unfold engine picks its mode from ``PNT_NMFD_UNFOLD_MAX_BYTES``
    once an entry: a switch that changes it is a miss, whose fit is the
    eager fit under the switch."""
    case = CASES["nmfd-unfold"]
    fit, eager = case.fit(True), case.fit(False)
    V, A = _target(case), _inits(case, 1)
    case.run(fit, V, A)
    monkeypatch.setenv("PNT_NMFD_UNFOLD_MAX_BYTES", "1")  # mode "none"
    c0 = _counts()
    got = case.run(fit, V, A)
    assert _delta(c0)[0] == 0
    _assert_equal(got, case.run(eager, V, A))


def test_priors_are_copied_in():
    """PLCA's priors are statics of the entry: another value is a hit."""
    fit = solver.get_plca_fit(PLCA.reconstruct, 0.0, 30, True, True, True,
                              False, True, False)
    eager = solver.get_plca_fit(PLCA.reconstruct, 0.0, 30, True, True, True,
                                False, True, False, _graph=False)
    case = CASES["plca"]
    V, A = _target(case), _inits(case, 1)
    one = V.new_ones(())
    for h_alpha in (1.5, 2.5, 1.2):
        c0 = _counts()
        got = fit(V, *A, one, one * h_alpha, one)
        _assert_equal(got, eager(V, *A, one, one * h_alpha, one))
    assert _delta(c0) == (1, 0, 0)


def test_configurations_on_one_target_keep_their_entries():
    """Two configurations on one target each keep their entry (hits both
    ways), and both go when the target changes in place."""
    case = CASES["nmf-b1"]
    V, A = _target(case), _inits(case, 1)
    fits = [solver.get_dense_fit(NMF.reconstruct, 1.0, tol, 30, True, True,
                                 0.0, 0.0, False, _nmf_factory("cpu"))
            for tol in (0.0, -1.0)]
    for fit in fits:
        case.run(fit, V, A)
    c0 = _counts()
    for fit in fits:
        case.run(fit, V, A)
    assert _delta(c0) == (2, 0, 0)
    assert solver.compiled_cache_info()["entries"] == 2
    _mutate(V)
    case.run(fits[0], V, A)
    assert _delta(c0) == (2, 1, 0)
    assert solver.compiled_cache_info()["entries"] == 1


@pytest.mark.parametrize("name", ["nmf-b1", "plca", "sparse-gather",
                                  "sparse-ell", "hoyer", "batched-nmf"])
def test_entries_go_with_their_target(name):
    case = CASES[name]
    fit = case.fit(True)
    V = _target(case)
    case.run(fit, V, _inits(case, 1))
    info = solver.compiled_cache_info()
    assert info["entries"] == 1 and info["held_bytes"] > 0
    del V
    gc.collect()  # an ELL layout and its target refer to each other
    assert solver.compiled_cache_info()["entries"] == 0


def test_nothing_outlives_a_kept_fit():
    """The entry holds its target weakly, and the fit's factors not at
    all."""
    import weakref

    case = CASES["nmf-b1"]
    V, A = _target(case), _inits(case, 1)
    dead = [weakref.ref(x) for x in [V] + A]
    out = case.run(case.fit(True), V, A)
    del V, A, out
    assert all(d() is None for d in dead)


def test_the_cache_holds_eight_entries():
    case = CASES["nmf-b1"]
    fit = case.fit(True)
    A = _inits(case, 1)
    targets = [_target(case, seed) for seed in range(10)]
    for V in targets:
        case.run(fit, V, A)
    assert solver.compiled_cache_info()["entries"] == solver._MAX_ENTRIES == 8
    c0 = _counts()
    case.run(fit, targets[-1], A)  # the newest: kept
    case.run(fit, targets[0], A)  # the oldest: gone (and 2 goes now)
    assert _delta(c0) == (1, 1, 0)
    case.run(fit, targets[3], A)  # kept
    case.run(fit, targets[2], A)  # gone
    assert _delta(c0) == (2, 2, 0)


def test_fit_functions_share_the_eight_entries():
    """The bound is the cache's, not a fit function's: a PLCA fit takes the
    least recently used dense entry's place."""
    case, plca = CASES["nmf-b1"], CASES["plca"]
    fit, A = case.fit(True), _inits(case, 1)
    targets = [_target(case, seed) for seed in range(8)]
    for V in targets:
        case.run(fit, V, A)
    Vp = _target(plca)
    plca.run(plca.fit(True), Vp, _inits(plca, 1))
    assert solver.compiled_cache_info()["entries"] == 8
    c0 = _counts()
    case.run(fit, targets[1], A)  # kept
    case.run(fit, targets[0], A)  # gone
    assert _delta(c0) == (1, 1, 0)


def test_the_held_bytes_have_a_budget(monkeypatch):
    """Past the device's byte budget the least recently used entries go."""
    case = CASES["nmf-b1"]
    fit, A = case.fit(True), _inits(case, 1)
    targets = [_target(case, seed) for seed in range(3)]
    case.run(fit, targets[0], A)
    one = solver.compiled_cache_info()["held_bytes"]
    monkeypatch.setattr(solver, "_held_budget", lambda device: 2 * one)
    for V in targets[1:]:
        case.run(fit, V, A)
    info = solver.compiled_cache_info()
    assert info["entries"] == 2 and info["held_bytes"] == 2 * one
    c0 = _counts()
    case.run(fit, targets[2], A)  # kept
    case.run(fit, targets[0], A)  # gone (and 1 goes now)
    case.run(fit, targets[1], A)
    assert _delta(c0) == (1, 2, 0)


@pytest.mark.parametrize("kind", ["dense", "plca", "hoyer"])
def test_fits_that_differ_in_max_iter_share_an_entry(kind):
    """What the chunk reads keys the entry: fits of 47, 30 and 52
    iterations share one, a verbose fit too where the chunk reads nothing
    more to report (the dense fit reports the loss the chunk keeps);
    PLCA's and the Hoyer fit's reporting chunks compute more, a miss."""
    case = CASES[{"dense": "nmf-b1", "plca": "plca", "hoyer": "hoyer"}[kind]]
    V, A = _target(case), _inits(case, 1)

    def make(max_iter, verbose, graph):
        if kind == "dense":
            return solver.get_dense_fit(NMF.reconstruct, 1.0, 0.0, max_iter,
                                        True, True, 0.0, 0.0, verbose,
                                        _nmf_factory("cpu"), _graph=graph)
        if kind == "plca":
            return solver.get_plca_fit(PLCA.reconstruct, 0.0, max_iter, True,
                                       True, True, False, True, False,
                                       verbose, _graph=graph)
        return solver.get_hoyer_fit(NMF.reconstruct, None, 2.0, max_iter,
                                    True, True, 0.5, None, 20, 30, verbose,
                                    _graph=graph)

    c0 = _counts()
    for max_iter in (47, 30, 52):
        got = case.run(make(max_iter, False, True), V, A)
        _assert_equal(got, case.run(make(max_iter, False, False), V, A))
    assert _delta(c0) == (2, 0, 1)
    solver.push_progress_handler(lambda *a: None)
    try:
        got = case.run(make(30, True, True), V, A)
        _assert_equal(got, case.run(make(30, True, False), V, A))
    finally:
        solver.pop_progress_handler()
    assert _delta(c0) == ((3, 0, 1) if kind == "dense" else (2, 0, 2))


def test_cache_clear_empties():
    case = CASES["nmf-b1"]
    fit = case.fit(True)
    V = _target(case)
    case.run(fit, V, _inits(case, 1))
    plca = CASES["plca"]
    Vp = _target(plca)
    plca.run(plca.fit(True), Vp, _inits(plca, 1))
    assert solver.compiled_cache_info()["entries"] == 2
    solver.get_dense_fit.cache_clear()  # this factory's fit functions only
    assert solver.compiled_cache_info()["entries"] == 2
    assert case.fit(True) is not fit
    assert solver.get_dense_fit.cache_info().currsize == 1
    c0 = _counts()  # the new fit function's chunk is the kept one
    case.run(case.fit(True), V, _inits(case, 2))
    assert _delta(c0) == (1, 0, 0)
    solver.compiled_cache_clear()
    info = solver.compiled_cache_info()
    assert info["entries"] == 0 and info["held_bytes"] == 0
    c0 = _counts()
    case.run(case.fit(True), V, _inits(case, 1))
    assert _delta(c0) == (0, 0, 1)  # nothing is remembered


FACTORY_ARGS = {
    "get_dense_fit": (NMF.reconstruct, 1.0, 1e-4, 30, True, True, 0.0, 0.0),
    "get_batched_dense_fit": (NMF.reconstruct, 1.0, 1e-4, 30, True, True,
                              0.0, 0.0),
    "get_sparse_fit": (NMF._sp_pos_neg, 1.0, 1e-4, 30, True, True, 0.0, 0.0),
    "get_hoyer_fit": (NMF.reconstruct, None, 2.0, 30, True, True, 0.5, None,
                      20, 30),
    "get_batched_hoyer_fit": (NMF.reconstruct, 2.0, 30, True, True, 0.5, None,
                              20, 30),
    "get_plca_fit": (PLCA.reconstruct, 1e-4, 30, True, True, True, False,
                     False, False),
    "get_batched_plca_fit": (PLCA.reconstruct, 1e-4, 30, True, True, True,
                             False, False, False),
}


@pytest.mark.parametrize("factory", list(FACTORY_ARGS))
def test_factories_return_one_object_for_equal_arguments(factory):
    make = getattr(solver, factory)
    args = FACTORY_ARGS[factory]
    first = make(*args)
    hits = make.cache_info().hits
    assert make(*args) is first and make.cache_info().hits == hits + 1
    other = list(args)
    other[3 if factory in ("get_dense_fit", "get_batched_dense_fit",
                           "get_sparse_fit", "get_hoyer_fit") else 2] = 40
    assert make(*other) is not first


def test_model_resolvers_keep_the_factory_key():
    """The models' resolvers return one object a decision, and the batched
    functional fits one vmapped reconstruction a model: a fit through the
    models twice is one factory, one entry."""
    from pytorch_nmf_tpu_torch import functional as F
    from pytorch_nmf_tpu_torch.ops import autotune

    V = torch.rand(1, 6, 30) + 0.01
    W, H = torch.rand(6, 2, 4) + 0.1, torch.rand(1, 2, 27) + 0.1
    assert autotune.resolve_deconv_factory(V, W, H, 1.0, 1, NMFD.reconstruct) \
        is autotune.resolve_deconv_factory(V, W, H, 1.0, 1, NMFD.reconstruct)
    assert SIPLCA._resolve_fit_recon3(V, W, H, torch.ones(2)) is \
        SIPLCA._resolve_fit_recon3(V, W, H, torch.ones(2))
    assert F._batched_recon(NMFD.reconstruct) is F._batched_recon(
        NMFD.reconstruct)
    Vb, Wb, Hb = V[None].repeat(2, 1, 1, 1), W[None].repeat(2, 1, 1, 1), \
        H[None].repeat(2, 1, 1, 1)
    c0 = _counts()
    for _ in range(2):
        F.nmf_fit_batched(Vb, Wb, Hb, beta=1, tol=0, max_iter=20,
                          model_cls=NMFD)
    m = NMFD(W=W, H=H, device="cpu")
    for _ in range(2):
        m.fit(V, beta=1, tol=0, max_iter=20)
    assert _delta(c0) == (2, 0, 2)


@pytest.mark.parametrize("how", ["retried", "fails twice", "nothing kept",
                                 "host memory"])
def test_out_of_memory_empties_the_cache(monkeypatch, how):
    """An out-of-memory error in a graphed fit (here raised by an updater
    in chunk 2) empties the cache.  When that freed an entry kept from an
    earlier fit on the fit's card (the CPU standing for one here), the fit
    runs once more from its inputs (equal to the eager fit); the error
    propagates when that run fails too, when nothing was kept, or when
    the entries freed held host memory."""
    if how != "host memory":
        monkeypatch.setattr(solver, "_gives_back", lambda device: True)
    keep = CASES["plca"]
    Vp = _target(keep)
    if how != "nothing kept":
        keep.run(keep.fit(True), Vp, _inits(keep, 1))
    calls = []

    def factory(beta, gamma, l1_reg, l2_reg):
        upd_W, upd_H = solver._default_updaters(NMF.reconstruct, beta, gamma,
                                                l1_reg, l2_reg)

        def failing(V, W, H):
            calls.append(1)
            if len(calls) == 15 or (how == "fails twice" and len(calls) > 15):
                raise torch.cuda.OutOfMemoryError("out of memory")
            return upd_W(V, W, H)

        return failing, upd_H

    fit = solver.get_dense_fit(NMF.reconstruct, 1.0, 0.0, 30, True, True, 0.0,
                               0.0, False, factory)
    case = CASES["nmf-b1"]
    V, A = _target(case), _inits(case, 1)
    c0 = _counts()
    if how == "retried":
        got = fit(V, *A)
        assert len(calls) == 15 + 30 and _delta(c0) == (0, 0, 2)
        _assert_equal(got, solver.get_dense_fit(
            NMF.reconstruct, 1.0, 0.0, 30, True, True, 0.0, 0.0, False,
            factory, _graph=False)(V, *A))
        assert solver.compiled_cache_info()["entries"] == 1
    else:
        with pytest.raises(torch.cuda.OutOfMemoryError):
            fit(V, *A)
        assert _delta(c0) == (0, 0, 2 if how == "fails twice" else 1)
        assert len(calls) == (16 if how == "fails twice" else 15)
        assert solver.compiled_cache_info()["entries"] == 0
    if how != "nothing kept":
        c0 = _counts()
        keep.run(keep.fit(True), Vp, _inits(keep, 1))
        assert _delta(c0) == (0, 1, 0)  # compiled before: a warm miss


@pytest.mark.parametrize("beta", [1.0, 1.5])
def test_densify_out_of_memory_in_a_chunk_retries_on_ell(monkeypatch, beta):
    """The densify tier runs out of memory in its chunk (on the card: in
    the capture); ``NMF.fit`` runs once more on the ELL tier, graphed, with
    that tier's result, and no densify entry is left."""
    V, W0, H0 = _arrays(((30, 20), (20, 3), (30, 3)), 5, (0.01, 0.1, 0.1))
    V = np.where(V > 0.6, V, 0).astype("f")
    monkeypatch.setenv("PNT_SPARSE_DENSIFY", "0")
    want = _model_fit(sparse.sparse_from_dense(V), W0, H0, beta=beta, tol=0,
                      max_iter=30)
    solver.compiled_cache_clear()
    monkeypatch.setenv("PNT_SPARSE_DENSIFY", "1")
    from pytorch_nmf_tpu_torch.ops import fast_nmf

    plain = fast_nmf.nmf_updater_factory_plain
    calls = []

    def factory(beta, gamma, l1_reg, l2_reg):
        upd_W, upd_H, loss = plain(beta, gamma, l1_reg, l2_reg)

        def failing(V, W, H):
            calls.append(1)
            if len(calls) == 15:
                raise torch.cuda.OutOfMemoryError("out of memory")
            return upd_W(V, W, H)

        return failing, upd_H, loss

    monkeypatch.setattr(NMF, "_resolve_updater_factory",
                        classmethod(lambda cls, V, W, H, b: factory))
    c0 = graphs._Graphs.replays
    got = _model_fit(sparse.sparse_from_dense(V), W0, H0, beta=beta, tol=0,
                     max_iter=30)
    assert len(calls) == 15 and graphs._Graphs.replays == c0
    _assert_equal(got, want)
    assert solver.compiled_cache_info()["entries"] == 1  # the ELL fit's


def test_checkpointed_fit_compiles_once(tmp_path):
    """``checkpointed_fit`` runs its segments through one fit function on
    one target: one miss, then a hit a segment."""
    from pytorch_nmf_tpu_torch.utils.checkpoint import checkpointed_fit

    V, W0, H0 = _arrays(((30, 20), (20, 3), (30, 3)), 6, (0.01, 0.1, 0.1))
    m = nmf_from_numpy({"W": W0, "H": H0}, "cpu")
    c0 = _counts()
    assert checkpointed_fit(m, V, beta=1, tol=float("-inf"), max_iter=80,
                            every=20, directory=str(tmp_path)) == 80
    assert _delta(c0) == (3, 0, 1)
    ref = nmf_from_numpy({"W": W0, "H": H0}, "cpu")
    ref.fit(torch.from_numpy(V), beta=1, tol=float("-inf"), max_iter=80)
    assert torch.allclose(m.W, ref.W, rtol=1e-5, atol=0)


def test_verbose_warm_fit_reports_as_eager():
    case = CASES["plca"]
    V, A = _target(case), _inits(case, 1)
    one = V.new_ones(())
    runs = []
    for graph in (True, True, False):
        calls = []
        solver.push_progress_handler(lambda *a: calls.append(a))
        try:
            solver.get_plca_fit(PLCA.reconstruct, 0.0, 30, True, True, True,
                                False, False, False, True,
                                _graph=graph)(V, *A, one, one, one)
        finally:
            solver.pop_progress_handler()
        runs.append(calls)
    assert runs[0] == runs[1] == runs[2] and len(runs[0]) == 3


def test_concurrent_fits_of_one_entry():
    """A fit of an entry busy in another thread runs on a fresh one."""
    case = CASES["nmf-b1"]
    fit = case.fit(True)
    V, A = _target(case), _inits(case, 1)
    want = case.run(case.fit(False), V, A)
    outs, errors = [], []

    def work():
        try:
            for _ in range(3):
                outs.append(case.run(fit, V, A))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=work) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(outs) == 9
    for out in outs:
        _assert_equal(out, want)


@pytest.mark.parametrize("how", ["compiled_cache_clear", "out of memory"])
def test_a_clear_leaves_an_entry_a_fit_is_running(how):
    """A fit runs in one thread (held in chunk 2) while another thread
    clears the cache, or runs out of memory in a fit of its own: the
    running entry is taken out at once and closed only when its fit ends,
    which ends as the eager fit."""
    started, go, calls = threading.Event(), threading.Event(), []

    def factory(beta, gamma, l1_reg, l2_reg):
        upd_W, upd_H = solver._default_updaters(NMF.reconstruct, beta, gamma,
                                                l1_reg, l2_reg)

        def held(V, W, H):
            calls.append(1)
            if len(calls) == 15:
                started.set()
                assert go.wait(60)
            return upd_W(V, W, H)

        return held, upd_H

    def failing(beta, gamma, l1_reg, l2_reg):
        def oom(V, W, H):
            raise torch.cuda.OutOfMemoryError("out of memory")

        return oom, oom

    args = (NMF.reconstruct, 1.0, 0.0, 47, True, True, 0.0, 0.0, False)
    fit = solver.get_dense_fit(*args, factory)
    case = CASES["nmf-b1"]
    V, A = _target(case), _inits(case, 1)
    outs, errors = [], []

    def work():
        try:
            outs.append(fit(V, *A))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    t = threading.Thread(target=work)
    t.start()
    try:
        assert started.wait(60)
        if how == "compiled_cache_clear":
            solver.compiled_cache_clear()
        else:
            with pytest.raises(torch.cuda.OutOfMemoryError):
                solver.get_dense_fit(*args, failing)(_target(case, 1), *A)
        assert solver.compiled_cache_info()["entries"] == 0
    finally:
        go.set()
        t.join()
    assert not errors and solver.compiled_cache_info()["entries"] == 0
    _assert_equal(outs[0], solver.get_dense_fit(*args, factory,
                                                _graph=False)(V, *A))


def test_fits_and_clears_in_many_threads():
    """Eight threads fit two targets while a ninth clears the cache, with a
    short switch interval: every fit ends as the eager one, nothing
    raises, and the cache ends within its bound."""
    import sys

    case = CASES["nmf-b1"]
    fit, eager = case.fit(True), case.fit(False)
    targets = [_target(case, seed) for seed in range(2)]
    A = _inits(case, 1)
    want = [case.run(eager, V, A) for V in targets]
    errors, bad, stop = [], [], threading.Event()

    def work(i):
        try:
            for j in range(4):
                k = (i + j) % 2
                if not all(torch.equal(a, b) for a, b in zip(
                        _tensors(case.run(fit, targets[k], A)),
                        _tensors(want[k]))):
                    bad.append((i, j))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    def clearing():
        while not stop.is_set():
            solver.compiled_cache_clear()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
        cleaner = threading.Thread(target=clearing)
        cleaner.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        stop.set()
        cleaner.join(120)
    finally:
        stop.set()
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads + [cleaner])
    assert not errors and not bad
    assert solver.compiled_cache_info()["entries"] <= solver._MAX_ENTRIES


def test_cache_clear_frees_at_once():
    """``compiled_cache_clear`` frees the entries' tensors at once, with no
    garbage collection (nothing, ``compiled_cache_info`` included, leaves a
    reference cycle holding them)."""
    import weakref

    case = CASES["plca"]
    V, A = _target(case), _inits(case, 1)
    case.run(case.fit(True), V, A)
    (entry,) = list(solver._CACHE.entries.values())
    kept = [weakref.ref(t) for t in entry.tensors()]
    del entry
    # W, H, Z, loss_init, prev, stop, go, (k, stop) and its view k, limit;
    # Vn, norm and the three priors
    assert len(kept) == 15
    gc.disable()
    try:
        assert solver.compiled_cache_info()["held_bytes"] > 0
        solver.compiled_cache_clear()
        assert [r() for r in kept] == [None] * len(kept)
    finally:
        gc.enable()


def test_held_bytes_count_the_statics_and_the_derived():
    case = CASES["plca"]
    V, A = _target(case), _inits(case, 1)
    case.run(case.fit(True), V, A)
    held = solver.compiled_cache_info()["held_bytes"]
    # W, H, Z; loss_init and prev; Vn, norm and the three priors; the stop
    # flag and the loop's flag (one byte each), (k, stop) for the fit's one
    # read (two int64) and the loop's limit (one int64)
    want = sum(x.numel() * 4 for x in A) + V.numel() * 4 + 4 * (2 + 1 + 3)
    assert held == want + 1 + 1 + 16 + 8


def test_held_bytes_count_what_the_updaters_keep():
    """A copy of V an entry's updaters keep (on the card: the fused
    updaters' padded copy) counts in the held bytes."""
    case = CASES["nmf-b1"]
    V, A = _target(case), _inits(case, 1)

    def keeping(beta, gamma, l1_reg, l2_reg):
        upd_W, upd_H = solver._default_updaters(NMF.reconstruct, beta, gamma,
                                                l1_reg, l2_reg)
        kept = []

        def upd(V, W, H):
            if not kept:
                kept.append(V.clone())
            return upd_W(kept[0], W, H)

        return upd, upd_H

    held = []
    for factory in (None, keeping):
        solver.compiled_cache_clear()
        solver.get_dense_fit(NMF.reconstruct, 1.0, 0.0, 30, True, True, 0.0,
                             0.0, False, factory)(V, *A)
        held.append(solver.compiled_cache_info()["held_bytes"])
    assert held[1] - held[0] == V.numel() * V.element_size()


# ---------------------------------------------------------------- CUDA
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    solver.compiled_cache_clear()
    return "cuda"


CARD_CASES = ["nmf-b1", "nmf-b0.5", "nmfd", "plca", "siplca", "hoyer",
              "batched-nmf", "batched-plca", "batched-hoyer", "sparse-densify",
              "sparse-ell", "sparse-gather", "sparse-hoyer"]


def _card(case, x, device):
    if isinstance(x, sparse.SparseELL):
        return sparse.build_ell(x.coo.to(device))
    return x.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CARD_CASES)
def test_cuda_cold_warm_and_new_target_counts(cuda, name):
    case = CASES[name]
    fit, eager = case.fit(True, cuda), case.fit(False, cuda)
    V = _card(case, _target(case), cuda)
    A, B = _inits(case, 1, cuda), _inits(case, 2, cuda)
    chunks = 3 if "hoyer" in name else 4
    res = []
    for V_, x in ((V, A), (V, B), (_same_target(V), A)):
        r0, k0 = graphs._Graphs.replays, graphs._Graphs.captures
        out = case.run(fit, V_, x)
        torch.cuda.synchronize()
        res.append((out, graphs._Graphs.replays - r0,
                    graphs._Graphs.captures - k0))
    # the Hoyer fits replay a chunk at a time; the others' chunk loop is
    # one replay (chunks 3-4 cold)
    per = chunks if "hoyer" in name else 1
    assert [(r, k) for _, r, k in res] == [(per - 2 * ("hoyer" in name), 1),
                                           (per, 0), (per, 1)]
    refs = [case.run(eager, V, A), case.run(eager, V, B)]
    gather = name == "sparse-gather"  # scatter-adds by atomics
    for (out, _, _), ref in zip(res, refs + refs[:1]):
        if gather:
            for a, b in zip(_tensors(out), _tensors(ref)):
                assert float((a - b).abs().max() / b.abs().max()) <= 1e-4
        else:
            _assert_equal(out, ref)


@pytest.mark.cuda
def test_cuda_out_of_memory_in_a_capture_leaves_memory(cuda):
    """An updater that allocates past the card inside the capture only: the
    capture ends, its graph and pool go, the cache is emptied, and the
    card's allocated memory is where it was before the fit."""
    case = CASES["nmf-b1"]
    V, A = _card(case, _target(case), cuda), _inits(case, 1, cuda)
    case.run(case.fit(True, cuda), V, A)  # builds, workspaces
    solver.compiled_cache_clear()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()

    def factory(beta, gamma, l1_reg, l2_reg):
        upd_W, upd_H = solver._default_updaters(NMF.reconstruct, beta, gamma,
                                                l1_reg, l2_reg)

        def greedy(V, W, H):
            if torch.cuda.is_current_stream_capturing():
                torch.empty(1 << 46, device=V.device)  # 256 TiB
            return upd_W(V, W, H)

        return greedy, upd_H

    fit = solver.get_dense_fit(NMF.reconstruct, 1.0, 0.0, 40, True, True, 0.0,
                               0.0, False, factory)
    raised = False
    try:
        fit(V, *A)
    except torch.cuda.OutOfMemoryError:
        raised = True
    assert raised
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == before
    assert solver.compiled_cache_info()["entries"] == 0
    # the fit function still works: its next fit captures afresh
    out = case.run(case.fit(True, cuda), V, A)
    assert _tensors(out)[0].is_cuda


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["nmf-b1", "plca", "hoyer", "sparse-ell"])
def test_cuda_cache_clear_frees_the_held_bytes(cuda, name):
    case = CASES[name]
    V = _card(case, _target(case), cuda)
    A = _inits(case, 1, cuda)
    fit = case.fit(True, cuda)
    case.run(fit, V, A)
    solver.compiled_cache_clear()
    fit = case.fit(True, cuda)
    # cuBLAS keeps a workspace for each stream that ran a product eagerly
    # (a hit's initial loss): not the cache's; dropped before each reading
    clear_workspaces = torch._C._cuda_clearCublasWorkspaces
    torch.cuda.synchronize()
    clear_workspaces()
    torch.cuda.empty_cache()
    allocated, reserved = torch.cuda.memory_allocated(), \
        torch.cuda.memory_reserved()
    case.run(fit, V, A)
    case.run(fit, V, A)
    torch.cuda.synchronize()
    clear_workspaces()
    held = solver.compiled_cache_info()["held_bytes"]
    assert held > 0 and torch.cuda.memory_allocated() > allocated
    solver.compiled_cache_clear()
    torch.cuda.synchronize()
    clear_workspaces()
    assert torch.cuda.memory_allocated() == allocated
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved() == reserved


@pytest.mark.cuda
def test_cuda_a_second_configuration_beside_a_held_entry(cuda):
    """After a fit on a target on the card, a fit of a second configuration
    (another ``tol``) given only the memory it needs without the first
    entry's held bytes (the process's memory fraction) runs out of memory,
    empties the cache and runs once more, as its eager fit."""
    M, K, R = 8192, 2049, 32  # rows padded: each entry holds a copy of V
    g = torch.Generator().manual_seed(0)
    V = (torch.rand(M, K, generator=g) + 0.01).to(cuda)
    W0 = (torch.rand(K, R, generator=g) + 0.1).to(cuda)
    H0 = (torch.rand(M, R, generator=g) + 0.1).to(cuda)
    factory = NMF._resolve_updater_factory(V, W0, H0, 1.0)

    def make(tol, graph=True):
        return solver.get_dense_fit(NMF.reconstruct, 1.0, tol, 30, True, True,
                                    0.0, 0.0, False, factory, _graph=graph)

    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    r0 = torch.cuda.memory_reserved()
    make(float("-inf"))(V, W0, H0)
    torch.cuda.synchronize()
    need = torch.cuda.max_memory_reserved() - r0
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    held = solver.compiled_cache_info()["held_bytes"]
    assert held >= M * (K + 3) * 4
    limit = torch.cuda.memory_reserved() + need - held // 2
    total = torch.cuda.get_device_properties(0).total_memory
    c0 = _counts()
    torch.cuda.set_per_process_memory_fraction(limit / total)
    try:
        got = make(-1.0)(V, W0, H0)
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
    assert _delta(c0) == (0, 0, 2)  # out of memory, then once more
    assert solver.compiled_cache_info()["entries"] == 1
    _assert_equal(got, make(-1.0, False)(V, W0, H0))

"""The sharded NMF, PLCA and sparse fits compiled once per configuration
(``parallel/sharded.py``, ``parallel/sharded_sparse.py``: their chunk loop
on the fits' cache of ``ops/solver.py``), against their eager twins
(``_graph=False``, ``_converging_loop``) bit for bit and the JAX package's
jitted shard_map fits; and C9, a DTensor input cut a second time.

The port runs in 4 gloo rank processes on the CPU (``_torch_parallel_child``,
one group for the file, started once by a module-scoped fixture, with its
timeout: a hang fails the group, not the suite): 2 ranks on a ``data``
mesh, all 4 on a 2×2 ``data``×``model`` mesh (and the halo fits on a 2-rank
``seq`` mesh).  On the CPU the chunk loop runs eagerly through the same
workload the card captures, reading its flag before each chunk.  The JAX
side runs here on a sub-mesh of the 8 virtual CPU devices.  Tolerance:
1e-5 relative to the factor's largest entry, with the same ``n_iter``.

Each configuration runs at ``max_iter`` 0, 5, 10 and 47 (``tol=0``) and
at a ``tol`` that stops it at chunk 3 (``stop``: between the relative
decreases of chunks 2 and 3, from the port's single-card fit of the same
problem).  The flows (``compiled`` cases) hold a fit on ``shard_target``
DTensors made once (a cache hit the second time), a write through
``.data`` (C8's rule: the hit reads the new values), one rank's cache
cleared alone (the ranks agree on the path: both run the cold fit), and
the process group destroyed and started again.  The CUDA test runs one
NCCL rank on the card.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from _torch_parallel_child import run_group  # noqa: E402

RTOL = 1e-5
ITERS = (0, 5, 10, 47, "stop")
STOP_CHUNK = 3


def _nmf_problem(seed, M=40, K=24, R=4):
    rs = np.random.RandomState(seed)
    return {"V": rs.rand(M, K).astype("f") + 0.01,
            "W": rs.rand(K, R).astype("f") + 0.1,
            "H": rs.rand(M, R).astype("f") + 0.1}


def _plca_problem(seed, M=40, K=24, R=4):
    """A normalized PLCA start (the model constructor's normalization)."""
    rs = np.random.RandomState(seed)
    W = rs.rand(K, R).astype("f") + 0.1
    H = rs.rand(M, R).astype("f") + 0.1
    Z = rs.rand(R).astype("f") + 0.1
    return {"V": rs.rand(M, K).astype("f"), "W": W / W.sum(0),
            "H": H / H.sum(0), "Z": Z / Z.sum()}


def _sparse_problem(seed, M=40, K=28, R=4):
    rs = np.random.RandomState(seed)
    V = np.where(rs.rand(M, K) > 0.7, rs.rand(M, K), 0).astype("f")
    return {"V": V, "W": rs.rand(K, R).astype("f") + 0.1,
            "H": rs.rand(M, R).astype("f") + 0.1}


def _nmfd_problem(seed, N=1, C=6, R=2, L=40, T=3):
    rs = np.random.RandomState(seed)
    return {"V": rs.rand(N, C, L).astype("f") + 0.01,
            "W": rs.rand(C, R, T).astype("f") + 0.1,
            "H": rs.rand(N, R, L - T + 1).astype("f") + 0.1}


def _siplca_problem(seed):
    p = _nmfd_problem(seed)
    rs = np.random.RandomState(seed + 1000)
    W, H = p["W"], p["H"]
    Z = rs.rand(W.shape[1]).astype("f") + 0.1
    return {"V": p["V"] - 0.01, "W": W / W.sum((0, 2), keepdims=True),
            "H": H / H.sum((0, 2), keepdims=True), "Z": Z / Z.sum()}


TWO, MESH22 = {"data": 2}, {"data": 2, "model": 2}
# configuration: (fit kind, mesh, fit keywords, problem)
CONFIGS = {}
for _i, _beta in enumerate((0, 0.5, 1, 2)):
    # at β=0 the relative decreases after chunk 1 are nearly flat: seed 102
    # is a problem whose decrease falls from chunk 2 to chunk 3 (seed 0's
    # rises), so that a tol stops it at chunk 3
    CONFIGS[f"nmf_b{_beta}"] = ("nmf", TWO, dict(beta=_beta),
                                _nmf_problem(102 if _beta == 0 else _i))
    CONFIGS[f"nmf_model_b{_beta}"] = ("nmf", MESH22,
                                      dict(beta=_beta, model_axis="model"),
                                      _nmf_problem(10 + _i))
CONFIGS["plca"] = ("plca", TWO, {}, _plca_problem(20))
CONFIGS["plca_alpha"] = ("plca", TWO, dict(W_alpha=1.02, H_alpha=0.99),
                         _plca_problem(21))
CONFIGS["plca_verbose"] = ("plca", TWO, dict(verbose=True), _plca_problem(22))
for _i, _beta in enumerate((1, 2)):
    CONFIGS[f"sparse_b{_beta}"] = ("sparse", TWO, dict(beta=_beta),
                                   _sparse_problem(30 + _i))
LOOP_CASES = [f"{c}-{m}" for c in CONFIGS for m in ITERS]

# the flows: (fit kind, mesh, fit keywords, problem, steps)
_HIT = [dict(do="fit", out="a", inputs="dtensor"),
        dict(do="fit", out="b", inputs="dtensor"),
        dict(do="fit", out="c", inputs="dtensor", start="b"),
        dict(do="fit", out="c_eager", inputs="dtensor", start="b",
             graph=False)]
_REFRESH = [dict(do="fit", out="a", inputs="dtensor"), dict(do="scale"),
            dict(do="fit", out="b", inputs="dtensor"),
            dict(do="fit", out="b_eager", inputs="dtensor", graph=False)]
_C9 = [dict(do="fit", out="a", inputs="full"),
       dict(do="fit", out="b", inputs="dtensor"),
       dict(do="fit", out="c", inputs="dtensor", start="b"),
       dict(do="fit", out="c_full", inputs="full", start="b")]
FLOWS = {
    "hit_nmf": ("nmf", TWO, dict(beta=1), _nmf_problem(40), _HIT),
    "hit_model": ("nmf", MESH22, dict(beta=0.5, model_axis="model"),
                  _nmf_problem(41), _HIT),
    "refresh_nmf": ("nmf", TWO, dict(beta=1), _nmf_problem(42), _REFRESH),
    "refresh_plca": ("plca", TWO, {}, _plca_problem(43), _REFRESH),
    "refresh_sparse": ("sparse", TWO, dict(beta=1), _sparse_problem(44),
                       _REFRESH),
    "clear_rank1": ("nmf", TWO, dict(beta=1), _nmf_problem(45),
                    [dict(do="fit", out="a", inputs="dtensor"),
                     dict(do="clear", ranks=[1]),
                     dict(do="fit", out="b", inputs="dtensor")]),
    "c9_nmf": ("nmf", TWO, dict(beta=1), _nmf_problem(50), _C9),
    "c9_nmf_model": ("nmf", MESH22, dict(beta=1, model_axis="model"),
                     _nmf_problem(51), _C9),
    "c9_plca": ("plca", TWO, {}, _plca_problem(52), _C9),
    "c9_sparse": ("sparse", TWO, dict(beta=1), _sparse_problem(53), _C9),
    "c9_nmfd": ("nmfd", {"seq": 2}, dict(beta=1), _nmfd_problem(54), _C9),
    "c9_siplca": ("siplca", {"seq": 2}, {}, _siplca_problem(55), _C9),
    # last: it makes the group again (every rank of the world takes part)
    "regroup": ("nmf", {"data": 4}, dict(beta=1), _nmf_problem(56),
                [dict(do="fit", out="a", inputs="dtensor"),
                 dict(do="regroup"),
                 dict(do="fit", out="b", inputs="dtensor")]),
}
FLOW_ITERS = 30  # three chunks: cold, the eager chunks and a third
for _name, (_fit, _axes, _kw, _p, _s) in FLOWS.items():
    _kw.update(tol=0, max_iter=10 if _fit in ("nmfd", "siplca") else
               FLOW_ITERS)


def _single_loss(kind, kw, p, W, H, Z=None):
    """The loss a fit tests (``sqrt(2·divergence)``) of factors on a whole
    problem, in float64."""
    V = p["V"].astype("f8")
    if kind == "plca":
        R = H @ (W * Z).T * V.sum()
        return np.sqrt(2 * np.sum(V * np.log((V + 1e-30) / R) - V + R))
    WH = H @ W.T
    beta = kw["beta"]
    if beta == 2:
        d = 0.5 * np.sum((V - WH) ** 2)
    elif beta == 1:
        d = np.sum(np.where(V > 0, V * np.log(np.maximum(V, 1e-30) / WH), 0)
                   - V + WH)
    elif beta == 0:
        d = np.sum(V / WH - np.log(V / WH) - 1)
    else:
        d = np.sum((V ** beta + (beta - 1) * WH ** beta
                    - beta * V * WH ** (beta - 1)) / (beta * (beta - 1)))
    return np.sqrt(2 * d)


def _stop_tol(name):
    """A ``tol`` that stops configuration ``name`` at chunk STOP_CHUNK: the
    geometric mean of the relative decreases of the chunk before and that
    chunk, from the port's single-card fit of the whole problem at 10, 20
    and 30 iterations (its trajectory is the sharded fit's to float32
    summation order)."""
    import torch

    from pytorch_nmf_tpu_torch.ops.sparse import sparse_from_dense
    from pytorch_nmf_tpu_torch.utils import nmf_from_numpy, plca_from_numpy

    kind, _, kw, p = CONFIGS[name]
    kw = {k: v for k, v in kw.items() if k not in ("model_axis", "verbose")}
    losses = [_single_loss(kind, kw, p, p["W"], p["H"], p.get("Z"))]
    for n in range(1, STOP_CHUNK + 1):
        if kind == "plca":
            m = plca_from_numpy({k: p[k] for k in ("W", "H", "Z")}, "cpu")
            m.fit(torch.from_numpy(p["V"]), tol=0, max_iter=10 * n, **kw)
            f = {k: getattr(m, k).detach().numpy().astype("f8")
                 for k in ("W", "H", "Z")}
        else:
            m = nmf_from_numpy({"W": p["W"], "H": p["H"]}, "cpu")
            V = torch.from_numpy(p["V"])
            m.fit(sparse_from_dense(V) if kind == "sparse" else V, tol=0,
                  max_iter=10 * n, **kw)
            f = {k: getattr(m, k).detach().numpy().astype("f8")
                 for k in ("W", "H")}
        losses.append(_single_loss(kind, kw, p, f["W"], f["H"], f.get("Z")))
    d = -np.diff(losses) / losses[0]
    tol = float(np.sqrt(d[-2] * d[-1]))
    # a margin far above float32's reordering (about 1e-6 relative)
    assert (d[:-1] > 1.02 * tol).all() and d[-1] < tol / 1.02, (name, d)
    return tol


def _loop_case(name):
    config, m = name.rsplit("-", 1)
    kind, axes, kw, p = CONFIGS[config]
    kw = dict(kw, tol=0.0, max_iter=int(m) if m != "stop" else 200)
    return {"name": name, "kind": kind, "axes": axes, "kw": kw,
            "events": bool(kw.get("verbose"))}, p


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side (JAX on the CPU); skips where JAX is
    missing, so the card's tests need none."""
    return pytest.importorskip("jax")


@pytest.fixture(scope="module")
def cases():
    """``{name: (case, inputs)}``: every configuration at every
    ``max_iter`` with its eager twin (``{name}_eager``), and the flows."""
    tols = {c: _stop_tol(c) for c in CONFIGS}
    out = {}
    for name in LOOP_CASES:
        case, p = _loop_case(name)
        if name.endswith("-stop"):
            case["kw"]["tol"] = tols[name.rsplit("-", 1)[0]]
        out[name] = (case, p)
        twin = dict(case, name=name + "_eager",
                    kw=dict(case["kw"], _graph=False))
        out[twin["name"]] = (twin, p)
    for name, (fit, axes, kw, p, steps) in FLOWS.items():
        out[name] = ({"name": name, "kind": "compiled", "fit": fit,
                      "axes": axes, "kw": kw, "steps": steps}, p)
    return out


@pytest.fixture(scope="module")
def port(tmp_path_factory, cases):
    """Every case through 4 gloo ranks, once: ``[rank results]``."""
    arrays = {f"{name}:{k}": v for name, (_, inp) in cases.items()
              for k, v in inp.items()}
    return run_group(tmp_path_factory.mktemp("torch_compiled_sharded"), 4,
                     [c for c, _ in cases.values()], arrays, timeout=420)


def _ranks(axes):
    return int(np.prod(list(axes.values())))


def _got(port, name, axes):
    """Rank 0's results of ``name``, after checking that every rank of the
    mesh returned the same (``reads``: each rank's own)."""
    out = port[0][name]
    assert "error" not in out, bytes(out["error"]).decode()
    for r in range(1, _ranks(axes)):
        for k, v in out.items():
            if k != "events":  # rank 0 alone reports
                np.testing.assert_array_equal(port[r][name][k], v, err_msg=k)
    return out


def _close(got, ref, rtol=RTOL, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= rtol, (what, err)


def _jax_mesh(axes):
    import jax

    from pytorch_nmf_tpu.parallel import make_mesh

    return make_mesh(axes, jax.devices()[:_ranks(axes)])


def _jax_fit(kind, axes, kw, V, W, H, Z=None, events=None):
    """The JAX package's jitted sharded fit: its outputs as numpy arrays
    (``events``: a list that takes its progress events)."""
    import pytorch_nmf_tpu.parallel as jp
    from pytorch_nmf_tpu.ops import solver as jsolver
    from pytorch_nmf_tpu.ops.sparse import sparse_from_dense

    mesh = _jax_mesh(axes)
    if kind == "nmf":
        out = jp.sharded_nmf_fit(V, W, H, mesh, **kw)
    elif kind == "sparse":
        out = jp.sharded_sparse_nmf_fit(sparse_from_dense(V), W, H, mesh, **kw)
    elif kind == "nmfd":
        out = jp.sharded_nmfd_fit(V, W, H, mesh, **kw)
    elif kind == "siplca":
        out = jp.sharded_siplca_fit(V, W, H, Z, mesh, **kw)
    else:
        if events is not None:
            jsolver.push_progress_handler(lambda *e: events.append(e))
        try:
            out = jp.sharded_plca_fit(V, W, H, Z, mesh, **kw)
        finally:
            if events is not None:
                jsolver.pop_progress_handler()
    return [np.asarray(x) for x in out]


def _factors(kind):
    return ("W", "H", "Z") if kind in ("plca", "siplca") else ("W", "H")


def _check_jax(got, kind, axes, kw, p, start=None, events=None):
    """``got`` (a fit's results) within RTOL of JAX's fit from ``start``
    (the problem's own by default), with the same ``n_iter``."""
    start = start or p
    ref = _jax_fit(kind, axes, kw, p["V"], *[start[k] for k in
                                             _factors(kind)], events=events)
    assert int(got["n_iter"]) == int(ref[len(_factors(kind))])
    for key, r in zip(_factors(kind), ref):
        _close(got[key], r, what=key)
    if kind in ("plca", "siplca"):
        _close(got["norm"], ref[-1], what="norm")


@pytest.mark.parametrize("name", LOOP_CASES)
def test_graphed_equals_eager_and_jax(jx, port, cases, name):
    """Every rank agrees; the graphed fit equals its eager twin bit for bit
    (factors, ``n_iter``, PLCA's ``norm``, a verbose fit's progress events)
    and JAX's jitted fit within 1e-5 with the same ``n_iter``."""
    case, p = cases[name]
    got = _got(port, name, case["axes"])
    eager = _got(port, name + "_eager", case["axes"])
    assert set(got) == set(eager)
    for k, v in eager.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    kw = {k: v for k, v in case["kw"].items()}
    events = [] if case["events"] else None
    _check_jax(got, case["kind"], case["axes"], kw, p, events=events)
    # PLCA's n_iter is the reference's raw loop index
    want = 10 * STOP_CHUNK if name.endswith("-stop") else kw["max_iter"]
    assert int(got["n_iter"]) == want - (case["kind"] == "plca")
    if events is not None:  # rank 0's reports, one a chunk, as JAX's
        mine = got["events"]
        assert [int(e[0]) for e in mine] == [int(e[0]) for e in events]
        for e, j in zip(mine, events):
            _close(e[1:], np.asarray(j[1:], dtype=np.float64), what="event")


def _counts(out, fit):
    return {k: int(out[f"{fit}_{k}"]) for k in
            ("reads", "hits", "warm", "cold", "ar_calls", "ar_bytes")}


def _equal_fits(out, a, b, kind):
    for k in _factors(kind) + ("n_iter",) + (("norm",) if kind in (
            "plca", "siplca") else ()):
        np.testing.assert_array_equal(out[f"{a}_{k}"], out[f"{b}_{k}"],
                                      err_msg=f"{a} against {b}: {k}")


def _fit_out(out, fit, kind):
    return {k: out[f"{fit}_{k}"] for k in _factors(kind) + ("n_iter",) + (
        ("norm",) if kind in ("plca", "siplca") else ())}


@pytest.mark.parametrize("name", ["hit_nmf", "hit_model"])
def test_shard_target_dtensor_is_a_cache_hit(jx, port, name):
    """A second fit on the same ``shard_target`` DTensors is a hit (no
    miss): one call of the whole loop, bit for bit the first fit; fed its
    own outputs back it is a hit again and equals the eager twin.  The
    loop's reads on the CPU: a cold fit of 3 chunks 3 + 4 (the two eager
    chunks' flags, the loop's, the status), a hit 3 + 2."""
    kind, axes, kw, p, _ = FLOWS[name]
    out = _got(port, name, axes)
    n = FLOW_ITERS // 10
    assert _counts(out, "a")["cold"] + _counts(out, "a")["warm"] == 1
    for fit in ("b", "c"):
        c = _counts(out, fit)
        assert (c["hits"], c["warm"], c["cold"]) == (1, 0, 0), (fit, c)
        assert c["reads"] == n + 2, (fit, c)
    assert _counts(out, "a")["reads"] == n + 4
    _equal_fits(out, "a", "b", kind)
    _equal_fits(out, "c", "c_eager", kind)
    # the all-reduces a fit makes: one a loss (entry, each chunk), one a W
    # and (with a model axis) one an H update an iteration
    per_iter = 1 + ("model_axis" in kw)
    for fit in ("a", "b", "c", "c_eager"):
        assert _counts(out, fit)["ar_calls"] == (
            (1 + n) * (1 + ("model_axis" in kw)) + per_iter * FLOW_ITERS)
        assert _counts(out, fit)["ar_bytes"] == _counts(out, "c_eager")[
            "ar_bytes"]
    _check_jax(_fit_out(out, "a", kind), kind, axes, kw, p)


@pytest.mark.parametrize("name", ["refresh_nmf", "refresh_plca",
                                  "refresh_sparse"])
def test_write_through_data_is_refreshed(jx, port, name):
    """A fit on a kept entry after ``V``'s values were tripled through
    ``.data`` (no key moves: a hit) reads the new values: bit for bit the
    eager twin, and JAX's fit on 3·V within 1e-5 (PLCA's ``norm`` too)."""
    kind, axes, kw, p, _ = FLOWS[name]
    out = _got(port, name, axes)
    c = _counts(out, "b")
    assert (c["hits"], c["warm"], c["cold"]) == (1, 0, 0), c
    _equal_fits(out, "b", "b_eager", kind)
    _check_jax(_fit_out(out, "b", kind), kind, axes, kw,
               dict(p, V=p["V"] * np.float32(3)))


def test_one_rank_cache_cleared_alone(port):
    """Rank 1 empties its cache between two fits: the ranks agree on the
    path before the first chunk, so rank 0 falls back from its hit to the
    cold fit (the same reads on both), the collectives pair, and both
    fits are bit for bit the same."""
    kind, axes, kw, p, _ = FLOWS["clear_rank1"]
    out = [port[r]["clear_rank1"] for r in range(2)]
    for o in out:
        assert "error" not in o
    n = FLOW_ITERS // 10
    assert int(out[0]["b_hits"]) == 1 and int(out[1]["b_cold"]) == 1
    assert int(out[0]["b_reads"]) == int(out[1]["b_reads"]) == n + 4
    for o in out:
        _equal_fits(o, "a", "b", kind)
    for k in ("b_W", "b_H", "b_n_iter"):
        np.testing.assert_array_equal(out[0][k], out[1][k])


def test_group_destroyed_and_made_again(port):
    """``compiled_cache_clear()`` on every rank, then the group destroyed
    and a new one started in the same processes: the next fit is a cold
    one on the new group, bit for bit the first."""
    kind, axes, kw, p, _ = FLOWS["regroup"]
    out = _got(port, "regroup", axes)
    assert bool(out["regrouped"])
    assert int(out["b_cold"]) == 1
    _equal_fits(out, "a", "b", kind)


@pytest.mark.parametrize("name", ["c9_nmf", "c9_nmf_model", "c9_plca",
                                  "c9_sparse", "c9_nmfd", "c9_siplca"])
def test_dtensor_inputs_equal_full_arrays(jx, port, name):
    """C9: DTensor inputs (``shard_target``'s, and the fit's own outputs
    fed back) give the full-array call's fit bit for bit, and JAX's within
    1e-5 from the same starts."""
    kind, axes, kw, p, _ = FLOWS[name]
    out = _got(port, name, axes)
    _equal_fits(out, "a", "b", kind)
    _equal_fits(out, "c", "c_full", kind)
    _check_jax(_fit_out(out, "a", kind), kind, axes, kw, p)
    start = {k: out[f"b_{k}"] for k in _factors(kind)}
    _check_jax(_fit_out(out, "c", kind), kind, axes, kw, p, start=start)


@pytest.mark.parametrize("transports, sizes, mixing, want", [
    (("gloo",), (2,), None, True),
    (("gloo-staged",), (2,), "0", False),
    (("nccl",), (1,), None, True),
    (("nccl",), (4,), None, False),
    (("nccl",), (4,), "0", True),
    (("nccl", "nccl"), (2, 2), "1", False),
])
def test_transports_that_compile(monkeypatch, transports, sizes, mixing, want):
    """The compiled loop's up-front choice from the transports (a ``None``
    Comm: no model axis): gloo on the CPU, and NCCL where a WHILE node's
    body holds its all-reduces (one rank, or across ranks with NCCL's graph
    mixing support off); never ``"gloo-staged"``."""
    from types import SimpleNamespace

    from pytorch_nmf_tpu_torch.parallel import sharded

    if mixing is None:
        monkeypatch.delenv("NCCL_GRAPH_MIXING_SUPPORT", raising=False)
    else:
        monkeypatch.setenv("NCCL_GRAPH_MIXING_SUPPORT", mixing)
    comms = [SimpleNamespace(transport=t, size=n)
             for t, n in zip(transports, sizes)] + [None]
    assert sharded._compiles(comms) is want


# --------------------------------------------------------------------------
# on the card: one NCCL rank, the chunk loop one CUDA-graph WHILE node
# --------------------------------------------------------------------------
CUDA_FLOWS = {
    "cuda_nmf_b0.5": ("nmf", dict(beta=0.5), _nmf_problem(70, M=512, K=260,
                                                          R=16)),
    "cuda_plca": ("plca", {}, _plca_problem(71, M=512, K=260, R=16)),
    "cuda_sparse_b1": ("sparse", dict(beta=1),
                       _sparse_problem(72, M=512, K=260, R=16)),
}
_CUDA_STEPS = [dict(do="fit", out="cold", inputs="dtensor"),
               dict(do="fit", out="warm", inputs="dtensor"),
               dict(do="fit", out="eager", inputs="dtensor", graph=False),
               dict(do="fit", out="new_v", inputs="full")]


@pytest.fixture(scope="module")
def port_cuda(tmp_path_factory):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cases, arrays = [], {}
    for name, (fit, kw, p) in CUDA_FLOWS.items():
        cases.append({"name": name, "kind": "compiled", "fit": fit,
                      "axes": {"data": 1}, "device": "cuda",
                      "kw": dict(kw, tol=0, max_iter=50),
                      "steps": _CUDA_STEPS})
        arrays.update({f"{name}:{k}": v for k, v in p.items()})
    return run_group(tmp_path_factory.mktemp("torch_compiled_sharded_cuda"),
                     1, cases, arrays, timeout=600, backend="nccl")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CUDA_FLOWS))
def test_cuda_nccl_fit_is_one_replay(port_cuda, name):
    """One NCCL rank: the cold fit (2 eager chunks, a capture, one replay)
    and the warm one (one replay, one host read) equal the eager twin bit
    for bit, as does a fit on a new V of the configuration; the
    all-reduces' calls and bytes as the eager twin's."""
    kind = CUDA_FLOWS[name][0]
    out = port_cuda[0][name]
    assert "error" not in out, bytes(out["error"]).decode()
    for fit in ("cold", "warm", "new_v"):
        _equal_fits(out, fit, "eager", kind)
    assert _counts(out, "cold")["reads"] == 5
    assert _counts(out, "warm")["reads"] == 1
    assert _counts(out, "warm")["hits"] == 1
    for fit in ("cold", "warm", "new_v"):
        for k in ("ar_calls", "ar_bytes"):
            assert _counts(out, fit)[k] == _counts(out, "eager")[k], (fit, k)

"""The halo fits (NMFD/NMF2D/NMF3D and the SIPLCA family,
``parallel/halo.py``) compiled once per configuration: their chunk loop on
the fits' cache of ``ops/solver.py`` through ``sharded._run_fit``, against
their eager twins (``_graph=False``, ``_converging_loop``) bit for bit and
the JAX package's jitted shard_map halo fits.

The port runs in 2 gloo rank processes on the CPU (``_torch_parallel_child``,
one group for the file, started once by a module-scoped fixture, with its
timeout: a hang fails the group, not the suite) on a 2-rank ``seq`` mesh.
On the CPU the chunk loop runs eagerly through the same workload the card
captures, reading its flag before each chunk.  The JAX side runs here on a
2-device sub-mesh of the 8 virtual CPU devices, in its own per-shard mode
(the same function; the port's forced modes share their configuration's
JAX fit).  Tolerance: 1e-5 relative to the factor's largest entry, with the
same ``n_iter`` (SIPLCA's raw loop index) and, for SIPLCA, ``norm``.

Each configuration runs at ``max_iter`` 0, 5, 10 and 47 (``tol=0``) and at
a ``tol`` that stops it at chunk 3 (``stop``: between the relative
decreases of chunks 2 and 3, from the port's single-card fit of the same
problem), in the mode the fit resolves or in a forced per-shard mode
(``name@mode``: every MU mode and every EM mode once).  The flows
(``compiled`` cases) hold a second fit (a cache hit), a fit on another V of
the same shape (a hit too: the entry copies each fit's chunk into its
own), DTensor inputs (a fit's own outputs fed back) against full arrays,
one rank's cache cleared alone and the process group destroyed and made
again.  The CUDA test runs one NCCL rank on the card.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from _torch_parallel_child import run_group  # noqa: E402

RTOL = 1e-5
ITERS = (0, 5, 10, 47, "stop")
STOP_CHUNK = 3
SEQ = {"seq": 2}


def _deconv_problem(seed, C=6, R=2, S_out=(40,), kernel=(3,), N=1):
    rs = np.random.RandomState(seed)
    S_in = tuple(s - k + 1 for s, k in zip(S_out, kernel))
    return {"V": rs.rand(N, C, *S_out).astype("f") + 0.01,
            "W": rs.rand(C, R, *kernel).astype("f") + 0.1,
            "H": rs.rand(N, R, *S_in).astype("f") + 0.1}


def _siplca_problem(seed, **kw):
    """A normalized start (the SIPLCA constructors' normalization)."""
    p = _deconv_problem(seed, **kw)
    rs = np.random.RandomState(seed + 1000)
    W, H = p["W"], p["H"]
    axes = (0,) + tuple(range(2, W.ndim))
    Z = rs.rand(W.shape[1]).astype("f") + 0.1
    return {"V": p["V"] - 0.01, "W": W / W.sum(axes, keepdims=True),
            "H": H / H.sum(axes, keepdims=True), "Z": Z / Z.sum()}


def _with_v2(p, seed):
    """``p`` and ``V2``: another target of ``V``'s shape."""
    rs = np.random.RandomState(seed)
    return dict(p, V2=(rs.rand(*p["V"].shape).astype("f") + 0.01))


# configuration: (fit kind, spatial ndim, fit keywords, problem); a name
# ``base@mode`` forces the per-shard mode on ``base``'s problem and keywords
CONFIGS = {
    "nmfd_b0.5": ("deconv", 1, dict(beta=0.5), _deconv_problem(0)),
    "nmfd_b1": ("deconv", 1, dict(beta=1), _deconv_problem(1)),
    "nmfd_b2": ("deconv", 1, dict(beta=2), _deconv_problem(2)),
    # L_out 41 over 2 ranks: a padded tail, its loss offset at β=0.5
    "nmfd_pad_b0.5": ("deconv", 1, dict(beta=0.5),
                      _deconv_problem(3, S_out=(41,))),
    "nmfd_frozen_w": ("deconv", 1, dict(beta=1, update_W=False),
                      _deconv_problem(4)),
    "nmf2d_b1": ("deconv", 2, dict(beta=1),
                 _deconv_problem(5, C=5, S_out=(4, 24), kernel=(2, 3))),
    "nmf3d_b1": ("deconv", 3, dict(beta=1),
                 _deconv_problem(6, C=4, S_out=(3, 4, 16),
                                 kernel=(2, 2, 3))),
    "siplca": ("siplca", 1, {}, _siplca_problem(10)),
    # padded H under an active H prior (the mask), and a W prior
    "siplca_alpha": ("siplca", 1, dict(W_alpha=1.02, H_alpha=0.99),
                     _siplca_problem(23, S_out=(41,))),
    "siplca_verbose": ("siplca", 1, dict(verbose=True), _siplca_problem(12)),
    "siplca2": ("siplca", 2, {},
                _siplca_problem(13, C=5, S_out=(4, 24), kernel=(2, 3))),
}
MU_MODES = ("fused", "fused_w", "stream", "unrolled", "conv")
EM_MODES = ("fused", "unrolled", "conv")
FORCED = [f"nmfd_pad_b0.5@{m}" for m in MU_MODES] + [
    f"siplca_alpha@{m}" for m in EM_MODES]
LOOP_CASES = [f"{c}-{m}" for c in list(CONFIGS) + FORCED for m in ITERS]


def _config(name):
    """``(kind, nd, keywords, problem, mode)`` of configuration ``name``."""
    base, _, mode = name.partition("@")
    return CONFIGS[base] + (mode or None,)


# the flows: (fit kind, nd, fit keywords, problem, steps)
_FLOW_ITERS = 30  # three chunks: the cold fit's two eager ones and a third
_HIT = [dict(do="fit", out="a", inputs="full"),
        dict(do="fit", out="a_eager", inputs="full", graph=False),
        dict(do="fit", out="b", inputs="full"),
        dict(do="fit", out="c", inputs="other"),
        dict(do="fit", out="c_eager", inputs="other", graph=False),
        dict(do="fit", out="d", inputs="dtensor")]
_C9 = [dict(do="fit", out="a", inputs="full"),
       dict(do="fit", out="b", inputs="dtensor"),
       dict(do="fit", out="c", inputs="dtensor", start="b"),
       dict(do="fit", out="c_full", inputs="full", start="b"),
       dict(do="fit", out="c_eager", inputs="dtensor", start="b",
            graph=False)]
FLOWS = {
    "hit_nmfd": ("nmfd", 1, dict(beta=0.5),
                 _with_v2(_deconv_problem(20, S_out=(41,)), 21), _HIT),
    "hit_siplca": ("siplca", 1, dict(H_alpha=0.99),
                   _with_v2(_siplca_problem(22, S_out=(41,)), 23), _HIT),
    "c9_nmf2d": ("nmfd", 2, dict(beta=1),
                 _deconv_problem(24, C=5, S_out=(4, 24), kernel=(2, 3)), _C9),
    "c9_siplca2": ("siplca", 2, {},
                   _siplca_problem(25, C=5, S_out=(4, 24), kernel=(2, 3)),
                   _C9),
    "clear_rank1": ("nmfd", 1, dict(beta=1), _deconv_problem(26),
                    [dict(do="fit", out="a", inputs="dtensor"),
                     dict(do="clear", ranks=[1]),
                     dict(do="fit", out="b", inputs="dtensor")]),
    # last: it makes the group again
    "regroup": ("siplca", 1, {}, _siplca_problem(27),
                [dict(do="fit", out="a", inputs="dtensor"),
                 dict(do="regroup"),
                 dict(do="fit", out="b", inputs="dtensor")]),
}
for _name, (_fit, _nd, _kw, _p, _s) in FLOWS.items():
    _kw.update(tol=0, max_iter=_FLOW_ITERS)


def _loss(kind, nd, kw, p, W, H, Z=None):
    """The loss a fit tests (``sqrt(2·divergence)``) of factors on a whole
    problem, in float64 (the port's metrics and reconstructions)."""
    import torch

    from pytorch_nmf_tpu_torch.metrics import beta_div, kl_div
    from pytorch_nmf_tpu_torch.ops import recon

    t = {k: torch.from_numpy(np.asarray(x, "f8")) for k, x in
         (("V", p["V"]), ("W", W), ("H", H)) + ((("Z", Z),) if Z is not None
                                                 else ())}
    deconv = getattr(recon, f"deconv{nd}d")
    if kind == "siplca":
        R = deconv(t["H"], recon.scaled_kernel(t["W"], t["Z"], nd))
        d = kl_div(R * t["V"].sum(), t["V"])
    else:
        d = beta_div(deconv(t["H"], t["W"]), t["V"], kw["beta"])
    return float(np.sqrt(2 * float(d)))


def _stop_tol(name):
    """A ``tol`` that stops configuration ``name`` at chunk STOP_CHUNK: the
    geometric mean of the relative decreases of the chunk before and that
    chunk, from the port's single-card fit of the whole problem at 10, 20
    and 30 iterations (its trajectory is the halo fit's to float32
    summation order)."""
    import torch

    from pytorch_nmf_tpu_torch import functional
    from pytorch_nmf_tpu_torch.plca import SIPLCA, SIPLCA2, SIPLCA3

    kind, nd, kw, p, _ = _config(name)
    kw = {k: v for k, v in kw.items() if k != "verbose"}
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    losses = [_loss(kind, nd, kw, p, p["W"], p["H"], p.get("Z"))]
    for n in range(1, STOP_CHUNK + 1):
        if kind == "siplca":
            W, H, Z, _, _ = functional.plca_fit(
                t["V"], t["W"], t["H"], t["Z"],
                model_cls=(SIPLCA, SIPLCA2, SIPLCA3)[nd - 1], tol=0,
                max_iter=10 * n, **kw)
            f = (W, H, Z)
        else:
            fit = (functional.nmfd_fit, functional.nmf2d_fit,
                   functional.nmf3d_fit)[nd - 1]
            f = fit(t["V"], t["W"], t["H"], tol=0, max_iter=10 * n, **kw)[:2]
        losses.append(_loss(kind, nd, kw, p, *[x.numpy() for x in f]))
    d = -np.diff(losses) / losses[0]
    tol = float(np.sqrt(d[-2] * d[-1]))
    # a margin far above float32's reordering (about 1e-6 relative)
    assert (d[:-1] > 1.02 * tol).all() and d[-1] < tol / 1.02, (name, d)
    return tol


def _loop_case(name, tols):
    config, m = name.rsplit("-", 1)
    kind, nd, kw, p, mode = _config(config)
    kw = dict(kw, tol=0.0 if m != "stop" else tols[config.partition("@")[0]],
              max_iter=int(m) if m != "stop" else 200)
    case = {"name": name, "kind": kind, "nd": nd, "axes": SEQ, "kw": kw,
            "events": bool(kw.get("verbose"))}
    if mode is not None:
        case["mode"] = mode
    return case, p


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
        case, p = _loop_case(name, tols)
        out[name] = (case, p)
        twin = dict(case, name=name + "_eager",
                    kw=dict(case["kw"], _graph=False))
        out[twin["name"]] = (twin, p)
    for name, (fit, nd, kw, p, steps) in FLOWS.items():
        out[name] = ({"name": name, "kind": "compiled", "fit": fit, "nd": nd,
                      "axes": SEQ, "kw": kw, "steps": steps}, p)
    out["strict_all_reduce"] = (
        {"name": "strict_all_reduce", "kind": "strict_all_reduce",
         "axes": SEQ, "kw": {}},
        {"x": np.random.RandomState(30).rand(5, 7).astype("f")})
    return out


def _jax_refs(cases):
    """The JAX fits the tests compare with that need no port output (each
    loop case's, each flow's from its problem's start, on V and V2), into
    the cache: what runs while the port's ranks do."""
    try:
        import jax  # noqa: F401
    except ImportError:
        return
    for name, (case, p) in cases.items():
        if name in LOOP_CASES:
            _jax_fit(case["kind"], case["nd"], case["kw"], p["V"], p["W"],
                     p["H"], p.get("Z"))
        elif name in FLOWS:
            kind = "siplca" if case["fit"] == "siplca" else "deconv"
            for V in (p["V"], p.get("V2")):
                if V is not None:
                    _jax_fit(kind, case["nd"], case["kw"], V, p["W"], p["H"],
                             p.get("Z"))


@pytest.fixture(scope="module")
def port(tmp_path_factory, cases):
    """Every case through 2 gloo ranks, once: ``[rank results]``.  The MU
    and EM cases run in two groups at once, beside the JAX references."""
    import threading

    groups = [{}, {}]
    for name, (case, inp) in cases.items():
        em = case.get("fit", case["kind"]) == "siplca"
        groups[em][name] = (case, inp)
    results = [None, None]
    # made here: pytest's temporary directories are not made thread-safely
    dirs = [tmp_path_factory.mktemp(f"torch_compiled_halo{i}")
            for i in range(2)]

    def run(i):
        arrays = {f"{name}:{k}": v for name, (_, inp) in groups[i].items()
                  for k, v in inp.items()}
        results[i] = run_group(dirs[i], 2, [c for c, _ in groups[i].values()],
                               arrays, timeout=420)

    threads = [threading.Thread(target=run, args=(1,))]
    threads[0].start()
    try:
        run(0)
        _jax_refs(cases)
    finally:
        threads[0].join()
    assert results[1] is not None, "the EM cases' ranks failed"
    return [dict(a, **b) for a, b in zip(*results)]


def _got(port, name):
    """Rank 0's results of ``name``, after checking that every rank
    returned the same (``events``: rank 0 alone reports; the halo shifts'
    bytes are those each rank sends, which its place in the ring sets)."""
    out = port[0][name]
    assert "error" not in out, bytes(out["error"]).decode()
    for k, v in out.items():
        if k != "events" and not k.endswith("_halo_bytes"):
            np.testing.assert_array_equal(port[1][name][k], v, err_msg=k)
    return out


def _close(got, ref, rtol=RTOL, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= rtol, (what, err)


_JAX_FITS = {("deconv", 1): "sharded_nmfd_fit",
             ("deconv", 2): "sharded_nmf2d_fit",
             ("deconv", 3): "sharded_nmf3d_fit",
             ("siplca", 1): "sharded_siplca_fit",
             ("siplca", 2): "sharded_siplca2_fit",
             ("siplca", 3): "sharded_siplca3_fit"}
_JAX_CACHE = {}


def _jax_fit(kind, nd, kw, V, W, H, Z=None, events=None):
    """The JAX package's jitted halo fit on a 2-device CPU mesh: its
    outputs as numpy arrays (``events``: a list that takes its progress
    events); kept per inputs and keywords, so the forced modes share their
    configuration's fit."""
    import jax

    import pytorch_nmf_tpu.parallel as jp
    from pytorch_nmf_tpu.ops import solver as jsolver

    key = (kind, nd, tuple(sorted(kw.items())), V.tobytes(), W.tobytes(),
           H.tobytes(), None if Z is None else Z.tobytes())
    if key not in _JAX_CACHE:
        mesh = jp.make_mesh(SEQ, jax.devices()[:2])
        fit = getattr(jp, _JAX_FITS["siplca" if kind == "siplca"
                                    else "deconv", nd])
        args = (V, W, H) + ((Z,) if kind == "siplca" else ())
        seen = []
        jsolver.push_progress_handler(lambda *e: seen.append(e))
        try:
            out = fit(*args, mesh, **kw)
        finally:
            jsolver.pop_progress_handler()
        _JAX_CACHE[key] = ([np.asarray(x) for x in out], seen)
    out, seen = _JAX_CACHE[key]
    if events is not None:
        events.extend(seen)
    return out


def _factors(kind):
    return ("W", "H", "Z") if kind == "siplca" else ("W", "H")


def _check_jax(got, kind, nd, kw, p, start=None, V=None, events=None):
    """``got`` (a fit's results) within RTOL of JAX's fit on ``V`` (the
    problem's own by default) from ``start`` (likewise), with the same
    ``n_iter`` and, for SIPLCA, ``norm``."""
    start = start or p
    kind = "siplca" if kind == "siplca" else "deconv"
    ref = _jax_fit(kind, nd, kw, p["V"] if V is None else V,
                   *[np.asarray(start[k]) for k in _factors(kind)],
                   events=events)
    n = len(_factors(kind))
    assert int(got["n_iter"]) == int(ref[n])
    for key, r in zip(_factors(kind), ref):
        _close(got[key], r, what=key)
    if kind == "siplca":
        _close(got["norm"], ref[n + 1], what="norm")


@pytest.mark.parametrize("name", LOOP_CASES)
def test_graphed_equals_eager_and_jax(jx, port, cases, name):
    """Both ranks agree; the graphed halo fit equals its eager twin bit for
    bit (factors, ``n_iter``, SIPLCA's ``norm``, a verbose fit's progress
    events, the mode resolved) and JAX's jitted fit within 1e-5 with the
    same ``n_iter``."""
    case, p = cases[name]
    got = _got(port, name)
    eager = _got(port, name + "_eager")
    assert set(got) == set(eager)
    for k, v in eager.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    if "mode" in case:
        assert str(got["mode"]) == case["mode"]
    kw = {k: v for k, v in case["kw"].items()}
    events = [] if case["events"] else None
    _check_jax(got, case["kind"], case["nd"], kw, p, events=events)
    # SIPLCA's n_iter is the reference's raw loop index
    want = 10 * STOP_CHUNK if name.endswith("-stop") else kw["max_iter"]
    assert int(got["n_iter"]) == want - (case["kind"] == "siplca")
    if events is not None:  # rank 0's reports, one a chunk, as JAX's
        mine = got["events"]
        assert [int(e[0]) for e in mine] == [int(e[0]) for e in events]
        for e, j in zip(mine, events):
            _close(e[1:], np.asarray(j[1:], dtype=np.float64), what="event")


_KEYS = ("reads", "hits", "warm", "cold", "ar_calls", "ar_bytes",
         "halo_calls", "halo_bytes")


def _counts(out, fit):
    return {k: int(out[f"{fit}_{k}"]) for k in _KEYS}


def _equal_fits(out, a, b, kind):
    for k in _factors(kind) + ("n_iter",) + (("norm",) if kind == "siplca"
                                             else ()):
        np.testing.assert_array_equal(out[f"{a}_{k}"], out[f"{b}_{k}"],
                                      err_msg=f"{a} against {b}: {k}")


def _fit_out(out, fit, kind):
    return {k: out[f"{fit}_{k}"] for k in _factors(kind) + ("n_iter",) + (
        ("norm",) if kind == "siplca" else ())}


@pytest.mark.parametrize("name", ["hit_nmfd", "hit_siplca"])
def test_second_fit_and_another_v_are_hits(jx, port, name):
    """A configuration's second fit is a cache hit (one call of the whole
    loop: on the CPU a cold fit of 3 chunks reads 3 + 4 flags and status, a
    hit 3 + 2), bit for bit the first; a fit on another V of the same shape
    is a hit too (the entry copies each fit's chunk into its own), equal to
    its eager twin and to JAX's fit on that V; so is a fit on
    ``shard_target`` DTensors.  The all-reduces' and halo shifts' calls and
    bytes are the eager twin's."""
    kind, nd, kw, p, _ = FLOWS[name]
    out = _got(port, name)
    n = _FLOW_ITERS // 10
    a = _counts(out, "a")
    assert (a["cold"], a["reads"]) == (1, n + 4), a
    for fit in ("b", "c", "d"):
        c = _counts(out, fit)
        assert (c["hits"], c["warm"], c["cold"], c["reads"]) == (
            1, 0, 0, n + 2), (fit, c)
    _equal_fits(out, "a", "a_eager", kind)
    _equal_fits(out, "a", "b", kind)
    _equal_fits(out, "a", "d", kind)
    _equal_fits(out, "c", "c_eager", kind)
    for fit in ("a", "b", "c", "d"):
        for k in ("ar_calls", "ar_bytes", "halo_calls", "halo_bytes"):
            assert _counts(out, fit)[k] == _counts(out, "a_eager")[k], (fit, k)
    assert _counts(out, "a")["halo_calls"] > 0
    _check_jax(_fit_out(out, "a", kind), kind, nd, kw, p)
    _check_jax(_fit_out(out, "c", kind), kind, nd, kw, p, V=p["V2"])


@pytest.mark.parametrize("name", ["c9_nmf2d", "c9_siplca2"])
def test_dtensor_inputs_equal_full_arrays(jx, port, name):
    """DTensor inputs (``shard_target``'s, and the fit's own outputs fed
    back) give the full-array call's fit bit for bit and the eager twin's,
    and JAX's within 1e-5 from the same starts."""
    kind, nd, kw, p, _ = FLOWS[name]
    out = _got(port, name)
    _equal_fits(out, "a", "b", kind)
    _equal_fits(out, "c", "c_full", kind)
    _equal_fits(out, "c", "c_eager", kind)
    _check_jax(_fit_out(out, "a", kind), kind, nd, kw, p)
    start = {k: out[f"b_{k}"] for k in _factors(kind)}
    _check_jax(_fit_out(out, "c", kind), kind, nd, kw, p, start=start)


def test_one_rank_cache_cleared_alone(port):
    """Rank 1 empties its cache between two fits: the ranks agree on the
    path before the first chunk, so rank 0 falls back from its hit to the
    cold fit (the same reads on both), the collectives and shifts pair, and
    both fits are bit for bit the same."""
    kind, nd, kw, p, _ = FLOWS["clear_rank1"]
    out = [port[r]["clear_rank1"] for r in range(2)]
    for o in out:
        assert "error" not in o, bytes(o["error"]).decode()
    n = _FLOW_ITERS // 10
    assert int(out[0]["b_hits"]) == 1 and int(out[1]["b_cold"]) == 1
    assert int(out[0]["b_reads"]) == int(out[1]["b_reads"]) == n + 4
    for o in out:
        _equal_fits(o, "a", "b", kind)
    for k in ("b_W", "b_H", "b_n_iter"):
        np.testing.assert_array_equal(out[0][k], out[1][k])


def test_group_destroyed_and_made_again(jx, port):
    """``compiled_cache_clear()`` on every rank, then the group destroyed
    and a new one started in the same processes: the next fit is a cold
    one on the new group (its collectives' ``Comm`` the new group's, C10:
    the mesh made again equals the old one, and a ``Comm`` kept per mesh
    ran the halo fit's mode broadcast on the destroyed group), bit for bit
    the first, and JAX's."""
    kind, nd, kw, p, _ = FLOWS["regroup"]
    out = _got(port, "regroup")
    assert bool(out["regrouped"]) and bool(out["regroup_comm_new"])
    assert int(out["b_cold"]) == 1
    _equal_fits(out, "a", "b", kind)
    _check_jax(_fit_out(out, "b", kind), kind, nd, kw, p)


def test_all_reduce_of_a_tensor_not_contiguous(port, cases):
    """C11: ``Comm.all_reduce`` hands the backend contiguous tensors only
    (NCCL refuses others: the halo ``conv`` mode's cuDNN weight gradient
    raised "Tensors must be contiguous" over NCCL) and sums a tensor that
    is not contiguous in place, its strides kept."""
    out = _got(port, "strict_all_reduce")
    x = cases["strict_all_reduce"][1]["x"]
    np.testing.assert_array_equal(out["sum"], (x + x).T)
    assert bool(out["same_strides"])


# --------------------------------------------------------------------------
# on the card: one NCCL rank, the chunk loop one CUDA-graph WHILE node
# --------------------------------------------------------------------------
CUDA_FLOWS = {
    "cuda_nmfd_fused": ("nmfd", dict(beta=1), "fused",
                        _deconv_problem(70, C=64, R=16, S_out=(600,),
                                        kernel=(20,))),
    "cuda_nmfd_fused_w": ("nmfd", dict(beta=0.5), "fused_w",
                          _deconv_problem(71, C=64, R=16, S_out=(600,),
                                          kernel=(20,))),
    "cuda_siplca_fused": ("siplca", {}, "fused",
                          _siplca_problem(72, C=64, R=16, S_out=(600,),
                                          kernel=(20,))),
}
_CUDA_STEPS = [dict(do="fit", out="cold", inputs="dtensor"),
               dict(do="fit", out="warm", inputs="dtensor"),
               dict(do="fit", out="eager", inputs="dtensor", graph=False),
               dict(do="fit", out="other", inputs="other"),
               dict(do="fit", out="other_eager", inputs="other",
                    graph=False)]


@pytest.fixture(scope="module")
def port_cuda(tmp_path_factory):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cases, arrays = [], {}
    for name, (fit, kw, mode, p) in CUDA_FLOWS.items():
        cases.append({"name": name, "kind": "compiled", "fit": fit,
                      "axes": {"seq": 1}, "device": "cuda", "mode": mode,
                      "kw": dict(kw, tol=0, max_iter=50),
                      "steps": _CUDA_STEPS})
        arrays.update({f"{name}:{k}": v
                       for k, v in _with_v2(p, 73).items()})
    return run_group(tmp_path_factory.mktemp("torch_compiled_halo_cuda"),
                     1, cases, arrays, timeout=600, backend="nccl")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CUDA_FLOWS))
def test_cuda_nccl_halo_fit_is_one_replay(port_cuda, name):
    """One NCCL rank: the cold fit (2 eager chunks, a capture, one replay:
    5 host reads) and the warm one (one replay, no capture, one host read)
    equal the eager twin bit for bit; a fit on another V of the same shape
    is a warm one too and equals its eager twin; B3/B4 launches and the
    collectives' calls and bytes are the eager twin's (a one-rank ``seq``
    dimension shifts nothing)."""
    kind = CUDA_FLOWS[name][0]
    out = port_cuda[0][name]
    assert "error" not in out, bytes(out["error"]).decode()
    for fit in ("cold", "warm"):
        _equal_fits(out, fit, "eager", kind)
    _equal_fits(out, "other", "other_eager", kind)
    assert (_counts(out, "cold")["reads"], out["cold_graphs"].tolist()) == (
        5, [1, 1])
    for fit in ("warm", "other"):
        assert (_counts(out, fit)["reads"], _counts(out, fit)["hits"],
                out[f"{fit}_graphs"].tolist()) == (1, 1, [1, 0]), fit
    for fit in ("cold", "warm", "other"):
        eager = "other_eager" if fit == "other" else "eager"
        for k in ("ar_calls", "ar_bytes", "halo_calls", "halo_bytes"):
            assert _counts(out, fit)[k] == _counts(out, eager)[k], (fit, k)
        assert out[f"{fit}_launches"].tolist() == \
            out[f"{eager}_launches"].tolist(), fit
    assert _counts(out, "warm")["halo_calls"] == 0
    assert out["warm_launches"].tolist()[1] == 50  # B4 once an iteration

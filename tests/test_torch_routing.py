"""The model API on a sharded target: ``model.fit`` (``sparse_fit``, the
functional fits) given a ``DTensor`` routes to the port's explicit sharded
or halo fit where the JAX package's ``fit`` routes a sharded array, and
otherwise runs the single-card fit on the gathered target (the declined
path), as GSPMD gives the single-device answer in the JAX package.

The port runs in gloo rank processes on the CPU (``_torch_parallel_child``,
its ``route`` cases): one group of 4 ranks for the whole file, started once
by a module-scoped fixture.  In each rank a spy on the explicit fits shows
which one ran; a routed fit equals that explicit fit bit for bit, a
declined one the port's plain single-card fit of the whole problem.  The
JAX side runs here, on a 2-device, 4-device or 2×2 sub-mesh of the 8
virtual CPU devices: the same model class, the same numpy inputs, ``V``
placed with ``jax.device_put(V, NamedSharding(mesh, P(*spec)))``.
Tolerance: 1e-5 relative to the factor's largest entry after 10
iterations at ``tol=0`` with the same ``n_iter`` (±10 iterations at the
early stop, the PLCA family's raw loop index kept); the Hoyer fit at
``test_torch_hoyer.py``'s 1e-4.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from _torch_parallel_child import run_group  # noqa: E402

RTOL = 1e-5
RTOL_HOYER = 1e-4
ITERS = 10
NMF_BETAS = (1, 0.5, 2)
# the explicit fits the route calls, in the order of the child's ``calls``
SHARDED_NMF, SHARDED_PLCA, HALO_MU, HALO_EM = range(4)
ROWS, TRAILING = ["data", None], [None, None, "seq"]


def _nmf_problem(seed, M=40, K=24, R=4):
    rs = np.random.RandomState(seed)
    return {"V": rs.rand(M, K).astype("f") + 0.01,
            "W": rs.rand(K, R).astype("f") + 0.1,
            "H": rs.rand(M, R).astype("f") + 0.1}


def _deconv_problem(seed, N, C, R, S_out, kernel):
    rs = np.random.RandomState(seed)
    S_in = tuple(s - k + 1 for s, k in zip(S_out, kernel))
    return {"V": rs.rand(N, C, *S_out).astype("f") + 0.01,
            "W": rs.rand(C, R, *kernel).astype("f") + 0.1,
            "H": rs.rand(N, R, *S_in).astype("f") + 0.1}


def _normalized(p, R, seed):
    """A PLCA-family start: the factors normalized as the constructors
    leave them, a random ``Z``."""
    rs = np.random.RandomState(seed + 1000)
    W, H = p["W"], p["H"]
    axes = (0,) + tuple(range(2, W.ndim))
    Z = rs.rand(R).astype("f") + 0.1
    return {"V": p["V"] - 0.01, "W": W / W.sum(axes, keepdims=True),
            "H": H / H.sum(axes, keepdims=True), "Z": Z / Z.sum()}


def _plca_problem(seed, M=40, K=24, R=4):
    return _normalized(_nmf_problem(seed, M, K, R), R, seed)


def _siplca_problem(seed, N, C, R, S_out, kernel):
    return _normalized(_deconv_problem(seed, N, C, R, S_out, kernel), R,
                       seed)


def _nmf_explicit(beta, **kw):
    return dict(fn="sharded_nmf_fit", beta=beta, tol=0, max_iter=ITERS, **kw)


def _halo_explicit(nd, beta, **kw):
    return dict(fn="_sharded_deconv_fit", args=[nd], beta=beta, tol=0,
                max_iter=ITERS, seq_axis="seq", **kw)


def _siplca_explicit(nd, **kw):
    return dict(fn="_sharded_siplca_fit", args=[nd], tol=0, max_iter=ITERS,
                seq_axis="seq", **kw)


def _cases():
    """``{name: (case, inputs, the explicit fit it routes to or None)}``."""
    cases = {}

    def add(name, model, inputs, spec, kw, axes=None, routes=None, **extra):
        axes = axes or ({"seq": 2} if "seq" in spec else {"data": 2})
        case = dict({"name": name, "kind": "route", "model": model,
                     "axes": axes, "spec": spec, "kw": kw}, **extra)
        case.setdefault("single", routes is None)
        cases[name] = (case, inputs, routes)

    its = dict(tol=0, max_iter=ITERS)
    # NMF: rows sharded (and columns over a second mesh dimension)
    for i, beta in enumerate(NMF_BETAS):
        add(f"nmf_b{beta}", "NMF", _nmf_problem(i), ROWS,
            dict(beta=beta, **its), routes=SHARDED_NMF,
            explicit=_nmf_explicit(beta))
    add("nmf_model_b1", "NMF", _nmf_problem(3), ["data", "model"],
        dict(beta=1, **its), axes={"data": 2, "model": 2},
        routes=SHARDED_NMF, explicit=_nmf_explicit(1, model_axis="model"))
    add("nmf_alpha", "NMF", _nmf_problem(4), ROWS,
        dict(beta=1, alpha=0.2, l1_ratio=0.25, **its), routes=SHARDED_NMF,
        explicit=_nmf_explicit(1, l1_reg=0.05, l2_reg=0.15))
    add("nmf_frozen_W", "NMF", _nmf_problem(5), ROWS, dict(beta=0.5, **its),
        trainable={"W": False}, routes=SHARDED_NMF,
        explicit=_nmf_explicit(0.5, _update_W=False))
    add("nmf_verbose", "NMF", _nmf_problem(6), ROWS,
        dict(beta=1, tol=0, max_iter=30, verbose=True), routes=SHARDED_NMF,
        events=True)
    add("nmf_early", "NMF", _nmf_problem(7), ROWS,
        dict(beta=1, tol=1e-3, max_iter=200), routes=SHARDED_NMF)
    # NMFD/NMF2D/NMF3D: the trailing axis sharded over "seq"
    for i, beta in enumerate((1, 2)):
        add(f"nmfd_b{beta}", "NMFD", _deconv_problem(10 + i, 1, 6, 3, (64,),
                                                      (5,)), TRAILING,
            dict(beta=beta, **its), routes=HALO_MU,
            explicit=_halo_explicit(1, beta))
    add("nmf2d_b1", "NMF2D", _deconv_problem(12, 1, 5, 3, (7, 40), (3, 4)),
        [None, None, None, "seq"], dict(beta=1, **its), routes=HALO_MU,
        explicit=_halo_explicit(2, 1))
    add("nmf3d_b1", "NMF3D", _deconv_problem(13, 1, 4, 3, (5, 6, 24),
                                             (2, 3, 3)),
        [None, None, None, None, "seq"], dict(beta=1, **its), routes=HALO_MU,
        explicit=_halo_explicit(3, 1))
    add("nmfd_frozen_H", "NMFD", _deconv_problem(14, 1, 6, 3, (64,), (5,)),
        TRAILING, dict(beta=1, **its), trainable={"H": False},
        routes=HALO_MU, explicit=_halo_explicit(1, 1, update_H=False))
    add("nmfd_verbose", "NMFD", _deconv_problem(15, 2, 6, 3, (64,), (5,)),
        TRAILING, dict(beta=2, tol=0, max_iter=30, verbose=True),
        routes=HALO_MU, events=True)
    # PLCA: rows sharded, on a 1-D mesh and on a 2×2 one replicated over "b"
    add("plca", "PLCA", _plca_problem(20), ROWS,
        dict(W_alpha=1.02, **its), routes=SHARDED_PLCA,
        explicit=dict(fn="sharded_plca_fit", W_alpha=1.02, **its))
    add("plca_ab", "PLCA", _plca_problem(21), ["a", None], dict(its),
        axes={"a": 2, "b": 2}, routes=SHARDED_PLCA,
        explicit=dict(fn="sharded_plca_fit", data_axis="a", **its))
    add("plca_verbose", "PLCA", _plca_problem(22), ROWS,
        dict(tol=0, max_iter=30, verbose=True, W_alpha=1.01),
        routes=SHARDED_PLCA, events=True)
    # the SIPLCA family: L_in 58 in chunks of 31 pads H, under its prior too
    add("siplca", "SIPLCA", _siplca_problem(23, 1, 6, 3, (62,), (5,)),
        TRAILING, dict(H_alpha=1.02, **its), routes=HALO_EM,
        explicit=_siplca_explicit(1, H_alpha=1.02))
    add("siplca2", "SIPLCA2", _siplca_problem(24, 1, 5, 3, (6, 34), (2, 4)),
        [None, None, None, "seq"], dict(its), routes=HALO_EM,
        explicit=_siplca_explicit(2))
    add("siplca_verbose", "SIPLCA", _siplca_problem(25, 1, 8, 3, (56,), (5,)),
        TRAILING, dict(tol=0, max_iter=30, verbose=True, H_alpha=1.05),
        routes=HALO_EM, events=True)
    # declined: layouts the rules refuse, float64, one rank, a PLCA the
    # explicit EM cannot hold, and the Hoyer fit
    add("nmfd_channel", "NMFD", _deconv_problem(30, 1, 6, 3, (64,), (5,)),
        [None, "seq", None], dict(beta=1, **its))
    add("plca_feature", "PLCA", _plca_problem(31), [None, "data"], dict(its))
    add("nmf_columns", "NMF", _nmf_problem(32), [None, "data"],
        dict(beta=1, **its))
    add("nmfd_f64", "NMFD", _deconv_problem(33, 1, 6, 3, (64,), (5,)),
        TRAILING, dict(beta=1, **its), dtype="float64")
    add("nmf_one_rank", "NMF", _nmf_problem(34), ROWS, dict(beta=1, **its),
        axes={"data": 1})
    # JAX places no array unevenly: its side is the whole V on one device
    add("plca_odd_rows", "PLCA", _plca_problem(35, M=41), ROWS, dict(its),
        jax_whole=True)
    add("plca_sub", "PLCASub", _plca_problem(36), ROWS, dict(its))
    add("nmf_hoyer", "NMF", _nmf_problem(37, 40, 30, 5), ROWS,
        dict(beta=2, max_iter=8, sW=0.5), call="sparse_fit")
    add("nmfd_verbose_declined", "NMFD",
        _deconv_problem(38, 1, 6, 3, (64,), (5,)), [None, "seq", None],
        dict(beta=1, tol=0, max_iter=30, verbose=True), events=True,
        single=False)
    # the functional fits equal the model; a second fit continues from the
    # model's own DTensor factors; a plain V then gathers them
    for name, model, prob, spec, kw, routes in (
            ("nmf", "NMF", _nmf_problem(40), ROWS, dict(beta=1, **its),
             SHARDED_NMF),
            ("nmfd", "NMFD", _deconv_problem(41, 1, 6, 3, (64,), (5,)),
             TRAILING, dict(beta=1, **its), HALO_MU),
            ("plca", "PLCA", _plca_problem(42), ROWS, dict(its),
             SHARDED_PLCA)):
        add(f"functional_{name}", model, prob, spec, kw, routes=routes,
            call="functional")
    for name, model, prob, spec, routes in (
            ("nmf", "NMF", _nmf_problem(43), ROWS, SHARDED_NMF),
            ("nmfd", "NMFD", _deconv_problem(44, 1, 6, 3, (64,), (5,)),
             TRAILING, HALO_MU),
            ("nmf_declined", "NMF", _nmf_problem(45), [None, "data"], None)):
        add(f"twice_{name}", model, prob, spec, dict(beta=1, **its),
            routes=routes, call="twice", single=False)
    # declined, then routed: the replicated factors go in as full arrays
    add("twice_declined_then_routed", "NMF", _nmf_problem(50),
        [None, "data"], dict(beta=1, **its), routes=SHARDED_NMF,
        call="twice", single=False, spec2=ROWS)
    add("then_plain", "NMF", _nmf_problem(46), ROWS, dict(beta=1, **its),
        routes=SHARDED_NMF, call="then_plain")
    # the target's checks, on one rank's block alone: every rank raises
    negative = _nmf_problem(47)
    negative["V"][-1, 0] = -1.0
    add("raises_negative", "NMF", negative, ROWS, dict(beta=1, **its),
        routes=SHARDED_NMF, call="raises")
    add("raises_zero", "NMFD", dict(_deconv_problem(49, 1, 6, 3, (64,), (5,)),
                                    V=np.zeros((1, 6, 64), "f") + 0.5),
        TRAILING, dict(beta=0, **its), routes=HALO_MU, call="raises")
    cases["raises_zero"][1]["V"][0, 0, -1] = 0.0
    return cases


CASES = _cases()
ROUTED = [n for n, (c, _, r) in CASES.items()
          if r is not None and c.get("call", "fit") == "fit"]
DECLINED = [n for n, (c, _, r) in CASES.items()
            if r is None and c["single"]]


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side (JAX on the CPU)."""
    return pytest.importorskip("jax")


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Every case through 4 gloo ranks, once: ``[rank results]``."""
    arrays = {f"{name}:{k}": v for name, (_, inp, _) in CASES.items()
              for k, v in inp.items()}
    return run_group(tmp_path_factory.mktemp("torch_routing"), 4,
                     [c for c, _, _ in CASES.values()], arrays)


def _ranks(name):
    return int(np.prod(list(CASES[name][0]["axes"].values())))


def _got(port, name):
    """Rank 0's results of ``name``, after checking that every rank of the
    mesh returned the same."""
    out = port[0][name]
    for r in range(1, _ranks(name)):
        for k, v in out.items():
            if k not in ("events",):
                np.testing.assert_array_equal(port[r][name][k], v, err_msg=k)
    return out


def _names(name):
    return ("W", "H", "Z") if "PLCA" in CASES[name][0]["model"] else ("W",
                                                                     "H")


def _close(got, ref, rtol=RTOL, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= rtol, (what, err)


def _jax_fit(name, twice=False):
    """The JAX package's model fit on ``V`` placed as the case's ``spec``
    on a sub-mesh of the case's axes: ``(factors, fit's return, events)``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from pytorch_nmf_tpu.models import nmf as jnmf, plca as jplca
    from pytorch_nmf_tpu.ops import solver
    from pytorch_nmf_tpu.parallel import make_mesh

    case, inp, _ = CASES[name]
    model, kw = case["model"], dict(case["kw"])
    names = _names(name)
    dtype = case.get("dtype", "float32")
    if model == "PLCASub":
        class PLCASub(jplca.PLCA):
            @staticmethod
            def reconstruct(H, W, Z):
                return H @ (W * Z).T
        cls = PLCASub
    else:
        cls = getattr(jplca if "PLCA" in model else jnmf, model)
    events = []
    solver.push_progress_handler(lambda c, loss, e: events.append(
        (c, loss, np.nan if e is None else float(e))))
    try:
        with jax.enable_x64(dtype == "float64"):
            m = cls(**{k: inp[k].astype(dtype) for k in names},
                    **{f"trainable_{k}": v
                       for k, v in case.get("trainable", {}).items()})
            mesh = make_mesh(case["axes"], jax.devices()[:_ranks(name)])
            V = jnp.asarray(inp["V"].astype(dtype))
            if not case.get("jax_whole"):
                V = jax.device_put(V, NamedSharding(mesh, P(*case["spec"])))
            fit = m.sparse_fit if case.get("call") == "sparse_fit" else m.fit
            out = fit(V, **kw)
            if twice:
                if "spec2" in case:
                    V = jax.device_put(V, NamedSharding(mesh,
                                                        P(*case["spec2"])))
                out = m.fit(V, **kw)
            factors = {k: np.asarray(getattr(m, k).data) for k in names}
    finally:
        solver.pop_progress_handler()
    return factors, out, events


def _n_iter(out):
    return int(out[0] if isinstance(out, tuple) else out)


@pytest.mark.parametrize("name", ROUTED)
def test_routed_fit_takes_the_explicit_fit(port, name):
    """The spy saw the one explicit fit the layout routes to, and the
    routed fit equals that fit called directly, bit for bit."""
    got = _got(port, name)
    want = [0, 0, 0, 0]
    want[CASES[name][2]] = 1
    assert [int(c) for c in got["calls"]] == want
    if "explicit" in CASES[name][0]:
        assert int(got["n_iter"]) == int(got["explicit_n_iter"])
        for k in _names(name):
            np.testing.assert_array_equal(got[k], got[f"explicit_{k}"],
                                          err_msg=k)


@pytest.mark.parametrize("name", ROUTED)
def test_routed_fit_matches_jax_routed_fit(jx, port, name):
    got = _got(port, name)
    factors, out, _ = _jax_fit(name)
    n, n_ref = int(got["n_iter"]), _n_iter(out)
    if name == "nmf_early":
        assert abs(n - n_ref) <= 10 and n < 200
        rtol = 1e-3 if n != n_ref else RTOL
    else:
        assert n == n_ref
        rtol = RTOL
    if "norm" in got:
        _close(got["norm"], float(out[1]), what="norm")
    for k in _names(name):
        _close(got[k], factors[k], rtol=rtol, what=k)


@pytest.mark.parametrize("name", ["nmf_frozen_W", "nmfd_frozen_H"])
def test_frozen_factor_stays_and_keeps_requires_grad(port, name):
    got = _got(port, name)
    frozen = next(iter(CASES[name][0]["trainable"]))
    np.testing.assert_array_equal(got[frozen], CASES[name][1][frozen])
    assert not bool(got[f"{frozen}_requires_grad"])
    other = "H" if frozen == "W" else "W"
    assert bool(got[f"{other}_requires_grad"])


@pytest.mark.parametrize("name", ["nmf_verbose", "nmfd_verbose",
                                  "plca_verbose", "siplca_verbose",
                                  "nmfd_verbose_declined"])
def test_verbose_fit_reports_each_chunk_from_rank_zero(jx, port, name):
    """One event a chunk, in order, on rank 0 alone, the losses (and the
    PLCA family's log-probabilities) those of JAX's verbose fit on the same
    sharding."""
    got = port[0][name]
    events = got["events"]
    n = int(got["n_iter"]) + (1 if "PLCA" in CASES[name][0]["model"] else 0)
    assert [int(c) for c in events[:, 0]] == list(range(1, n // 10 + 1))
    assert np.isfinite(events[:, 1]).all()
    for r in range(1, _ranks(name)):
        assert len(port[r][name]["events"]) == 0
    _, _, ref = _jax_fit(name)
    ref = np.array(ref, dtype=np.float64).reshape(-1, 3)
    assert len(ref) == len(events)
    np.testing.assert_allclose(events[:, 1], ref[:, 1], rtol=1e-4)
    if "PLCA" in CASES[name][0]["model"]:
        np.testing.assert_allclose(events[:, 2], ref[:, 2], rtol=1e-4)


def test_halo_route_takes_the_local_block(port):
    """Where DTensor's split of ``L_out`` is the halo chunks', the routed
    halo fit reads each rank's block of V as it is: no gather of V (the
    factors' are gathered, the layouts differ)."""
    for name in ("nmfd_b1", "nmf2d_b1", "nmf3d_b1", "siplca", "siplca2"):
        got = _got(port, name)
        assert int(got["v_gathers"]) == 0, name
        assert int(got["gathers"]) >= 2, name


@pytest.mark.parametrize("name", DECLINED)
def test_declined_fit_is_the_single_card_fit(port, name):
    """No explicit fit ran; the factors equal the port's plain single-card
    fit bit for bit and come back replicated DTensors, as ``nn.Parameter``\\ s
    that keep ``requires_grad``."""
    got = _got(port, name)
    assert [int(c) for c in got["calls"]] == [0, 0, 0, 0]
    assert int(got["n_iter"]) == int(got["single_n_iter"])
    for k in _names(name):
        np.testing.assert_array_equal(got[k], got[f"single_{k}"], err_msg=k)
        placed = bytes(got[f"{k}_placements"]).decode()
        assert placed == "[" + ", ".join(
            ["Replicate()"] * len(CASES[name][0]["axes"])) + "]", placed
        assert bool(got[f"{k}_is_param"]) and bool(got[f"{k}_requires_grad"])


@pytest.mark.parametrize("name", DECLINED)
def test_declined_fit_matches_jax_on_the_same_sharding(jx, port, name):
    got = _got(port, name)
    factors, out, _ = _jax_fit(name)
    assert int(got["n_iter"]) == _n_iter(out)
    rtol = RTOL_HOYER if name == "nmf_hoyer" else RTOL
    for k in _names(name):
        _close(got[k], factors[k], rtol=rtol, what=k)


def test_float64_declines_and_stays_float64(port):
    got = _got(port, "nmfd_f64")
    assert got["W"].dtype == got["H"].dtype == np.float64


@pytest.mark.parametrize("name", ROUTED)
def test_routed_factors_are_dtensor_parameters(port, name):
    """After a routed fit the factors are ``nn.Parameter``\\ s holding
    DTensors (H sharded as the explicit fit returns it), ``requires_grad``
    kept; ``model()`` gathers them and equals the forward of a plain model
    holding the same values."""
    got = _got(port, name)
    trainable = CASES[name][0].get("trainable", {})
    for k in _names(name):
        assert bool(got[f"{k}_is_param"])
        assert bool(got[f"{k}_requires_grad"]) == trainable.get(k, True)
    assert "Shard" in bytes(got["H_placements"]).decode()
    assert not bool(got["forward_dtensor"])
    assert float(got["forward_err"]) <= 1e-5


@pytest.mark.parametrize("name", ["functional_nmf", "functional_nmfd",
                                  "functional_plca"])
def test_functional_fit_on_a_dtensor_equals_the_model(jx, port, name):
    got = _got(port, name)
    want = [0, 0, 0, 0]
    want[CASES[name][2]] = 2  # the functional fit, then the model's
    assert [int(c) for c in got["calls"]] == want
    factors, out, _ = _jax_fit(name)
    assert int(got["n_iter"]) == _n_iter(out)
    for k in _names(name):
        np.testing.assert_array_equal(got[k], got[f"model_{k}"], err_msg=k)
        _close(got[k], factors[k], what=k)


@pytest.mark.parametrize("name", ["twice_nmf", "twice_nmfd",
                                  "twice_nmf_declined",
                                  "twice_declined_then_routed"])
def test_second_fit_continues_from_the_dtensor_factors(jx, port, name):
    got = _got(port, name)
    routes = CASES[name][2]
    want = [0, 0, 0, 0]
    if routes is not None:  # the declined first fit calls none
        want[routes] = 1 if "spec2" in CASES[name][0] else 2
    assert [int(c) for c in got["calls"]] == want
    factors, out, _ = _jax_fit(name, twice=True)
    assert int(got["n_iter"]) == _n_iter(out)
    for k in _names(name):
        _close(got[k], factors[k], what=k)


def test_plain_target_gathers_dtensor_factors(port):
    """A plain V given to a model whose factors are DTensors gathers them
    and fits on one device, leaving plain parameters: the same as a fit of
    the gathered values."""
    got = _got(port, "then_plain")
    assert not bool(got["plain_dtensor"])
    for k in ("W", "H"):
        assert np.isfinite(got[f"plain_{k}"]).all()
        assert not np.array_equal(got[f"plain_{k}"], got[k])


def test_plain_target_after_dtensor_fit_matches_jax(jx, port):
    """The same two fits in the JAX package: the sharded V, then the whole
    V as one array."""
    import jax.numpy as jnp

    got = _got(port, "then_plain")
    factors, _, _ = _jax_fit("then_plain")
    from pytorch_nmf_tpu.models.nmf import NMF

    inp = CASES["then_plain"][1]
    m = NMF(W=factors["W"], H=factors["H"])
    m.fit(jnp.asarray(inp["V"]), **CASES["then_plain"][0]["kw"])
    for k in ("W", "H"):
        _close(got[f"plain_{k}"], np.asarray(getattr(m, k).data), what=k)


@pytest.mark.parametrize("name, message", [
    ("raises_negative", "non-negative"), ("raises_zero", "beta <= 0")])
def test_target_checks_raise_on_every_rank(port, name, message):
    """A negative entry, or a zero at β ≤ 0, in the last rank's block
    alone: the ranks check their blocks together, and every one raises
    the single-card fit's ``ValueError`` before any fit starts."""
    for r in range(_ranks(name)):
        got = port[r][name]
        assert message in bytes(got["raised"]).decode(), r
        assert [int(c) for c in got["calls"]] == [0, 0, 0, 0]


def test_capture_stream_is_not_a_communicator_stream(monkeypatch):
    """C15: a compiled fit captures on a stream of its own, taken from the
    high-priority pool; ProcessGroupNCCL takes its streams from the
    default-priority pool, and a capture on a communicator's stream crashed
    at ``capture_end`` (the one-rank NCCL group of ``chip_smoke.py``, once
    earlier fits had moved the pool's round robin onto it).  A stand-in
    ``torch.cuda.Stream`` records what the instance asked for."""
    import torch

    from pytorch_nmf_tpu_torch.ops import graphs

    asked = []
    monkeypatch.setattr(torch.cuda, "Stream",
                        lambda *args, **kw: asked.append((args, kw)))
    graphs._Graphs([lambda: None], None, torch.device("cuda", 0), "",
                   conditional=True)
    assert asked == [((torch.device("cuda", 0),), {"priority": -1})]

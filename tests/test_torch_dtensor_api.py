"""The user API past ``model.fit`` on a sharded target: the metrics, the
checkpoint module (``save``/``load``, the checkpointed fits, the sharded
pair ``save_sharded``/``load_sharded``) and the trainers (``BetaMu``,
``SparsityProj``) given a ``DTensor`` target or the ``DTensor`` factors a
routed fit leaves, as the JAX package's take a sharded array.

The port runs in gloo rank processes on the CPU (``_torch_parallel_child``,
its ``api`` cases): two ranks, two run groups for the whole file, started
once by a module-scoped fixture; the second group resumes the checkpoint
directories the first wrote, and those the JAX package wrote between
them.  The JAX side runs here on 2 of the 8 virtual CPU devices, ``V``
placed with ``NamedSharding(mesh, P("data"))`` for the NMF and PLCA rows and
``P(None, None, "seq")`` for NMFD, on the same numpy inputs.  Tolerance:
1e-5 relative to the largest entry; every rank's result the same; a
resumed fit equal to the uninterrupted one bit for bit.
"""

import copy
import os
import shutil

import numpy as np
import pytest

pytest.importorskip("torch")

from _torch_parallel_child import run_group  # noqa: E402

RTOL = 1e-5
WORLD = 2
FIT_ITERS = 5  # a routed fit before the factors are DTensors
CK_FIRST, CK_ALL, CK_EVERY = 10, 20, 5  # the checkpointed runs
NEG_INF = float("-inf")
ROWS, TRAILING = ["data", None], [None, None, "seq"]
BETAS = (0.5, 1.5, 3)  # beta_div's generic branch, beside the three closed forms


def _nmf_problem(seed, M=40, K=24, R=4):
    rs = np.random.RandomState(seed)
    return {"V": rs.rand(M, K).astype("f") + 0.01,
            "W": rs.rand(K, R).astype("f") + 0.1,
            "H": rs.rand(M, R).astype("f") + 0.1,
            "X": rs.rand(M, K).astype("f") + 0.05}


def _nmfd_problem(seed, C=6, R=3, L=64, T=5):
    rs = np.random.RandomState(seed)
    return {"V": rs.rand(1, C, L).astype("f") + 0.01,
            "W": rs.rand(C, R, T).astype("f") + 0.1,
            "H": rs.rand(1, R, L - T + 1).astype("f") + 0.1,
            "X": rs.rand(1, C, L).astype("f") + 0.05}


def _plca_problem(seed, M=40, K=24, R=4):
    rs = np.random.RandomState(seed)
    W, H, Z = (rs.rand(*s).astype("f") + 0.1 for s in ((K, R), (M, R), (R,)))
    return {"V": rs.rand(M, K).astype("f"), "W": W / W.sum(0),
            "H": H / H.sum(0), "Z": Z / Z.sum()}


def _one_over_L(H):
    """``SparsityProj``'s step for W at β=2: ``1 / ‖HᵀH‖₂``, the inverse of
    the gradient's Lipschitz constant.  From the default step (1) the
    constrained NMF diverges in both packages (its loss grows past 1e8 in
    5 steps), and there they already differ by 1e-4 on a plain target."""
    return float(1.0 / np.linalg.norm(H.T.astype(np.float64) @ H, 2))


def _cases():
    """``{name: (case, inputs)}``; paths are relative to the run's root
    (:func:`_placed`)."""
    cases = {}

    def add(name, model, inputs, **case):
        spec = TRAILING if model == "NMFD" else ROWS
        axes = {"seq": WORLD} if model == "NMFD" else {"data": WORLD}
        cases[name] = (dict({"name": name, "kind": "api", "model": model,
                             "axes": axes, "spec": spec}, **case), inputs)

    fit = dict(beta=1, tol=0)
    add("metrics_nmf", "NMF", _nmf_problem(0), call="metrics", betas=BETAS,
        fit_iters=FIT_ITERS, fit_beta=0.5, kw=fit)
    add("metrics_nmfd", "NMFD", _nmfd_problem(1), call="metrics",
        betas=BETAS, fit_iters=FIT_ITERS, fit_beta=0.5, kw=fit)
    for name, model, prob, kw in (
            ("nmf_b1", "NMF", _nmf_problem(2), dict(beta=1)),
            ("nmf_b0.5", "NMF", _nmf_problem(3), dict(beta=0.5)),
            ("nmfd_b1", "NMFD", _nmfd_problem(4), dict(beta=1)),
            ("plca", "PLCA", _plca_problem(5), {})):
        kw = dict(kw, tol=NEG_INF, every=CK_EVERY)
        # the first run group: one session of CK_FIRST iterations, and the
        # uninterrupted run; the second: the session resumed, and the JAX
        # package's first session resumed
        add(f"ckpt_{name}", model, prob, call="ckpt", kw=kw,
            dirs=[(f"{name}/session", CK_FIRST), (f"{name}/whole", CK_ALL)])
        add(f"resume_{name}", model, prob, call="ckpt", kw=kw, group=2,
            dirs=[(f"{name}/session", CK_ALL), (f"{name}/jax", CK_ALL)])
    for call, ext in (("save_load", ".npz"), ("dcp", "")):
        add(f"{call}_nmf", "NMF", _nmf_problem(6), call=call,
            fit_iters=FIT_ITERS, kw=fit, path=f"{call}_nmf{ext}")
        add(f"{call}_nmfd", "NMFD", _nmfd_problem(7), call=call,
            fit_iters=FIT_ITERS, kw=fit, path=f"{call}_nmfd{ext}")
    for params, target in (("plain", "dtensor"), ("dtensor", "dtensor"),
                           ("dtensor", "plain")):
        for jit in (False, True):
            for steps in (1, 5):
                tag = f"{params}_params_{target}_V_{'jit' if jit else 'eager'}" \
                      f"_{steps}"
                common = dict(params=params, target=target, jit=jit,
                              steps=steps, fit_iters=FIT_ITERS, kw=fit)
                add(f"betamu_{tag}", "NMF", _nmf_problem(8), call="betamu",
                    beta=1, **common)
                prob = _nmf_problem(9)
                add(f"sparsity_{tag}", "NMF", prob, call="sparsity",
                    attr="W", sparsity=0.5, lr=_one_over_L(prob["H"]),
                    **common)
    for jit in (False, True):
        add(f"betamu_nmfd_{'jit' if jit else 'eager'}", "NMFD",
            _nmfd_problem(10), call="betamu", beta=0.5, params="dtensor",
            target="dtensor", jit=jit, steps=5, fit_iters=FIT_ITERS, kw=fit)
    add("teardown", "NMF", _nmf_problem(12), call="teardown")
    return cases


CASES = _cases()
TRAINERS = [n for n, (c, _) in CASES.items()
            if c["call"] in ("betamu", "sparsity")]
CKPT = [n[len("ckpt_"):] for n in CASES if n.startswith("ckpt_")]


def _placed(case, root):
    """``case`` with its paths under ``root``."""
    case = copy.deepcopy(case)
    if "dirs" in case:
        case["dirs"] = [(os.path.join(root, d), n) for d, n in case["dirs"]]
    if "path" in case:
        case["path"] = os.path.join(root, case["path"])
    return case


def _names(name):
    return ("W", "H", "Z") if CASES[name][0]["model"] == "PLCA" else ("W", "H")


def _close(got, ref, rtol=RTOL, what=""):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref,
                                                             dtype=np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= rtol, (what, err)


# ---------------------------------------------------------------- JAX side
class _Jax:
    """The JAX package on 2 of the 8 CPU devices, and its results by case
    (computed once)."""

    def __init__(self):
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        from pytorch_nmf_tpu import metrics, trainer
        from pytorch_nmf_tpu.models import nmf, plca
        from pytorch_nmf_tpu.parallel import make_mesh
        from pytorch_nmf_tpu.utils import checkpoint

        self.jax, self.jnp, self.metrics, self.trainer = jax, jnp, metrics, \
            trainer
        self.checkpoint, self.nmf, self.plca = checkpoint, nmf, plca
        self.NamedSharding, self.P, self.make_mesh = NamedSharding, P, \
            make_mesh
        self.memo = {}

    def mesh(self, case):
        return self.make_mesh(case["axes"], self.jax.devices()[:WORLD])

    def V(self, name, plain=False):
        case, inp = CASES[name]
        V = self.jnp.asarray(inp["V"])
        if plain:
            return V
        return self.jax.device_put(V, self.NamedSharding(self.mesh(case),
                                                         self.P(*case["spec"])))

    def model(self, name):
        case, inp = CASES[name]
        mod = self.plca if case["model"] == "PLCA" else self.nmf
        return getattr(mod, case["model"])(**{k: inp[k] for k in _names(name)})

    def routed(self, name, iters=FIT_ITERS):
        m = self.model(name)
        m.fit(self.V(name), **dict(CASES[name][0]["kw"], max_iter=iters))
        return m

    def factors(self, m, names):
        return {k: np.asarray(getattr(m, k).data) for k in names}

    def checkpointed(self, name, directory, max_iter):
        """The JAX package's checkpointed fit of case ``name`` on the
        sharded V (into ``directory``): ``(factors, n, norm or None)``."""
        case, _ = CASES[name]
        m = self.model(name)
        if case["model"] == "PLCA":
            n, norm = self.checkpoint.checkpointed_plca_fit(
                m, self.V(name), max_iter=max_iter, directory=directory,
                **case["kw"])
        else:
            n, norm = self.checkpoint.checkpointed_fit(
                m, self.V(name), max_iter=max_iter, directory=directory,
                **case["kw"]), None
        return self.factors(m, _names(name)), n, norm

    def trainer_run(self, name):
        """The case's trainer steps in the JAX package: factors, grads,
        loss and step size."""
        if name in self.memo:
            return self.memo[name]
        case, _ = CASES[name]
        m = self.routed(name) if case["params"] == "dtensor" else \
            self.model(name)
        V = self.V(name, plain=case["target"] == "plain")
        if case["call"] == "betamu":
            tr = self.trainer.BetaMu(m.parameters(), case["beta"],
                                     jit_compile=case["jit"])

            def closure():
                return V, m()
        else:
            tr = self.trainer.SparsityProj(
                [{"params": [getattr(m, case["attr"])], "lr": case["lr"]}],
                case["sparsity"], max_iter=5, jit_compile=case["jit"])

            def closure():
                return self.metrics.beta_div(m(), V, 2)
        loss = None
        for _ in range(case["steps"]):
            loss = tr.step(closure)
        out = self.factors(m, _names(name))
        for k in _names(name):
            g = getattr(m, k).grad
            if g is not None:
                out[f"grad_{k}"] = np.asarray(g)
        if case["call"] == "sparsity":
            out.update(loss=float(loss), lr=float(tr.param_groups[0]["lr"]))
        self.memo[name] = out
        return out


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    return _Jax()


@pytest.fixture(scope="module")
def run(tmp_path_factory, jx):
    """Every case through 2 gloo ranks: the first run group, then the JAX
    package's first sessions into ``{name}/jax``, then the second group.
    Returns ``(root, [rank results])``."""
    root = str(tmp_path_factory.mktemp("torch_dtensor_api"))
    arrays = {f"{name}:{k}": v for name, (_, inp) in CASES.items()
              for k, v in inp.items()}
    groups = {1: [], 2: []}
    for case, _ in CASES.values():
        groups[case.get("group", 1)].append(_placed(case, root))
    for g in ("g1", "g2"):
        os.makedirs(os.path.join(root, g))
    first = run_group(os.path.join(root, "g1"), WORLD, groups[1], arrays)
    for name in CKPT:
        jx.checkpointed(f"ckpt_{name}", os.path.join(root, name, "jax"),
                        CK_FIRST)
        # the JAX package resumes a copy of the port's first session
        shutil.copytree(os.path.join(root, name, "session"),
                        os.path.join(root, name, "port_for_jax"))
    second = run_group(os.path.join(root, "g2"), WORLD, groups[2], arrays)
    return root, [dict(a, **b) for a, b in zip(first, second)]


def _got(run, name):
    """Rank 0's results of ``name``, after checking that every rank returned
    the same."""
    out = run[1][0][name]
    for r in range(1, WORLD):
        for k, v in out.items():
            np.testing.assert_array_equal(run[1][r][name][k], v, err_msg=k)
    return out


# ---------------------------------------------------------------- metrics
@pytest.mark.parametrize("name", ["metrics_nmf", "metrics_nmfd"])
def test_metrics_on_a_dtensor_target_match_jax(jx, run, name):
    """The five metrics of a plain input against the DTensor target, and
    their gradients in the input (whole on every rank), against the JAX
    metrics and ``jax.grad`` on the sharded array."""
    got = _got(run, name)
    m, V = jx.metrics, jx.V(name)
    X = jx.jnp.asarray(CASES[name][1]["X"])
    fns = [m.kl_div, m.euclidean, m.is_div] + [
        (lambda i, t, b=b: m.beta_div(i, t, b)) for b in BETAS]
    for i, f in enumerate(fns):
        _close(got["values"][i], float(f(X, V)), what=f"value {i}")
        _close(got["grads"][i], jx.jax.grad(lambda x: f(x, V))(X),
               what=f"grad {i}")


@pytest.mark.parametrize("name", ["metrics_nmf", "metrics_nmfd"])
def test_metrics_of_two_dtensors_match_jax(jx, run, name):
    got = _got(run, name)
    m, V = jx.metrics, jx.V(name)
    X = jx.jnp.asarray(CASES[name][1]["X"])
    fns = [m.kl_div, m.euclidean, m.is_div] + [
        (lambda i, t, b=b: m.beta_div(i, t, b)) for b in BETAS]
    for i, f in enumerate(fns):
        _close(got["both"][i], float(f(X, V)), what=f"both {i}")


@pytest.mark.parametrize("name", ["metrics_nmf", "metrics_nmfd"])
def test_sparseness_of_a_dtensor_factor_matches_jax(jx, run, name):
    got = _got(run, name)
    case, inp = CASES[name]
    H = jx.jax.device_put(jx.jnp.asarray(inp["H"]), jx.NamedSharding(
        jx.mesh(case), jx.P(*case["spec"])))
    _close(got["sparseness"], float(jx.metrics.sparseness(H)))


@pytest.mark.parametrize("name", ["metrics_nmf", "metrics_nmfd"])
def test_loss_of_the_routed_model_and_its_factor_gradients(jx, run, name):
    """``beta_div(model(), V)`` after a routed fit, and its gradients in the
    DTensor factors (through ``model()``'s gather), against the JAX model
    fitted on the sharded V and ``jax.grad`` in its sharded factors."""
    got = _got(run, name)
    case, _ = CASES[name]
    m = jx.routed(name)
    for k in ("W", "H"):
        _close(got[f"fit_{k}"], np.asarray(getattr(m, k).data), what=k)
    V, cls = jx.V(name), type(m)

    def loss(W, H):
        return jx.metrics.beta_div(cls.reconstruct(H, W), V, case["fit_beta"])

    _close(got["fit_value"], float(loss(m.W.data, m.H.data)))
    gW, gH = jx.jax.grad(loss, argnums=(0, 1))(m.W.data, m.H.data)
    _close(got["fit_grad_W"], gW, what="grad W")
    _close(got["fit_grad_H"], gH, what="grad H")


# ------------------------------------------------------ checkpointed fits
@pytest.mark.parametrize("name", CKPT)
def test_checkpointed_fit_on_a_dtensor_target_matches_jax(jx, run, name):
    got = _got(run, f"ckpt_{name}")
    ref, n, norm = jx.checkpointed(
        f"ckpt_{name}", os.path.join(run[0], name, "jax_whole"), CK_ALL)
    assert int(got["1_n_iter"]) == n
    if norm is not None:
        _close(got["1_norm"], float(norm), what="norm")
    for k in _names(f"ckpt_{name}"):
        _close(got[f"1_{k}"], ref[k], what=k)


@pytest.mark.parametrize("name", CKPT)
def test_resumed_checkpointed_fit_is_the_uninterrupted_fit(run, name):
    """A second run group (new processes, new models) resumes the first
    group's session: bit for bit the uninterrupted fit, and one file a
    checkpoint, written by rank 0 alone (``keep`` 2)."""
    whole, resumed = _got(run, f"ckpt_{name}"), _got(run, f"resume_{name}")
    assert int(whole["0_n_iter"]) == CK_FIRST
    assert int(resumed["0_n_iter"]) == CK_ALL == int(whole["1_n_iter"])
    for k in _names(f"ckpt_{name}"):
        np.testing.assert_array_equal(resumed[f"0_{k}"], whole[f"1_{k}"])
    files = sorted(os.listdir(os.path.join(run[0], name, "session")))
    assert files == [f"ckpt_{CK_ALL - CK_EVERY:08d}.npz",
                     f"ckpt_{CK_ALL:08d}.npz"]


@pytest.mark.parametrize("name", CKPT)
def test_port_directory_resumed_by_jax(jx, run, name):
    """The JAX package resumes the directory the port's two ranks wrote
    (on the sharded V) and ends where its own uninterrupted fit ends."""
    ref, _, _ = jx.checkpointed(
        f"ckpt_{name}", os.path.join(run[0], name, "jax_whole2"), CK_ALL)
    got, n, _ = jx.checkpointed(
        f"ckpt_{name}", os.path.join(run[0], name, "port_for_jax"), CK_ALL)
    assert n == CK_ALL
    for k in _names(f"ckpt_{name}"):
        _close(got[k], ref[k], what=k)


@pytest.mark.parametrize("name", CKPT)
def test_jax_directory_resumed_by_the_port(jx, run, name):
    resumed = _got(run, f"resume_{name}")
    ref, _, _ = jx.checkpointed(
        f"ckpt_{name}", os.path.join(run[0], name, "jax_whole3"), CK_ALL)
    assert int(resumed["1_n_iter"]) == CK_ALL
    for k in _names(f"ckpt_{name}"):
        _close(resumed[f"1_{k}"], ref[k], what=k)


# ------------------------------------------------------------- save / load
@pytest.mark.parametrize("name", ["save_load_nmf", "save_load_nmfd"])
def test_save_of_dtensor_factors_is_the_whole_array(jx, run, name):
    """``save`` after a routed fit writes the whole factors (rank 0 alone),
    as the JAX package's save of its sharded factors does."""
    got = _got(run, name)
    path = os.path.join(run[0], CASES[name][0]["path"])
    ref = jx.routed(name)
    with np.load(path) as f:
        assert sorted(f.files) == ["H", "W"]
        for k in ("W", "H"):
            np.testing.assert_array_equal(f[k], got[k])
            _close(f[k], np.asarray(getattr(ref, k).data), what=k)


@pytest.mark.parametrize("name", ["save_load_nmf", "save_load_nmfd"])
def test_load_into_dtensor_factors(run, name):
    """``load(path, model)`` and ``load_state_dict`` of the whole values put
    each rank's block into the DTensor factors, placements and
    ``requires_grad`` kept; ``load(path)`` gives the whole values."""
    got = _got(run, name)
    assert bool(got["load_returns_model"]) and bool(got["load_equal"])
    assert bool(got["state_equal"]) and bool(got["mapping_equal"])


@pytest.mark.parametrize("name", ["save_load_nmf", "save_load_nmfd"])
def test_port_file_loads_into_the_jax_sharded_model(jx, run, name):
    path = os.path.join(run[0], CASES[name][0]["path"])
    m = jx.routed(name, iters=1)
    jx.checkpoint.load(path, m)
    got = _got(run, name)
    for k in ("W", "H"):
        np.testing.assert_array_equal(np.asarray(getattr(m, k).data), got[k])


@pytest.mark.parametrize("name", ["dcp_nmf", "dcp_nmfd"])
def test_sharded_checkpoint_round_trips_bit_for_bit(run, name):
    """``save_sharded``/``load_sharded`` of the routed DTensor factors: each
    rank writes its own blocks (a file a rank, beside DCP's metadata); back
    into a routed model bit for bit with its placements, and whole without
    a model; a plain value beside them comes back too."""
    got = _got(run, name)
    assert bool(got["load_returns_model"]) and bool(got["load_equal"])
    assert bool(got["mapping_equal"]) and bool(got["plain_equal"])
    files = bytes(got["files"]).decode().split()
    assert files == [".metadata"] + [f"__{r}_0.distcp" for r in range(WORLD)]


@pytest.mark.parametrize("name", ["dcp_nmf", "dcp_nmfd"])
def test_sharded_checkpoint_matches_jax_orbax_round_trip(jx, run, name):
    """The JAX package's ``save_orbax``/``load_orbax`` of the same routed
    factors (sharded) round-trips them as the port's pair does, and the two
    packages' factors agree."""
    pytest.importorskip("orbax.checkpoint")
    got = _got(run, name)
    m = jx.routed(name)
    path = os.path.join(run[0], name + "_orbax")
    jx.checkpoint.save_orbax(path, m)
    back = jx.routed(name, iters=1)
    jx.checkpoint.load_orbax(path, back)
    for k in ("W", "H"):
        np.testing.assert_array_equal(np.asarray(getattr(back, k).data),
                                      np.asarray(getattr(m, k).data))
        _close(got[k], np.asarray(getattr(back, k).data), what=k)


def test_sharded_checkpoint_without_a_process_group(tmp_path):
    """As the JAX pair runs on one device: no process group, plain
    factors."""
    import torch
    import torch.distributed as dist

    from pytorch_nmf_tpu_torch.nmf import NMF
    from pytorch_nmf_tpu_torch.utils import checkpoint

    assert not dist.is_initialized()
    p = _nmf_problem(11)
    m = NMF(W=p["W"], H=p["H"], device="cpu")
    m.fit(torch.from_numpy(p["V"]), max_iter=5)
    checkpoint.save_sharded(str(tmp_path / "ck"), m)
    back = NMF(W=p["W"], H=p["H"], device="cpu")
    assert checkpoint.load_sharded(str(tmp_path / "ck"), back) is back
    state = checkpoint.load_sharded(str(tmp_path / "ck"))
    for k in ("W", "H"):
        assert torch.equal(getattr(back, k), getattr(m, k))
        assert torch.equal(state[k], getattr(m, k).detach())


# ---------------------------------------------------------------- trainers
@pytest.mark.parametrize("name", TRAINERS)
def test_trainer_steps_match_jax(jx, run, name):
    """``BetaMu`` / ``SparsityProj`` steps on a DTensor target (or the whole
    V) with plain or DTensor factors, eager and compiled: the factors,
    their gradients, ``SparsityProj``'s loss and step size against the
    JAX package's steps on the sharded array (or factors)."""
    got, ref = _got(run, name), jx.trainer_run(name)
    case, _ = CASES[name]
    for k in _names(name):
        _close(got[k], ref[k], what=k)
        assert (f"grad_{k}" in got) == (f"grad_{k}" in ref), k
        if f"grad_{k}" in ref:
            _close(got[f"grad_{k}"], ref[f"grad_{k}"], what=f"grad {k}")
    if case["call"] == "sparsity":
        _close(got["loss"], ref["loss"], what="loss")
        assert got["lr"] == pytest.approx(ref["lr"], rel=1e-6)
    assert bool(got["dtensor_params"]) == (case["params"] == "dtensor")


def test_trainer_steps_on_a_dtensor_target_equal_the_whole_target(run):
    """The same steps on the DTensor V and on the whole V, from the same
    DTensor factors: the same factors within float32 reordering (the raw
    pair summed over the ranks against computed whole)."""
    for call in ("betamu", "sparsity"):
        for jit in ("eager", "jit"):
            a = _got(run, f"{call}_dtensor_params_dtensor_V_{jit}_5")
            b = _got(run, f"{call}_dtensor_params_plain_V_{jit}_5")
            for k in ("W", "H"):
                _close(a[k], b[k], what=(call, jit, k))


def test_destroying_a_group_drops_the_trainers_compiled_steps(run):
    """A compiled step on a DTensor target records its process groups on
    its cache entry; ``destroy_process_group`` of a group drops the
    entries holding it, first (their graphs would hold its captured
    collectives on the card, C12), and leaves the others."""
    got = _got(run, "teardown")
    assert int(got["sub_before"]) == 1 and int(got["sub_after"]) == 0
    assert int(got["main_before"]) == 1 and int(got["main_after"]) == 1


@pytest.mark.parametrize("transport, size, betamu, sparsity", [
    ("gloo", 2, True, True), ("nccl", 1, True, False), ("nccl", 4, True, False),
    ("gloo-staged", 2, False, False)])
def test_which_steps_are_compiled(transport, size, betamu, sparsity,
                                  monkeypatch):
    """A step's collectives decide whether it is compiled: not over
    ``"gloo-staged"`` (the sharded fits' rule), and ``SparsityProj``'s
    line search not over NCCL (C16: the capture of its WHILE body with
    collectives inside and outside it died on the card); ``BetaMu``'s
    sweep over NCCL is (across ranks with NCCL's graph mixing support
    off)."""
    from types import SimpleNamespace

    from pytorch_nmf_tpu_torch import trainer

    monkeypatch.setenv("NCCL_GRAPH_MIXING_SUPPORT", "0")
    comms = [SimpleNamespace(transport=transport, size=size)]
    assert trainer._compiles(comms) is betamu
    assert trainer._compiles(comms, device_loops=True) is sparsity
    assert trainer._compiles([]) and trainer._compiles([], device_loops=True)

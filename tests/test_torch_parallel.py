"""The port's sharded NMF, PLCA and sparse fits (``pytorch_nmf_tpu_torch.
parallel``) against the JAX package's, on identical numpy inputs and
starts.

The port runs in gloo rank processes on the CPU (``_torch_parallel_child``):
one group of 4 ranks for the whole file, started once by a module-scoped
fixture that runs every case and keeps the results; each test reads its
own case.  The JAX side runs here, on a 2-device (or 2×2) sub-mesh of the
8 virtual CPU devices.  Tolerance: 1e-5 relative to the factor's largest
entry after ≤ 10 iterations (float32 sums in another order), with the same
``n_iter``; the reference's raw-loop-index PLCA quirk is kept.
"""

import warnings

import numpy as np
import pytest

pytest.importorskip("torch")

from _torch_parallel_child import run_group  # noqa: E402

RTOL = 1e-5
ITERS = 10
NMF_BETAS = (2, 1, 0.5, 0)
MODEL_BETAS = (1, 0.5, 2)
PLCA_ALPHAS = ((1.0, 1.0, 1.0), (1.02, 0.99, 1.0))
SPARSE_BETAS = (2, 1, 0.5)


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


def _sparse_problem(seed, skewed=False, M=40, K=28, R=4):
    rs = np.random.RandomState(seed)
    V = np.where(rs.rand(M, K) > 0.8, rs.rand(M, K), 0).astype("f")
    if skewed:  # one dense row and one dense column: the ELL spill
        V[2, :] = rs.rand(K).astype("f") + 0.1
        V[:, 3] = rs.rand(M).astype("f") + 0.1
    return {"V": V, "W": rs.rand(K, R).astype("f") + 0.1,
            "H": rs.rand(M, R).astype("f") + 0.1}


def _cases():
    """``{name: (case, inputs)}``: every case of the file."""
    cases = {}

    def add(name, kind, axes, inputs, **kw):
        cases[name] = ({"name": name, "kind": kind, "axes": axes, "kw": kw},
                       inputs)

    two = {"data": 2}
    for i, beta in enumerate(NMF_BETAS):
        add(f"nmf_b{beta}", "nmf", two, _nmf_problem(i), beta=beta, tol=0,
            max_iter=ITERS)
    for i, beta in enumerate(MODEL_BETAS):
        add(f"nmf_model_b{beta}", "nmf", {"data": 2, "model": 2},
            _nmf_problem(10 + i), beta=beta, tol=0, max_iter=ITERS,
            model_axis="model")
    add("nmf_early", "nmf", two, _nmf_problem(20), beta=1, tol=1e-3,
        max_iter=200)
    add("nmf_l1", "nmf", two, _nmf_problem(21), beta=1, tol=0,
        max_iter=ITERS, l1_reg=0.1)
    add("nmf_l2", "nmf", two, _nmf_problem(22), beta=0.5, tol=0,
        max_iter=ITERS, l2_reg=0.1)
    add("nmf_unfused", "nmf", two, _nmf_problem(23), beta=0.5, tol=0,
        max_iter=ITERS, use_pallas=False)
    for i, (wa, ha, za) in enumerate(PLCA_ALPHAS):
        add(f"plca_{i}", "plca", two, _plca_problem(30 + i), tol=0,
            max_iter=20, W_alpha=wa, H_alpha=ha, Z_alpha=za)
    add("plca_early", "plca", two, _plca_problem(33), tol=1e-3, max_iter=200)
    add("plca_frozen_z", "plca", two, _plca_problem(34), tol=0,
        max_iter=ITERS, update_Z=False, H_alpha=1.01)
    for i, beta in enumerate(SPARSE_BETAS):
        add(f"sparse_b{beta}", "sparse", two, _sparse_problem(40 + i),
            beta=beta, tol=0, max_iter=ITERS)
    add("sparse_early", "sparse", two, _sparse_problem(44), beta=1, tol=1e-3,
        max_iter=200)
    add("sparse_skewed", "sparse", two, _sparse_problem(45, skewed=True),
        beta=1, tol=0, max_iter=ITERS)
    add("sparse_odd_rows", "sparse", {"data": 4},
        _sparse_problem(46, M=41), beta=0.5, tol=0, max_iter=ITERS)
    # the all-reduced sides never run B1's β=1 epilogue; the local H side
    # (no model axis) does
    add("spy_data", "nmf", two, _nmf_problem(50), beta=1, tol=0, max_iter=3)
    add("spy_model", "nmf", {"data": 2, "model": 2}, _nmf_problem(51),
        beta=1, tol=0, max_iter=3, model_axis="model")
    cases["spy_data"][0]["spy"] = cases["spy_model"][0]["spy"] = True
    # world size 1 against the port's single-card fits
    for model, prob, kw in (("NMF", _nmf_problem(60), dict(beta=1)),
                            ("PLCA", _plca_problem(61), {})):
        kind = "nmf" if model == "NMF" else "plca"
        add(f"w1_{model}", kind, {"data": 1}, prob, tol=0, max_iter=ITERS,
            **kw)
        add(f"w1_{model}_single", "single", {"data": 1}, prob, tol=0,
            max_iter=ITERS, **kw)
        cases[f"w1_{model}_single"][0]["model"] = model
    add("mesh_error", "mesh_error", {"data": 1}, {})
    return cases


CASES = _cases()


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side (JAX on the CPU); skips where JAX is
    missing, so the card's tests need none."""
    return pytest.importorskip("jax")


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Every case through 4 gloo ranks, once: ``[rank results]``."""
    arrays = {f"{name}:{k}": v for name, (_, inp) in CASES.items()
              for k, v in inp.items()}
    return run_group(tmp_path_factory.mktemp("torch_parallel"), 4,
                     [c for c, _ in CASES.values()], arrays)


def _got(port, name, ranks=2):
    """Rank 0's results of ``name``, after checking that every rank of the
    mesh returned the same."""
    out = port[0][name]
    for r in range(1, ranks):
        for k, v in out.items():
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

    n = int(np.prod(list(axes.values())))
    return make_mesh(axes, jax.devices()[:n])


def _jax_nmf(name):
    from pytorch_nmf_tpu.parallel import sharded_nmf_fit

    case, inp = CASES[name]
    W, H, n = sharded_nmf_fit(inp["V"], inp["W"], inp["H"],
                              _jax_mesh(case["axes"]), **case["kw"])
    return np.asarray(W), np.asarray(H), int(n)


@pytest.mark.parametrize("name", [f"nmf_b{b}" for b in NMF_BETAS]
                         + [f"nmf_model_b{b}" for b in MODEL_BETAS]
                         + ["nmf_early", "nmf_l1", "nmf_l2", "nmf_unfused"])
def test_sharded_nmf_matches_jax(jx, port, name):
    ranks = 4 if "model" in name else 2
    got = _got(port, name, ranks)
    W, H, n = _jax_nmf(name)
    assert int(got["n_iter"]) == n
    _close(got["W"], W, what="W")
    _close(got["H"], H, what="H")
    if name == "nmf_early":
        assert n < 200


@pytest.mark.parametrize("name", [f"plca_{i}" for i in range(len(PLCA_ALPHAS))]
                         + ["plca_early", "plca_frozen_z"])
def test_sharded_plca_matches_jax(jx, port, name):
    from pytorch_nmf_tpu.parallel import sharded_plca_fit

    got = _got(port, name)
    case, inp = CASES[name]
    W, H, Z, n, norm = sharded_plca_fit(inp["V"], inp["W"], inp["H"],
                                        inp["Z"], _jax_mesh(case["axes"]),
                                        **case["kw"])
    # the raw loop index: 10·k - 1 converged, else max_iter - 1
    assert int(got["n_iter"]) == int(n)
    if name == "plca_early":
        assert int(n) % 10 == 9 and int(n) < 199
    else:
        assert int(n) == case["kw"]["max_iter"] - 1
    _close(got["norm"], float(norm), what="norm")
    for key, ref in (("W", W), ("H", H), ("Z", Z)):
        _close(got[key], np.asarray(ref), what=key)


@pytest.mark.parametrize("name", [f"sparse_b{b}" for b in SPARSE_BETAS]
                         + ["sparse_early", "sparse_skewed",
                            "sparse_odd_rows"])
def test_sharded_sparse_matches_jax(jx, port, name):
    from pytorch_nmf_tpu.ops.sparse import sparse_from_dense
    from pytorch_nmf_tpu.parallel import sharded_sparse_nmf_fit

    case, inp = CASES[name]
    got = _got(port, name, case["axes"]["data"])
    W, H, n = sharded_sparse_nmf_fit(sparse_from_dense(inp["V"]), inp["W"],
                                     inp["H"], _jax_mesh(case["axes"]),
                                     **case["kw"])
    assert int(got["n_iter"]) == int(n)
    if name == "sparse_early":
        assert int(n) < 200
    _close(got["W"], np.asarray(W), what="W")
    _close(got["H"], np.asarray(H), what="H")


def test_all_reduced_sides_run_no_epilogue(port):
    """B1's β=1 epilogue clamps inside the kernel: on a partial sum that
    would clamp before the reduction.  Without a model axis only the H side
    (local) runs it; with one, neither side does."""
    data, model = port[0]["spy_data"], port[0]["spy_model"]
    assert int(data["b1_w"]) == int(data["b1_h"]) == 3
    assert int(data["b1_w_epilogue"]) == 0
    assert int(data["b1_h_epilogue"]) == 3
    assert int(model["b1_w"]) == int(model["b1_h"]) == 3
    assert int(model["b1_w_epilogue"]) == int(model["b1_h_epilogue"]) == 0


def test_spied_fits_match_jax(jx, port):
    for name in ("spy_data", "spy_model"):
        got = _got(port, name, 4 if name == "spy_model" else 2)
        W, H, n = _jax_nmf(name)
        assert int(got["n_iter"]) == n
        _close(got["W"], W, what=f"{name} W")
        _close(got["H"], H, what=f"{name} H")


@pytest.mark.parametrize("model", ["NMF", "PLCA"])
def test_world_size_one_equals_single_card_fit(port, model):
    got, ref = port[0][f"w1_{model}"], port[0][f"w1_{model}_single"]
    assert int(got["n_iter"]) == int(ref["n_iter"])
    for key in ("W", "H", "Z")[:3 if model == "PLCA" else 2]:
        _close(got[key], ref[key], rtol=1e-6, what=key)


def test_make_mesh_needs_enough_ranks(port):
    msg = bytes(port[0]["mesh_error"]["raised"]).decode()
    assert "needs 5 ranks, only 4 available" in msg


def test_unfused_card_fit_is_refused():
    """``use_pallas=False`` has no card path: refused on a ``"cuda"`` mesh
    before anything runs (a stand-in mesh, as this needs no card)."""
    from types import SimpleNamespace

    from pytorch_nmf_tpu_torch.parallel import sharded_nmf_fit

    V, W, H = (np.ones(s, "f") for s in ((4, 3), (3, 2), (4, 2)))
    with pytest.raises(ValueError, match="use_pallas=False"):
        sharded_nmf_fit(V, W, H, SimpleNamespace(device_type="cuda"),
                        beta=0.5, use_pallas=False)


def test_initialize_explicit_failure_raises(monkeypatch):
    from pytorch_nmf_tpu_torch.parallel import distributed

    with pytest.raises(ValueError):
        distributed.initialize("tcp://127.0.0.1:1", 2)  # no process_id
    with pytest.raises((RuntimeError, ValueError)):
        distributed.initialize("tcp://127.0.0.1:1", 1, 0, backend="nonesuch")


def test_initialize_without_arguments_stays_single_process(monkeypatch):
    import torch.distributed as dist

    from pytorch_nmf_tpu_torch.parallel import distributed

    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        distributed.initialize()
    assert any("single-process" in str(x.message) for x in w)
    assert not dist.is_initialized()


def test_exports_match_jax(jx):
    """The port's ``parallel`` exports the JAX package's names; its
    ``sharded`` module lacks ``nmf_updater_factory_sharded``, the updater
    factory of JAX's GSPMD loop for ``NMF.fit`` on a sharded target, which
    the port's ``NMF.fit`` routes to ``sharded_nmf_fit`` instead."""
    import pytorch_nmf_tpu.parallel as jp

    import pytorch_nmf_tpu_torch.parallel as tp

    jax_names = {n for n in dir(jp) if not n.startswith("_")
                 and not isinstance(getattr(jp, n), type(jp))} | {"distributed"}
    assert set(tp.__all__) == jax_names
    for mod in ("halo", "mesh", "distributed", "sharded_sparse", "sharded"):
        j, t = getattr(jp, mod), getattr(tp, mod)
        deferred = {"sharded": {"nmf_updater_factory_sharded"}}.get(mod,
                                                                     set())
        assert set(t.__all__) == set(j.__all__) - deferred, mod


# --------------------------------------------------------------------------
# on the card: 2 gloo ranks sharing cuda:0, B1/B2 per rank
# --------------------------------------------------------------------------
CUDA_CASES = {
    "cuda_nmf_b0.5": (dict(kind="nmf", axes={"data": 2}, device="cuda",
                           kw=dict(beta=0.5, tol=0, max_iter=20)),
                      _nmf_problem(70, M=1024, K=260, R=16)),
    "cuda_nmf_b1_model": (dict(kind="nmf", axes={"data": 2, "model": 1},
                               device="cuda",
                               kw=dict(beta=1, tol=0, max_iter=20,
                                       model_axis="model")),
                          _nmf_problem(71, M=1024, K=260, R=16)),
}


@pytest.fixture(scope="module")
def port_cuda(tmp_path_factory):
    """The CUDA cases and their single-card fits (rank 0 alone) through 2
    gloo ranks on card 0."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cases, arrays = [], {}
    for name, (case, inp) in CUDA_CASES.items():
        cases.append(dict(case, name=name))
        kw = {k: v for k, v in case["kw"].items() if k != "model_axis"}
        cases.append(dict(name=name + "_single", kind="single", model="NMF",
                          axes={"data": 1}, device="cuda", kw=kw))
        for k, v in inp.items():
            arrays[f"{name}:{k}"] = arrays[f"{name}_single:{k}"] = v
    return run_group(tmp_path_factory.mktemp("torch_parallel_cuda"), 2,
                     cases, arrays)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CUDA_CASES))
def test_cuda_sharded_nmf_runs_b1_b2(port_cuda, name):
    """Each rank runs B1 twice an iteration (and B2 a loss evaluation at
    β=0.5); the fit equals the single-card fit within 1e-4."""
    got = _got(port_cuda, name)
    ref = port_cuda[0][name + "_single"]
    assert int(got["n_iter"]) == int(ref["n_iter"]) == 20
    b2 = 3 if "b0.5" in name else 0
    assert [int(x) for x in got["launches"]] == [40, b2, 0, 0]
    _close(got["W"], ref["W"], rtol=1e-4, what="W")
    _close(got["H"], ref["H"], rtol=1e-4, what="H")

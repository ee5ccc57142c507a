"""The port's halo-exchange fits (NMFD/NMF2D/NMF3D and the SIPLCA family,
``pytorch_nmf_tpu_torch.parallel.halo``) and the halo operators against
the JAX package's, on identical numpy inputs and starts.

The port runs in 2 gloo rank processes on the CPU (``_torch_parallel_child``,
one group for the whole file, from a module-scoped fixture), every halo
fit in a kernel mode forced through the private fits' ``mode`` (``fused``,
the card's default, unless a case names ``fused_w``), where B3/B4's plain
versions stand in for the kernels; the library modes, which the fits
choose on the CPU, are held to JAX's in ``test_torch_halo_modes.py``.
The JAX side runs here on a
2-device sub-mesh of the 8 virtual CPU devices, in its kernel mode (the
Pallas kernels in interpret mode, ``PNT_PALLAS_INTERPRET=1
PNT_NMFD_PALLAS=1``) and in its default per-shard mode.  Tolerance: 1e-5
relative to the factor's largest entry after ≤ 10 iterations, with the
same ``n_iter``.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from _torch_parallel_child import run_group  # noqa: E402

RTOL = 1e-5
ITERS = 10
NMFD_CASES = [(beta, N) for beta in (1, 2, 0.5) for N in (1, 2)]


def _deconv_problem(seed, N, C, R, S_out, kernel):
    rs = np.random.RandomState(seed)
    S_in = tuple(s - k + 1 for s, k in zip(S_out, kernel))
    return {"V": rs.rand(N, C, *S_out).astype("f") + 0.01,
            "W": rs.rand(C, R, *kernel).astype("f") + 0.1,
            "H": rs.rand(N, R, *S_in).astype("f") + 0.1}


def _siplca_problem(seed, N, C, R, S_out, kernel):
    """A normalized start (the SIPLCA constructors' normalization)."""
    p = _deconv_problem(seed, N, C, R, S_out, kernel)
    rs = np.random.RandomState(seed + 1000)
    W, H = p["W"], p["H"]
    axes_w = (0,) + tuple(range(2, W.ndim))
    axes_h = (0,) + tuple(range(2, H.ndim))
    Z = rs.rand(R).astype("f") + 0.1
    return {"V": p["V"] - 0.01, "W": W / W.sum(axes_w, keepdims=True),
            "H": H / H.sum(axes_h, keepdims=True), "Z": Z / Z.sum()}


def _cases():
    cases = {}

    def add(name, kind, inputs, axes=None, **extra):
        kw = extra.pop("kw")
        if kind in ("deconv", "siplca"):
            extra.setdefault("mode", "fused")
        cases[name] = (dict({"name": name, "kind": kind,
                             "axes": axes or {"seq": 2}, "kw": kw}, **extra),
                       inputs)

    for i, (beta, N) in enumerate(NMFD_CASES):
        # chunk·N = 256: the JAX kernel mode's length gate
        add(f"nmfd_b{beta}_n{N}", "deconv",
            _deconv_problem(i, N, 6, 3, (512 // N,), (5,)), nd=1,
            kw=dict(beta=beta, tol=0, max_iter=ITERS))
    add("nmfd_pad", "deconv", _deconv_problem(10, 1, 6, 3, (301,), (5,)),
        nd=1, kw=dict(beta=0.5, tol=1e-3, max_iter=200))
    add("nmfd_short", "deconv", _deconv_problem(11, 1, 5, 2, (20,), (15,)),
        nd=1, kw=dict(beta=1, tol=0, max_iter=ITERS))
    for flag in ("update_W", "update_H"):
        add(f"nmfd_no_{flag[-1]}", "deconv",
            _deconv_problem(12, 1, 6, 3, (64,), (5,)), nd=1,
            kw={"beta": 0.5, "tol": 0, "max_iter": ITERS, flag: False})
    nd_rows = {
        "nmf2d_b1": (2, 1, (8, 5, (7, 128), (3, 4)), 1),
        "nmf2d_b2": (2, 1, (8, 5, (7, 64), (3, 4)), 2),
        "nmf2d_n2": (2, 2, (8, 5, (7, 64), (3, 4)), 0.5),
        "nmf2d_ky1_n2": (2, 2, (6, 3, (5, 40), (1, 4)), 1),
        "nmf3d_b1": (3, 1, (5, 4, (5, 8, 32), (2, 3, 3)), 1),
        "nmf3d_n2": (3, 2, (5, 4, (5, 8, 32), (2, 3, 3)), 2),
    }
    for i, (name, (nd, N, (C, R, S_out, k), beta)) in enumerate(
            nd_rows.items()):
        add(name, "deconv", _deconv_problem(20 + i, N, C, R, S_out, k), nd=nd,
            kw=dict(beta=beta, tol=0, max_iter=8))
    for i, alphas in enumerate(((1.0, 1.0, 1.0), (1.02, 0.99, 1.0))):
        # L_out 61 over 2 ranks: padded H, under the H prior too
        add(f"siplca_{i}", "siplca", _siplca_problem(30 + i, 1, 6, 3, (61,),
                                                     (5,)), nd=1,
            kw=dict(tol=0, max_iter=ITERS, W_alpha=alphas[0],
                    H_alpha=alphas[1], Z_alpha=alphas[2]))
    add("siplca_early", "siplca", _siplca_problem(32, 1, 8, 2, (64,), (5,)),
        nd=1, kw=dict(tol=1e-3, max_iter=200))
    add("siplca_n2", "siplca", _siplca_problem(33, 2, 6, 3, (40,), (4,)),
        nd=1, kw=dict(tol=0, max_iter=ITERS, H_alpha=1.01))
    add("siplca2", "siplca", _siplca_problem(34, 1, 5, 3, (6, 33), (2, 4)),
        nd=2, kw=dict(tol=0, max_iter=ITERS))
    add("siplca3", "siplca", _siplca_problem(35, 1, 4, 2, (4, 5, 18),
                                             (2, 2, 3)),
        nd=3, kw=dict(tol=0, max_iter=ITERS, Z_alpha=1.05))
    # the all-reduced W side never runs B4's β=1 epilogue, in either mode
    # that runs B4
    for mode in ("fused", "fused_w"):
        sfx = "" if mode == "fused" else "_fused_w"
        add("spy_nmfd" + sfx, "deconv",
            _deconv_problem(13, 1, 6, 3, (64,), (5,)), nd=1, spy=True,
            mode=mode, kw=dict(beta=1, tol=0, max_iter=3))
        add("spy_nmf2d_n2" + sfx, "deconv",
            _deconv_problem(14, 2, 4, 3, (5, 24), (2, 3)), nd=2, spy=True,
            mode=mode, kw=dict(beta=1, tol=0, max_iter=3))
    rs = np.random.RandomState(40)
    add("halo_ops", "halo_ops", {
        "x": rs.rand(2, 3, 2 * 9).astype("f"),
        "g": rs.rand(2, 3, 2 * (9 + 4)).astype("f"),
        "halo": np.int64(4)}, kw={})
    # world size 1 against the port's single-card fits
    for model, kind, prob, kw in (
            ("NMFD", "deconv", _deconv_problem(50, 1, 6, 3, (64,), (5,)),
             dict(beta=1)),
            ("SIPLCA", "siplca", _siplca_problem(51, 1, 6, 3, (64,), (5,)),
             {})):
        add(f"w1_{model}", kind, prob, axes={"seq": 1}, nd=1,
            kw=dict(kw, tol=0, max_iter=ITERS))
        add(f"w1_{model}_single", "single", prob, axes={"seq": 1},
            model=model, kw=dict(kw, tol=0, max_iter=ITERS))
    return cases


CASES = _cases()


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side (JAX on the CPU); skips where JAX is
    missing, so the card's tests need none."""
    return pytest.importorskip("jax")


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Every case through 2 gloo ranks, once: ``[rank results]``."""
    arrays = {f"{name}:{k}": v for name, (_, inp) in CASES.items()
              for k, v in inp.items()}
    return run_group(tmp_path_factory.mktemp("torch_halo"), 2,
                     [c for c, _ in CASES.values()], arrays)


def _got(port, name):
    out = port[0][name]
    mode = CASES[name][0].get("mode") if name in CASES else None
    if mode is not None:
        assert str(out["mode"]) == mode
    for k, v in out.items():
        np.testing.assert_array_equal(port[1][name][k], v, err_msg=k)
    return out


def _close(got, ref, rtol=RTOL, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= rtol, (what, err)


def _jax_mesh(n=2):
    import jax

    from pytorch_nmf_tpu.parallel import make_mesh

    return make_mesh({"seq": n}, jax.devices()[:n])


_JAX_FITS = {("deconv", 1): "sharded_nmfd_fit", ("deconv", 2): "sharded_nmf2d_fit",
             ("deconv", 3): "sharded_nmf3d_fit", ("siplca", 1): "sharded_siplca_fit",
             ("siplca", 2): "sharded_siplca2_fit",
             ("siplca", 3): "sharded_siplca3_fit"}


def _jax_fit(name, kernel_mode, monkeypatch):
    """The JAX package's sharded fit of ``name``: in its kernel mode
    (checked to be the one its mode choice takes) or its default mode."""
    import pytorch_nmf_tpu.parallel as jp
    from pytorch_nmf_tpu.ops import pallas_deconv

    case, inp = CASES[name]
    fit = getattr(jp, _JAX_FITS[case["kind"], case["nd"]])
    args = [inp["V"], inp["W"], inp["H"]] + (
        [inp["Z"]] if case["kind"] == "siplca" else [])
    with monkeypatch.context() as mp:
        if kernel_mode:
            mp.setenv("PNT_NMFD_PALLAS", "1")
            mp.setenv("PNT_PALLAS_INTERPRET", "1")
            V, W = inp["V"], inp["W"]
            n_dev = 2
            chunk = max(-(-V.shape[-1] // n_dev), W.shape[-1] - 1)
            lead_in = inp["H"].shape[2:-1]
            assert pallas_deconv.halo_pallas_mode(
                V.shape[0], V.shape[1], lead_in, chunk, W.shape[2:],
                W.shape[1]) == "pallas"
        out = fit(*args, _jax_mesh(), **case["kw"])
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("kernel_mode", [True, False],
                         ids=["jax_kernels", "jax_default"])
@pytest.mark.parametrize("beta, N", NMFD_CASES)
def test_halo_nmfd_matches_jax(jx, port, monkeypatch, beta, N, kernel_mode):
    name = f"nmfd_b{beta}_n{N}"
    got = _got(port, name)
    W, H, n = _jax_fit(name, kernel_mode, monkeypatch)
    assert int(got["n_iter"]) == int(n) == ITERS
    _close(got["W"], W, what="W")
    _close(got["H"], H, what="H")


@pytest.mark.parametrize("name", ["nmfd_pad", "nmfd_short", "nmfd_no_W",
                                  "nmfd_no_H"])
def test_halo_nmfd_padding_and_frozen_factors(jx, port, monkeypatch, name):
    """A length that does not divide (β=0.5: the padded cells' loss offset
    decides the early stop), chunks shorter than ``T - 1``, and a frozen
    factor, against JAX's default mode."""
    got = _got(port, name)
    W, H, n = _jax_fit(name, False, monkeypatch)
    assert int(got["n_iter"]) == int(n)
    if name == "nmfd_pad":
        assert int(n) < 200
    _close(got["W"], W, what="W")
    _close(got["H"], H, what="H")
    inp = CASES[name][1]
    if name == "nmfd_no_W":
        np.testing.assert_array_equal(got["W"], inp["W"])
    if name == "nmfd_no_H":
        np.testing.assert_array_equal(got["H"], inp["H"])


@pytest.mark.parametrize("name", ["nmf2d_b1", "nmf2d_b2", "nmf2d_n2",
                                  "nmf2d_ky1_n2", "nmf3d_b1", "nmf3d_n2"])
def test_halo_nd_matches_jax_default(jx, port, monkeypatch, name):
    got = _got(port, name)
    W, H, n = _jax_fit(name, False, monkeypatch)
    assert int(got["n_iter"]) == int(n)
    _close(got["W"], W, what="W")
    _close(got["H"], H, what="H")


@pytest.mark.parametrize("name", ["nmf2d_b1", "nmf3d_b1"])
def test_halo_nd_matches_jax_kernels(jx, port, monkeypatch, name):
    got = _got(port, name)
    W, H, n = _jax_fit(name, True, monkeypatch)
    assert int(got["n_iter"]) == int(n)
    _close(got["W"], W, what="W")
    _close(got["H"], H, what="H")


@pytest.mark.parametrize("name", ["siplca_0", "siplca_1", "siplca_early",
                                  "siplca_n2", "siplca2", "siplca3"])
def test_halo_siplca_matches_jax(jx, port, monkeypatch, name):
    """The SIPLCA family's EM (JAX runs its library per-shard engine; the
    port its ``fused`` mode, B3/B4's plain versions differentiated behind
    ``left_halo``), with the priors over padded H and the raw-loop-index
    ``n_iter``."""
    got = _got(port, name)
    W, H, Z, n, norm = _jax_fit(name, False, monkeypatch)
    assert int(got["n_iter"]) == int(n)
    if name == "siplca_early":
        assert int(n) % 10 == 9 and int(n) < 199
    _close(got["norm"], float(norm), what="norm")
    for key, ref in (("W", W), ("H", H), ("Z", Z)):
        _close(got[key], ref, what=key)


@pytest.mark.parametrize("name", ["spy_nmfd", "spy_nmf2d_n2",
                                  "spy_nmfd_fused_w", "spy_nmf2d_n2_fused_w"])
def test_all_reduced_w_side_runs_no_epilogue(port, name):
    """B4's β=1 epilogue clamps and multiplies inside the kernel: on a
    rank's partial sum it would clamp before the all-reduce.  The halo fit
    calls B4 once an iteration for the raw sums, never with ``mu_w2``, in
    the kernel mode (with B3 once an iteration) and in ``fused_w`` (no
    B3)."""
    got = _got(port, name)
    assert str(got["mode"]) == CASES[name][0]["mode"]
    assert int(got["b4"]) == 3
    assert int(got["b4_epilogue"]) == 0
    assert int(got["b3"]) == (0 if name.endswith("fused_w") else 3)
    assert int(got["b1_w"]) == int(got["b1_h"]) == 0


def _jax_halo_ops(x, g, halo):
    from functools import partial

    import jax
    from jax.sharding import PartitionSpec as P

    from pytorch_nmf_tpu.parallel import halo as jh

    mesh = _jax_mesh()
    spec = P(None, None, "seq")
    left = jax.shard_map(partial(jh.left_halo, halo=halo, axis_name="seq"),
                         mesh=mesh, in_specs=spec, out_specs=spec)(x)
    adj = jax.shard_map(partial(jh.halo_adjoint, halo=halo, axis_name="seq"),
                        mesh=mesh, in_specs=spec, out_specs=spec)(g)
    return np.asarray(left), np.asarray(adj)


def test_left_halo_and_adjoint_match_jax(jx, port):
    got = _got(port, "halo_ops")
    inp = CASES["halo_ops"][1]
    left, adj = _jax_halo_ops(inp["x"], inp["g"], int(inp["halo"]))
    np.testing.assert_array_equal(got["left"], left)
    _close(got["adjoint"], adj, rtol=1e-7, what="adjoint")


def test_halo_adjoint_is_the_transpose(port):
    """⟨left_halo(x), g⟩ = ⟨x, halo_adjoint(g)⟩ summed over the ranks, and
    autograd through ``left_halo`` gives ``halo_adjoint``."""
    got = _got(port, "halo_ops")
    lhs, rhs = got["inner"]
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)
    np.testing.assert_array_equal(got["autograd"], got["adjoint"])


@pytest.mark.parametrize("model", ["NMFD", "SIPLCA"])
def test_world_size_one_equals_single_card_fit(port, model):
    got, ref = port[0][f"w1_{model}"], port[0][f"w1_{model}_single"]
    assert int(got["n_iter"]) == int(ref["n_iter"])
    for key in ("W", "H", "Z")[:3 if model == "SIPLCA" else 2]:
        _close(got[key], ref[key], rtol=1e-6, what=key)


# --------------------------------------------------------------------------
# on the card: 2 gloo ranks sharing cuda:0, B3/B4 per rank
# --------------------------------------------------------------------------
CUDA_CASES = {
    "cuda_nmfd_b1": ("deconv", "NMFD", dict(beta=1, tol=0, max_iter=6),
                     _deconv_problem(80, 1, 64, 8, (512,), (16,))),
    "cuda_nmfd_b0.5_n2": ("deconv", "NMFD", dict(beta=0.5, tol=0, max_iter=6),
                          _deconv_problem(81, 2, 64, 8, (512,), (16,))),
    "cuda_nmf2d_b1": ("deconv", "NMF2D", dict(beta=1, tol=0, max_iter=6),
                      _deconv_problem(82, 1, 32, 8, (12, 128), (3, 4))),
    "cuda_siplca": ("siplca", "SIPLCA", dict(tol=0, max_iter=6),
                    _siplca_problem(83, 1, 64, 8, (512,), (16,))),
}


@pytest.fixture(scope="module")
def port_cuda(tmp_path_factory):
    """The CUDA cases and their single-card fits (rank 0 alone) through 2
    gloo ranks on card 0."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cases, arrays = [], {}
    for name, (kind, model, kw, inp) in CUDA_CASES.items():
        nd = inp["W"].ndim - 2
        cases.append(dict(name=name, kind=kind, nd=nd, axes={"seq": 2},
                          device="cuda", kw=kw))
        cases.append(dict(name=name + "_single", kind="single", model=model,
                          axes={"seq": 1}, device="cuda", kw=kw))
        for k, v in inp.items():
            arrays[f"{name}:{k}"] = arrays[f"{name}_single:{k}"] = v
    return run_group(tmp_path_factory.mktemp("torch_halo_cuda"), 2, cases,
                     arrays)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CUDA_CASES))
def test_cuda_halo_fit_runs_b3_b4(port_cuda, name):
    """Each rank runs B4 once an iteration and B3 once (β=1, the E-step) or
    twice (β ≠ 1); the fit equals the single-card fit within 1e-4."""
    got = _got(port_cuda, name)
    ref = port_cuda[0][name + "_single"]
    kind, _, kw, _ = CUDA_CASES[name]
    iters = 6
    assert int(got["n_iter"]) == int(ref["n_iter"])
    b3 = iters * (1 if kind == "siplca" or kw["beta"] == 1 else 2)
    assert [int(x) for x in got["launches"]] == [0, 0, b3, iters]
    for key in ("W", "H", "Z")[:3 if kind == "siplca" else 2]:
        _close(got[key], ref[key], rtol=1e-4, what=key)

"""The halo fits' per-shard modes (``pytorch_nmf_tpu_torch.parallel.halo``:
``fused_w``, ``stream``, ``unrolled``, ``conv``; the SIPLCA family's
``unrolled`` and ``conv``), their operators and reconstructions, and the
mode choice (``_halo_unfold_mode``, ``autotune.autotune_halo_mode``),
against the JAX package.

Each port mode runs in 2 gloo rank processes on the CPU
(``_torch_parallel_child``, one group for the file, from a module-scoped
fixture: ``test_torch_halo.py`` keeps its own), forced through the private
fits' ``mode`` argument; B4's plain version stands in for the kernel in
``fused_w``.  The JAX side runs here on a 2-device sub-mesh of the 8
virtual CPU devices in the same mode, forced without touching the JAX
package: ``conv`` by ``PNT_HALO_UNFOLD=0``, ``unrolled`` by
``PNT_NMFD_PALLAS=0 PNT_NMFD_AUTOTUNE=0`` at a small ``K·R``, ``stream``
by ``K·R > 4096`` (or its heuristic patched), ``pallas_w`` (the port's
``fused_w``) by ``PNT_NMFD_PALLAS=1 PNT_PALLAS_INTERPRET=1`` with the hgrad
VMEM model patched huge, as ``tests/test_parallel.py`` does; a spy on the
JAX fit's factory checks the mode it ran.  Tolerance: 1e-5 relative to the
factor's largest entry (5e-5 at R=512, as ``tests/test_parallel.py``
allows) after ≤ 10 iterations, with the same ``n_iter``.
"""

import numpy as np
import pytest
import torch

from _torch_parallel_child import run_group

RTOL = 1e-5
RTOL_R512 = 5e-5
ITERS = 10
NMFD_CASES = [(beta, N) for beta in (1, 2, 0.5) for N in (1, 2)]
# the port's mode -> the JAX package's
JAX_MODE = {"fused_w": "pallas_w", "stream": "stream", "conv": "conv",
            "unrolled": "unrolled"}
LIBRARY = ("stream", "conv", "unrolled")


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
        cases[name] = (dict({"name": name, "kind": kind,
                             "axes": axes or {"seq": 2}, "kw": kw}, **extra),
                       inputs)

    for i, (beta, N) in enumerate(NMFD_CASES):
        kw = dict(beta=beta, tol=0, max_iter=ITERS)
        # chunk·N = 256: the JAX kernel modes' length gate
        prob = _deconv_problem(i, N, 6, 3, (512 // N,), (5,))
        for mode in ("fused_w", "conv", "unrolled"):
            add(f"nmfd_b{beta}_n{N}_{mode}", "deconv", prob, nd=1, mode=mode,
                kw=kw)
        # K·R = 4608 > 4096: both packages' heuristic streams it, in two
        # τ-chunks (Tc = 8)
        add(f"nmfd_b{beta}_n{N}_stream", "deconv",
            _deconv_problem(10 + i, N, 6, 512, (64,), (9,)), nd=1,
            mode="stream", kw=kw)
    for mode in LIBRARY:
        add(f"nmfd_pad_{mode}", "deconv",
            _deconv_problem(20, 1, 6, 3, (301,), (5,)), nd=1, mode=mode,
            kw=dict(beta=0.5, tol=1e-3, max_iter=200))
        add(f"nmfd_short_{mode}", "deconv",
            _deconv_problem(21, 1, 5, 2, (20,), (15,)), nd=1, mode=mode,
            kw=dict(beta=1, tol=0, max_iter=ITERS))
    nd_rows = {"nmf2d": (2, 1, (8, 5, (7, 128), (3, 4)), 1),
               "nmf3d": (3, 1, (5, 4, (5, 8, 32), (2, 3, 3)), 0.5)}
    for i, (name, (nd, N, (C, R, S_out, k), beta)) in enumerate(
            nd_rows.items()):
        for mode in ("fused_w", "conv", "unrolled"):
            add(f"{name}_{mode}", "deconv",
                _deconv_problem(30 + i, N, C, R, S_out, k), nd=nd, mode=mode,
                kw=dict(beta=beta, tol=0, max_iter=8))
    siplca_rows = {
        # L_out 61 over 2 ranks: padded H, under the H prior
        "siplca": (1, _siplca_problem(40, 1, 6, 3, (61,), (5,)),
                   dict(H_alpha=0.99, W_alpha=1.02)),
        "siplca2": (2, _siplca_problem(41, 1, 5, 3, (6, 33), (2, 4)), {}),
        "siplca3": (3, _siplca_problem(42, 1, 4, 2, (4, 5, 18), (2, 2, 3)),
                    dict(Z_alpha=1.05)),
    }
    for name, (nd, prob, alphas) in siplca_rows.items():
        for mode in ("unrolled", "conv"):
            add(f"{name}_{mode}", "siplca", prob, nd=nd, mode=mode,
                kw=dict(alphas, tol=0, max_iter=ITERS))
    # K·R = 4608 > 4096, no mode forced: both packages' heuristic says
    # "stream", which the EM lacks, so both fits run "conv"
    add("siplca_long", "siplca", _siplca_problem(43, 1, 6, 512, (64,), (9,)),
        nd=1, expect="conv", kw=dict(H_alpha=1.01, tol=0, max_iter=ITERS))
    # rank agreement: rank 0 resolves and broadcasts; what rank 1 would
    # choose on its own (its heuristic, its timing) never runs
    agree = _deconv_problem(50, 1, 6, 3, (96,), (5,))
    add("agree_heuristic", "deconv", agree, nd=1,
        rank_env={"1": {"PNT_HALO_UNFOLD": "0"}},
        kw=dict(beta=1, tol=0, max_iter=4))
    add("agree_timing", "deconv", agree, nd=1,
        env={"PNT_NMFD_AUTOTUNE": "1"}, prefer={"0": "conv", "1": "unrolled"},
        kw=dict(beta=1, tol=0, max_iter=4))
    add("agree_siplca", "siplca", _siplca_problem(51, 1, 6, 3, (64,), (5,)),
        nd=1, env={"PNT_NMFD_AUTOTUNE": "1"},
        prefer={"0": "conv", "1": "unrolled"}, kw=dict(tol=0, max_iter=4))
    rs = np.random.RandomState(60)
    add("strip_ops", "halo_strip_ops", {
        "x": rs.rand(2, 3, 2 * 9).astype("f"),
        "gh": rs.rand(2, 3, 2 * 9).astype("f"),
        "gr": rs.rand(2, 3, 2 * 4).astype("f"),
        "halo": np.int64(4)}, kw={})
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
    return run_group(tmp_path_factory.mktemp("torch_halo_modes"), 2,
                     [c for c, _ in CASES.values()], arrays)


def _got(port, name):
    """Rank 0's results, which every rank must equal (the tuner's calls
    aside: rank 0 alone tunes)."""
    out = port[0][name]
    for k, v in out.items():
        if k != "tune_calls":
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


def _jax_fit(name, monkeypatch):
    """The JAX package's sharded fit of case ``name`` in the JAX mode of the
    case's port mode, or in its own choice where the case forces none (and
    names the mode it ``expect``s); the spy on its fit factory checks the
    mode it ran."""
    import pytorch_nmf_tpu.parallel as jp
    from pytorch_nmf_tpu.ops import pallas_deconv
    from pytorch_nmf_tpu.parallel import halo as jh

    case, inp = CASES[name]
    forced = "mode" in case
    mode = JAX_MODE[case["mode"] if forced else case["expect"]]
    fit = getattr(jp, _JAX_FITS[case["kind"], case["nd"]])
    em = case["kind"] == "siplca"
    args = [inp["V"], inp["W"], inp["H"]] + ([inp["Z"]] if em else [])
    seen = []
    factory = "_get_sharded_siplca_fit" if em else "_get_sharded_deconv_fit"
    orig = getattr(jh, factory)

    def spy(*a, **kw):
        seen.append(a[12] if em else (a[10], a[16]))
        return orig(*a, **kw)

    with monkeypatch.context() as mp:
        mp.setattr(jh, factory, spy)
        if mode == "pallas_w":
            mp.setenv("PNT_NMFD_PALLAS", "1")
            mp.setenv("PNT_PALLAS_INTERPRET", "1")
            mp.setattr(pallas_deconv, "_hgrad_scoped_bytes",
                       lambda *a: 1 << 40)
            V, W = inp["V"], inp["W"]
            chunk = max(-(-V.shape[-1] // 2), W.shape[-1] - 1)
            assert pallas_deconv.halo_pallas_mode(
                V.shape[0], V.shape[1], inp["H"].shape[2:-1], chunk,
                W.shape[2:], W.shape[1]) == "pallas_w"
        elif forced:
            mp.setenv("PNT_NMFD_AUTOTUNE", "0")
            mp.setenv("PNT_NMFD_PALLAS", "0")
            if mode == "conv":
                mp.setenv("PNT_HALO_UNFOLD", "0")
            elif mode == "stream" and inp["W"].shape[1] * np.prod(
                    inp["W"].shape[2:]) <= 4096:
                mp.setattr(jh, "_halo_unfold_mode", lambda *a: "stream")
        out = fit(*args, _jax_mesh(), **case["kw"])
    if em:
        assert seen[-1] == (mode == "unrolled"), seen
    else:
        # the conv mode runs the split form (the port's too)
        assert seen[-1][0] == mode and (mode != "conv" or seen[-1][1]), seen
    return [np.asarray(x) for x in out]


def _check_mu(port, name, monkeypatch, rtol=RTOL):
    got = _got(port, name)
    assert str(got["mode"]) == CASES[name][0]["mode"]
    W, H, n = _jax_fit(name, monkeypatch)
    assert int(got["n_iter"]) == int(n)
    _close(got["W"], W, rtol, what="W")
    _close(got["H"], H, rtol, what="H")
    return got, int(n)


@pytest.mark.parametrize("mode", ["fused_w", "stream", "conv", "unrolled"])
@pytest.mark.parametrize("beta, N", NMFD_CASES)
def test_halo_nmfd_mode_matches_jax(jx, port, monkeypatch, beta, N, mode):
    rtol = RTOL_R512 if mode == "stream" else RTOL
    _, n = _check_mu(port, f"nmfd_b{beta}_n{N}_{mode}", monkeypatch, rtol)
    assert n == ITERS


@pytest.mark.parametrize("mode", LIBRARY)
@pytest.mark.parametrize("case", ["pad", "short"])
def test_halo_nmfd_padded_and_short_chunks(jx, port, monkeypatch, case,
                                           mode):
    """A length that does not divide (β=0.5: the padded cells' loss offset
    decides the early stop) and chunks shorter than ``T - 1``, in every
    library mode."""
    _, n = _check_mu(port, f"nmfd_{case}_{mode}", monkeypatch)
    if case == "pad":
        assert n < 200


@pytest.mark.parametrize("mode", ["fused_w", "conv", "unrolled"])
@pytest.mark.parametrize("model", ["nmf2d", "nmf3d"])
def test_halo_nd_mode_matches_jax(jx, port, monkeypatch, model, mode):
    _check_mu(port, f"{model}_{mode}", monkeypatch)


def _check_em(port, name, mode, monkeypatch, rtol=RTOL):
    got = _got(port, name)
    assert str(got["mode"]) == mode
    W, H, Z, n, norm = _jax_fit(name, monkeypatch)
    assert int(got["n_iter"]) == int(n) == ITERS - 1
    _close(got["norm"], float(norm), what="norm")
    for key, ref in (("W", W), ("H", H), ("Z", Z)):
        _close(got[key], ref, rtol, what=key)


@pytest.mark.parametrize("mode", ["unrolled", "conv"])
@pytest.mark.parametrize("model", ["siplca", "siplca2", "siplca3"])
def test_halo_siplca_mode_matches_jax(jx, port, monkeypatch, model, mode):
    """The EM's library modes, under active priors (over padded H in the
    1-D case), with the raw-loop-index ``n_iter``."""
    _check_em(port, f"{model}_{mode}", mode, monkeypatch)


def test_halo_siplca_runs_conv_where_the_heuristic_streams(jx, port,
                                                           monkeypatch):
    """At ``K·R > 4096`` the heuristic says ``stream``, which the EM has
    not: the public SIPLCA fit resolves ``conv`` on its own and matches
    the JAX package's unforced fit (its concat conv form)."""
    _check_em(port, "siplca_long", "conv", monkeypatch, RTOL_R512)


@pytest.mark.parametrize("name", ["agree_heuristic", "agree_timing",
                                  "agree_siplca"])
def test_ranks_run_rank_0s_mode(port, name):
    """Rank 1 is given another heuristic (``PNT_HALO_UNFOLD=0``) or a tuner
    that prefers another mode; both ranks run rank 0's mode (``_got``
    holds every output equal across the ranks), and only rank 0 tunes."""
    got = _got(port, name)
    want = {"agree_heuristic": "unrolled"}.get(name, "conv")
    assert str(got["mode"]) == want
    tuned = int(name != "agree_heuristic")
    assert int(port[0][name]["tune_calls"]) == tuned
    assert int(port[1][name]["tune_calls"]) == 0


def _jax_strip_ops(x, gh, gr, halo):
    from functools import partial

    import jax
    from jax.sharding import PartitionSpec as P

    from pytorch_nmf_tpu.parallel import halo as jh

    mesh = _jax_mesh()
    spec = P(None, None, "seq")
    recv = jax.shard_map(partial(jh.halo_recv, halo=halo, axis_name="seq"),
                         mesh=mesh, in_specs=spec, out_specs=spec)(x)
    strip = jax.shard_map(
        partial(jh.halo_adjoint_strip, halo=halo, axis_name="seq"),
        mesh=mesh, in_specs=(spec, spec), out_specs=spec)(gh, gr)
    return np.asarray(recv), np.asarray(strip)


def test_halo_recv_and_strip_adjoint_match_jax(jx, port):
    got = _got(port, "strip_ops")
    inp = CASES["strip_ops"][1]
    recv, strip = _jax_strip_ops(inp["x"], inp["gh"], inp["gr"],
                                 int(inp["halo"]))
    np.testing.assert_array_equal(got["recv"], recv)
    _close(got["strip"], strip, rtol=1e-7, what="strip")


def test_halo_adjoint_strip_is_the_transpose_of_halo_recv(port):
    """⟨halo_recv(x), gr⟩ = ⟨x, halo_adjoint_strip(0, gr)⟩ summed over the
    ranks, and autograd through ``halo_recv`` gives that adjoint."""
    got = _got(port, "strip_ops")
    lhs, rhs = got["inner"]
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)
    np.testing.assert_array_equal(got["autograd"], got["adjoint0"])


# --------------------------------------------------------------------------
# the reconstructions, in one process
# --------------------------------------------------------------------------
RECON_ROWS = [(1, 2, 3, 4, (), (5,), 9), (1, 1, 2, 3, (), (1,), 6),
              (2, 1, 3, 2, (4,), (2, 3), 7), (2, 2, 2, 3, (3,), (3, 1), 5),
              (3, 1, 2, 2, (3, 2), (2, 2, 3), 6)]


def _recon_inputs(nd, N, C, R, lead_in, kernel, chunk):
    rs = np.random.RandomState(nd * 10 + chunk)
    T = kernel[-1]
    hp = rs.rand(N, R, *lead_in, chunk).astype("f")
    recv = rs.rand(N, R, *lead_in, T - 1).astype("f")
    W = rs.rand(C, R, *kernel).astype("f")
    return hp, recv, W


@pytest.mark.parametrize("row", RECON_ROWS, ids=lambda r: f"{r[0]}d_k{r[5]}")
def test_split_and_unfold_forms_equal_the_concat_conv(jx, row):
    """``_conv_halo_split_nd(hp, recv)`` and ``_unfold_halo_nd`` equal
    ``_conv_halo_nd(cat([recv, hp]))`` (``T = 1`` included), and each equals
    the JAX package's function."""
    from pytorch_nmf_tpu.parallel import halo as jh

    from pytorch_nmf_tpu_torch.parallel import halo as th

    nd = row[0]
    hp, recv, W = _recon_inputs(*row)
    t = [torch.from_numpy(x) for x in (hp, recv, W)]
    hh = torch.cat([t[1], t[0]], dim=-1)
    concat = th._conv_halo_nd(hh, t[2], nd).numpy()
    split = th._conv_halo_split_nd(t[0], t[1], t[2], nd).numpy()
    unfold = th._unfold_halo_nd(hh, t[2], nd).numpy()
    S_out = tuple(s + k - 1 for s, k in zip(hp.shape[2:-1], W.shape[2:-1]))
    assert concat.shape == (hp.shape[0], W.shape[0]) + S_out + (hp.shape[-1],)
    _close(split, concat, 1e-6, "split")
    _close(unfold, concat, 1e-6, "unfold")
    hhn = np.concatenate([recv, hp], axis=-1)
    _close(concat, jh._conv_halo_nd(hhn, W, nd), 1e-6, "jax concat")
    _close(unfold, jh._unfold_halo_nd(hhn, W, nd), 1e-6, "jax unfold")
    if W.shape[-1] > 1:
        _close(split, jh._conv_halo_split_nd(hp, recv, W, nd), 1e-6,
               "jax split")


def test_streamed_fold_and_w_side_valid_hooks():
    """The unfold engine's helpers with ``valid_last``: the τ-chunked fold
    onto the halo'd width and the τ-chunked W numerators (with the
    ``reduce`` hook seeing each chunk's raw sums before the clamps) equal
    autograd through the VALID unrolled reconstruction."""
    from pytorch_nmf_tpu_torch.ops import fast_nmfd as F
    from pytorch_nmf_tpu_torch.parallel import halo as th

    rs = np.random.RandomState(3)
    N, C, R, lead_in, kernel, chunk = 2, 3, 5, (3,), (2, 7), 6
    hh = torch.from_numpy(rs.rand(N, R, *lead_in, chunk + 6).astype("f"))
    W = torch.from_numpy(rs.rand(C, R, *kernel).astype("f"))
    cot = torch.from_numpy(rs.rand(N, C, 4, chunk).astype("f"))
    hh_ = hh.clone().requires_grad_(True)
    W_ = W.clone().requires_grad_(True)
    gH, gW = torch.autograd.grad(th._unfold_halo_nd(hh_, W_, 2), (hh_, W_),
                                 cot)
    Tc = 3  # τ-chunks of 3 of the 14 offsets
    (fold,) = F._unfold_h_contract(F._w2(W), [F._v2_flat(cot)], hh, kernel,
                                   Tc, valid_last=True)
    _close(fold.numpy(), gH.numpy(), 1e-6, "fold")
    # β=2 numerator against V = cot: neg = Pᵀ V
    seen = []

    def reduce(neg, pos):
        seen.append((neg.clone(), pos.clone()))

    F._unfold_upd_w(cot, F._w2(W), hh, kernel, Tc, 2.0, 1.0, 0.0, 0.0,
                    valid_last=True, reduce=reduce)
    neg = torch.cat([s[0] for s in seen])
    assert len(seen) == 5
    _close(neg.numpy(), F._w2(gW).numpy(), 1e-6, "neg")


# --------------------------------------------------------------------------
# the mode choice, in one process
# --------------------------------------------------------------------------
HEURISTIC_GRID = [(1, (), 640, (400,), 88), (1, (), 32, (9,), 512),
                  (2, (), 20, (5,), 3), (1, (121,), 128, (8, 8), 64),
                  (1, (16, 16), 64, (4, 4, 4), 16), (1, (), 50, (1,), 8),
                  (2, (5,), 8, (1, 3), 2000)]
HEURISTIC_ENV = [{}, {"PNT_HALO_UNFOLD": "0"},
                 {"PNT_NMFD_UNFOLD_MAX_BYTES": "1000000"},
                 {"PNT_NMFD_UNFOLD_MAX_BYTES": "40000000"}]


@pytest.mark.parametrize("env", HEURISTIC_ENV, ids=lambda e: ",".join(
    f"{k}={v}" for k, v in e.items()) or "default")
def test_halo_unfold_mode_matches_jax(jx, monkeypatch, env):
    from pytorch_nmf_tpu.parallel import halo as jh

    from pytorch_nmf_tpu_torch.parallel import halo as th

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    seen = set()
    for row in HEURISTIC_GRID:
        got = th._halo_unfold_mode(*row, device="cpu")
        assert got == jh._halo_unfold_mode(*row), row
        seen.add(got)
    if env.get("PNT_HALO_UNFOLD") == "0":
        assert seen == {"conv"}
    if not env:
        assert seen == {"unrolled", "stream", "conv"}


ROW = (1, 6, (), 40, (5,), 3)  # (N, C, lead_in, chunk, kernel, R)


@pytest.fixture
def tuner(monkeypatch):
    """The tuner with a clean table, and its timing replaced by fixed
    seconds per iteration (``times``, set by the test): which mode is timed
    is read from the run that ``_local_run`` builds."""
    from pytorch_nmf_tpu_torch.ops import autotune
    from pytorch_nmf_tpu_torch.parallel import halo as th

    for k in ("PNT_NMFD_AUTOTUNE", "PNT_AUTOTUNE_MIN_FLOPS", "PNT_NMFD_PALLAS",
              "PNT_HALO_UNFOLD", "PNT_AUTOTUNE_CACHE"):
        monkeypatch.delenv(k, raising=False)
    autotune.clear_cache()
    times = {}
    monkeypatch.setattr(th, "_local_run", lambda mode, *a: mode)
    monkeypatch.setattr(autotune, "_time_candidate",
                        lambda run, device, **kw: times[run])
    yield autotune, times
    autotune.clear_cache()


def _resolve(autotune, heuristic, em=False, dtype=torch.float32):
    return autotune.autotune_halo_mode(*ROW, 1.0, heuristic, not em,
                                       device="cpu", dtype=dtype)


def test_halo_mode_library_rules(tuner, monkeypatch):
    """On the CPU: float64 → conv; ``PNT_NMFD_PALLAS=1`` → fused; else the
    heuristic, ``unrolled`` timed against ``conv`` only above the threshold
    (and not under ``PNT_NMFD_AUTOTUNE=0``); a challenger must win by 10%."""
    autotune, times = tuner
    assert _resolve(autotune, "unrolled", dtype=torch.float64) == "conv"
    monkeypatch.setenv("PNT_NMFD_PALLAS", "1")
    assert _resolve(autotune, "stream") == "fused"
    monkeypatch.setenv("PNT_NMFD_PALLAS", "0")
    for h in ("stream", "conv", "unrolled"):
        assert _resolve(autotune, h) == h  # below the threshold
    assert not autotune._MEASURED
    monkeypatch.setenv("PNT_AUTOTUNE_MIN_FLOPS", "1")
    monkeypatch.setenv("PNT_NMFD_AUTOTUNE", "0")
    assert _resolve(autotune, "unrolled") == "unrolled"
    monkeypatch.delenv("PNT_NMFD_AUTOTUNE")
    for h in ("stream", "conv"):
        assert _resolve(autotune, h) == h  # only unrolled is timed
    assert not autotune._MEASURED
    times.update(unrolled=1.0, conv=0.95)  # within the margin
    assert _resolve(autotune, "unrolled") == "unrolled"
    key = autotune._halo_key("cpu", *ROW, 1.0, False)
    assert autotune._MEASURED[key] == {"unrolled": 1.0, "conv": 0.95}
    autotune.clear_cache()
    times.update(conv=0.8)
    assert _resolve(autotune, "unrolled") == "conv"
    times.clear()  # a cached winner is not timed again
    assert _resolve(autotune, "unrolled") == "conv"


def test_halo_mode_kernel_path_rules(tuner, monkeypatch):
    """On the kernel path (a CUDA float32 fit): ``fused`` below the
    threshold, timed against ``fused_w`` above it, never a library mode;
    the EM fits keep ``fused`` untimed; ``PNT_NMFD_PALLAS=0`` leaves the
    kernel path."""
    autotune, times = tuner
    assert autotune._kernel_device("cuda", torch.float32)
    assert not autotune._kernel_device("cuda", torch.float64)
    assert not autotune._kernel_device("cpu", torch.float32)
    monkeypatch.setenv("PNT_NMFD_PALLAS", "0")
    assert not autotune._kernel_device("cuda", torch.float32)
    monkeypatch.delenv("PNT_NMFD_PALLAS")
    monkeypatch.setattr(autotune, "_kernel_device", lambda d, t: True)
    monkeypatch.setattr(autotune, "_platform", lambda d: "card")
    for h in ("stream", "conv", "unrolled"):
        assert _resolve(autotune, h) == "fused"
    monkeypatch.setenv("PNT_AUTOTUNE_MIN_FLOPS", "1")
    times.update(fused=1.0, fused_w=0.95, unrolled=0.1, conv=0.1)
    assert _resolve(autotune, "unrolled") == "fused"
    key = autotune._halo_key("cpu", *ROW, 1.0, True)
    assert set(autotune._MEASURED[key]) == {"fused", "fused_w"}
    assert _resolve(autotune, "unrolled", em=True) == "fused"
    autotune.clear_cache()
    times.update(fused_w=0.5)
    assert _resolve(autotune, "conv") == "fused_w"
    assert _resolve(autotune, "conv", em=True) == "fused"


def test_halo_mode_tuner_times_the_local_step(monkeypatch):
    """Unpatched, above the threshold on the CPU: the tuner times the real
    per-shard step of ``unrolled`` and ``conv`` on the local problem and
    keeps one of them."""
    from pytorch_nmf_tpu_torch.ops import autotune

    monkeypatch.setattr(autotune, "_TARGET_S", 0.002)
    monkeypatch.setenv("PNT_AUTOTUNE_MIN_FLOPS", "1")
    for k in ("PNT_NMFD_AUTOTUNE", "PNT_NMFD_PALLAS", "PNT_AUTOTUNE_CACHE"):
        monkeypatch.delenv(k, raising=False)
    autotune.clear_cache()
    try:
        got = _resolve(autotune, "unrolled")
        key = autotune._halo_key("cpu", *ROW, 1.0, False)
        assert got in ("unrolled", "conv")
        assert set(autotune._MEASURED[key]) == {"unrolled", "conv"}
        assert all(t > 0 for t in autotune._MEASURED[key].values())
    finally:
        autotune.clear_cache()


def test_em_resolution_maps_stream_to_conv(monkeypatch):
    """The EM fits resolve only their own modes: where the heuristic says
    ``stream`` (``K·R > 4096``) they take ``conv``, as the JAX package's
    EM does; the MU fits keep ``stream``, the EM keeps ``unrolled`` and
    ``PNT_NMFD_PALLAS=1``'s ``fused``."""
    from pytorch_nmf_tpu_torch.ops import autotune
    from pytorch_nmf_tpu_torch.parallel import halo as th

    for k in ("PNT_NMFD_AUTOTUNE", "PNT_AUTOTUNE_MIN_FLOPS", "PNT_NMFD_PALLAS",
              "PNT_HALO_UNFOLD", "PNT_NMFD_UNFOLD_MAX_BYTES",
              "PNT_AUTOTUNE_CACHE"):
        monkeypatch.delenv(k, raising=False)
    autotune.clear_cache()
    long_k = (1, 6, (), 32, (9,), 512, 1.0, None, "cpu")
    assert th._halo_unfold_mode(1, (), 32, (9,), 512, "cpu") == "stream"
    assert th._resolve_halo_mode(None, False, *long_k) == "stream"
    assert th._resolve_halo_mode(None, True, *long_k) == "conv"
    short_k = (1, 6, (), 40, (5,), 3, 1.0, None, "cpu")
    assert th._resolve_halo_mode(None, True, *short_k) == "unrolled"
    monkeypatch.setenv("PNT_NMFD_PALLAS", "1")
    assert th._resolve_halo_mode(None, True, *long_k) == "fused"
    monkeypatch.setenv("PNT_NMFD_PALLAS", "0")
    monkeypatch.setenv("PNT_NMFD_UNFOLD_MAX_BYTES", "1000")
    assert th._halo_unfold_mode(1, (), 40, (5,), 3, "cpu") == "conv"
    assert th._resolve_halo_mode(None, True, *short_k) == "conv"


def test_forced_mode_must_be_the_fits_own():
    """A forced per-shard mode is one of the fit's: the EM has no
    ``fused_w`` or ``stream``."""
    from pytorch_nmf_tpu_torch.parallel import halo as th

    args = (1, 6, (), 40, (5,), 3, 1.0, None, "cpu")
    for em, mode in ((True, "fused_w"), (True, "stream"), (False, "pallas")):
        with pytest.raises(ValueError, match="per-shard mode"):
            th._resolve_halo_mode(mode, em, *args)
    assert th._resolve_halo_mode("conv", True, *args) == "conv"


def test_local_run_modes_agree():
    """One rank's step without collectives (what the tuner times) gives
    the same factors in every mode."""
    from pytorch_nmf_tpu_torch.parallel import halo as th

    rs = np.random.RandomState(5)
    V = torch.from_numpy(rs.rand(1, 4, 30).astype("f") + 0.01)
    W = torch.from_numpy(rs.rand(4, 3, 6).astype("f") + 0.1)
    H = torch.from_numpy(rs.rand(1, 3, 30).astype("f") + 0.1)
    outs = {m: th._local_run(m, V, W, H, 0.5)(3) for m in th.MU_MODES}
    for m, h in outs.items():
        _close(h.numpy(), outs["fused"].numpy(), 1e-6, m)


# --------------------------------------------------------------------------
# on the card: 2 gloo ranks sharing cuda:0
# --------------------------------------------------------------------------
CUDA_MODES = ("fused_w", "stream", "unrolled", "conv")


@pytest.fixture(scope="module")
def port_cuda(tmp_path_factory):
    """The NMFD problem in each mode through 2 gloo ranks on card 0, and
    its single-card fit (rank 0 alone)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    prob = _deconv_problem(80, 1, 64, 8, (512,), (16,))
    kw = dict(beta=0.5, tol=0, max_iter=6)
    cases = [dict(name=f"cuda_{m}", kind="deconv", nd=1, mode=m,
                  axes={"seq": 2}, device="cuda", kw=kw) for m in CUDA_MODES]
    cases.append(dict(name="cuda_single", kind="single", model="NMFD",
                      axes={"seq": 1}, device="cuda", kw=kw))
    arrays = {f"{c['name']}:{k}": v for c in cases for k, v in prob.items()}
    return run_group(tmp_path_factory.mktemp("torch_halo_modes_cuda"), 2,
                     cases, arrays)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", CUDA_MODES)
def test_cuda_halo_mode_launches(port_cuda, mode):
    """``fused_w`` launches B4 once an iteration and no B3; the library
    modes launch neither; each ends within 1e-4 of the single-card fit."""
    got = _got(port_cuda, f"cuda_{mode}")
    ref = port_cuda[0]["cuda_single"]
    assert int(got["n_iter"]) == int(ref["n_iter"]) == 6
    b4 = 6 if mode == "fused_w" else 0
    assert [int(x) for x in got["launches"]] == [0, 0, 0, b4]
    for key in ("W", "H"):
        _close(got[key], ref[key], rtol=1e-4, what=key)

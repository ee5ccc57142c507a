"""bfloat16 target storage in the port: a bfloat16 V against float32
factors stays bfloat16 (half the memory) through every fit that takes a
dense V, and each fit equals the JAX package's fit on the same bfloat16 V.

Every fit here runs the port on the CPU against the JAX package on the
CPU, from the same numpy target (rounded to bfloat16 by both) and explicit
inits.  Tolerance: 1e-5 relative (to each element, above 1e-6) after
10-30 iterations, with the same ``n_iter``: the float32 reorderings of two
frameworks, which the bfloat16 V does not change (its upcast is exact; the
JAX package's bfloat16 intermediates, such as ``log(V + eps)`` in the KL
loss, the port computes in bfloat16 too).  The port's bfloat16 fit also
equals its float32 fit on the rounded V (``V.bfloat16().float()``).
"""

import warnings

import numpy as np
import pytest
import torch

from _torch_parallel_child import run_group
from pytorch_nmf_tpu_torch import functional as F
from pytorch_nmf_tpu_torch.models._common import target_like, to_param
from pytorch_nmf_tpu_torch.nmf import NMF, NMF2D, NMFD
from pytorch_nmf_tpu_torch.ops import fast_nmf, fused_mu
from pytorch_nmf_tpu_torch.plca import PLCA, SIPLCA
from pytorch_nmf_tpu_torch.utils import checkpoint as ckpt

RTOL, FLOOR = 1e-5, 1e-6
ITERS = 20
BETAS = [0, 0.5, 1, 1.5, 2]


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side: its modules and ``jnp``."""
    jnp = pytest.importorskip("jax.numpy")
    from types import SimpleNamespace

    from pytorch_nmf_tpu import functional, nmf, plca
    from pytorch_nmf_tpu.utils import checkpoint

    return SimpleNamespace(jnp=jnp, nmf=nmf, plca=plca, F=functional,
                           ckpt=checkpoint,
                           bf16=lambda x: jnp.asarray(x, jnp.bfloat16))


def _bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x)).bfloat16()


def _close(got, ref, what=""):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    rel = np.abs(got - ref) / np.maximum(np.abs(ref), FLOOR)
    assert rel.max() <= RTOL, (what, float(rel.max()))


def _nmf_problem(seed=1, M=96, K=48, R=8):
    rs = np.random.RandomState(seed)
    return (np.abs(rs.randn(M, K)).astype("f") + 0.01,
            rs.rand(K, R).astype("f") + 0.1, rs.rand(M, R).astype("f") + 0.1)


def _deconv_problem(nd, seed=2):
    rs = np.random.RandomState(seed)
    if nd == 1:
        S_out, kernel, C, R = (80,), (5,), 12, 3
    else:
        S_out, kernel, C, R = (10, 12), (3, 4), 2, 3
    S_in = tuple(s - k + 1 for s, k in zip(S_out, kernel))
    return (rs.rand(1, C, *S_out).astype("f") + 0.01,
            rs.rand(C, R, *kernel).astype("f") + 0.1,
            rs.rand(1, R, *S_in).astype("f") + 0.1)


def _plca_problem(nd=0, seed=3):
    """A normalized start, as the models' constructors leave one."""
    if nd == 0:
        V, W, H = _nmf_problem(seed, 40, 30, 4)
        W, H = W / W.sum(0), H / H.sum(0)
    else:
        V, W, H = _deconv_problem(1, seed)
        W = W / W.sum((0, 2), keepdims=True)
        H = H / H.sum((0, 2), keepdims=True)
    R = W.shape[1]
    return V, W, H, np.full(R, 1.0 / R, "f")


# --------------------------------------------------------------------------
# the dtype rule
# --------------------------------------------------------------------------
@pytest.mark.parametrize("v_dtype, f_dtype, want", [
    (torch.bfloat16, torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.float64, torch.float64),
    (torch.float16, torch.float32, torch.float32),
    (torch.float32, torch.float32, torch.float32),
    (torch.float64, torch.float64, torch.float64),
    (torch.int32, torch.float32, torch.float32),
])
def test_target_dtype_rule(v_dtype, f_dtype, want):
    """The JAX package's ``to_f32``: bfloat16 stays against float32
    factors; every other dtype becomes the factors'."""
    V = torch.arange(12, dtype=torch.float32).reshape(3, 4).to(v_dtype)
    W = torch.ones(4, 2, dtype=f_dtype)
    H = torch.ones(3, 2, dtype=f_dtype)
    got = target_like(V, W, H)
    assert got.dtype == want and torch.equal(got.double(), V.double())


def test_float64_target_still_warns():
    W, H = torch.ones(4, 2), torch.ones(3, 2)
    with pytest.warns(UserWarning, match="float64"):
        assert target_like(np.ones((3, 4)), W, H).dtype == torch.float32


def test_numpy_bfloat16_and_sparse_targets():
    """A numpy array of ``ml_dtypes.bfloat16`` (what a JAX bfloat16 array
    gives) is read as bfloat16; a sparse bfloat16 V becomes float32, as
    the JAX package's sparse targets are float32."""
    ml_dtypes = pytest.importorskip("ml_dtypes")
    V = np.random.RandomState(0).rand(5, 7).astype("f")
    W, H = torch.ones(7, 2), torch.ones(5, 2)
    got = target_like(V.astype(ml_dtypes.bfloat16), W, H)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, torch.from_numpy(V).bfloat16())
    S = torch.from_numpy(V).bfloat16().to_sparse()
    assert target_like(S, W, H).dtype == torch.float32


def test_bf16_factors_promote_to_f32():
    """bfloat16 is a target-storage knob only: bfloat16 factors become
    float32, in the models and in the functional API."""
    V, W0, H0 = _nmf_problem()
    m = NMF(W=_bf16(W0), H=_bf16(H0), device="cpu")
    assert m.W.dtype == m.H.dtype == torch.float32
    assert m.fit(_bf16(V), beta=1, tol=0, max_iter=5) == 5
    W, H, _ = F.nmf_fit(_bf16(V), _bf16(W0), _bf16(H0), beta=2, tol=0,
                        max_iter=5)
    assert W.dtype == H.dtype == torch.float32
    assert to_param(_bf16(W0), "cpu").dtype == torch.float32


# --------------------------------------------------------------------------
# dense NMF
# --------------------------------------------------------------------------
@pytest.mark.parametrize("beta", BETAS)
@pytest.mark.parametrize("tol, max_iter", [(0, 30), (1e-2, 60)])
def test_nmf_fit_matches_jax(jx, beta, tol, max_iter):
    V, W0, H0 = _nmf_problem()
    ref = jx.nmf.NMF(W=W0, H=H0)
    n_ref = ref.fit(jx.bf16(V), beta, tol, max_iter)
    port = NMF(W=W0, H=H0, device="cpu")
    n = port.fit(_bf16(V), beta, tol, max_iter)
    assert n == n_ref and (tol == 0 or n < max_iter)
    _close(port.W, ref.W.data, "W")
    _close(port.H, ref.H.data, "H")
    assert port.W.dtype == torch.float32


@pytest.mark.parametrize("beta", BETAS)
def test_bf16_fit_is_the_f32_fit_on_the_rounded_v(beta):
    V, W0, H0 = _nmf_problem()
    a = NMF(W=W0, H=H0, device="cpu")
    b = NMF(W=W0, H=H0, device="cpu")
    assert a.fit(_bf16(V), beta, 0, ITERS) == b.fit(_bf16(V).float(), beta,
                                                    0, ITERS)
    assert torch.equal(a.W, b.W) and torch.equal(a.H, b.H)


@pytest.mark.parametrize("beta", [1, 0.5, 2])
def test_updaters_receive_the_bf16_v(monkeypatch, beta):
    """The V every updater and loss of the dense fit reads is bfloat16."""
    seen = set()
    real = fast_nmf.nmf_updater_factory_plain

    def spying(*args):
        ups = real(*args)

        def spy(fn):
            def call(V, *rest):
                seen.add(V.dtype)
                return fn(V, *rest)
            return call

        return tuple(spy(u) for u in ups)

    monkeypatch.setattr(fast_nmf, "nmf_updater_factory_plain", spying)
    V, W0, H0 = _nmf_problem()
    m = NMF(W=W0, H=H0, device="cpu")
    m.fit(_bf16(V), beta, 0, 10)
    assert seen == {torch.bfloat16}


def test_cpu_wrappers_take_a_bf16_v():
    """On CPU tensors the B1/B2 wrappers run their plain versions, which
    read a bfloat16 V upcast, and count no launch."""
    V, W, H = (torch.from_numpy(x) for x in _nmf_problem())
    n = (fused_mu.fused_contractions.launches_bf16,
         fused_mu.fused_beta_loss.launches_bf16)
    neg, pos = fused_mu.w_side_contractions(V.bfloat16(), H, W, 0.5)
    ref = fused_mu.plain_contractions(V.bfloat16().float(), H, W, beta=0.5,
                                      need_pos=True, w_side=True)
    assert torch.equal(neg, ref[0]) and torch.equal(pos, ref[1])
    fused_mu.fused_beta_loss(V.bfloat16(), H, W, 0.5)
    assert (fused_mu.fused_contractions.launches_bf16,
            fused_mu.fused_beta_loss.launches_bf16) == n


# --------------------------------------------------------------------------
# the other fits that take a dense V
# --------------------------------------------------------------------------
@pytest.mark.parametrize("model, nd, beta", [("NMFD", 1, 1), ("NMFD", 1, 2),
                                             ("NMFD", 1, 0.5),
                                             ("NMF2D", 2, 1)])
def test_deconv_fit_matches_jax(jx, model, nd, beta):
    V, W0, H0 = _deconv_problem(nd)
    ref = getattr(jx.nmf, model)(W=W0, H=H0)
    n_ref = ref.fit(jx.bf16(V), beta, 0, ITERS)
    port = {"NMFD": NMFD, "NMF2D": NMF2D}[model](W=W0, H=H0, device="cpu")
    assert port.fit(_bf16(V), beta, 0, ITERS) == n_ref
    _close(port.W, ref.W.data, "W")
    _close(port.H, ref.H.data, "H")
    f32 = {"NMFD": NMFD, "NMF2D": NMF2D}[model](W=W0, H=H0, device="cpu")
    f32.fit(_bf16(V).float(), beta, 0, ITERS)
    torch.testing.assert_close(port.W, f32.W, rtol=1e-6, atol=0)


@pytest.mark.parametrize("model, nd", [("PLCA", 0), ("SIPLCA", 1)])
def test_plca_fit_matches_jax(jx, model, nd):
    """PLCA normalizes V by its sum in V's dtype (``Vn`` is bfloat16, as in
    the JAX package); ``norm`` comes back bfloat16 too."""
    V, W0, H0, Z0 = _plca_problem(nd)
    ref = getattr(jx.plca, model)(W=W0, H=H0, Z=Z0)
    n_ref, norm_ref = ref.fit(jx.bf16(V), tol=0, max_iter=ITERS)
    port = {"PLCA": PLCA, "SIPLCA": SIPLCA}[model](W=W0, H=H0, Z=Z0,
                                                    device="cpu")
    n, norm = port.fit(_bf16(V), tol=0, max_iter=ITERS)
    assert n == n_ref and norm.dtype == torch.bfloat16
    assert float(norm) == float(norm_ref)
    for p, r in ((port.W, ref.W.data), (port.H, ref.H.data),
                 (port.Z, ref.Z.data)):
        _close(p, r)


def test_hoyer_fit_matches_jax(jx):
    V, W0, H0 = _nmf_problem(4, 40, 30, 4)
    ref = jx.nmf.NMF(W=W0, H=H0)
    ref.sparse_fit(jx.bf16(V), 1, 5, sW=0.5)
    port = NMF(W=W0, H=H0, device="cpu")
    assert port.sparse_fit(_bf16(V), 1, 5, sW=0.5) == 5
    _close(port.W, ref.W.data, "W")
    _close(port.H, ref.H.data, "H")


def test_hoyer_fit_at_beta2_is_the_f32_fit():
    """At β=2 the unconstrained factor's MU step reads V itself as its
    cotangent; the port promotes it (the JAX package's VJP refuses a
    bfloat16 cotangent there)."""
    V, W0, H0 = _nmf_problem(4, 40, 30, 4)
    a = NMF(W=W0, H=H0, device="cpu")
    b = NMF(W=W0, H=H0, device="cpu")
    a.sparse_fit(_bf16(V), 2, 5, sW=0.5)
    b.sparse_fit(_bf16(V).float(), 2, 5, sW=0.5)
    assert torch.equal(a.W, b.W) and torch.equal(a.H, b.H)


def test_functional_fits_match_jax(jx):
    V, W0, H0 = _nmf_problem(5, 40, 30, 4)
    Wr, Hr, nr = jx.F.nmf_fit(jx.bf16(V), W0, H0, beta=1, tol=0,
                              max_iter=ITERS)
    W, H, n = F.nmf_fit(_bf16(V), torch.from_numpy(W0), torch.from_numpy(H0),
                        beta=1, tol=0, max_iter=ITERS)
    assert n == int(nr)
    _close(W, Wr, "W")
    _close(H, Hr, "H")


@pytest.mark.parametrize("beta", [1, 2])
def test_batched_fit_matches_jax(jx, beta):
    V, W0, H0 = _nmf_problem(6, 40, 30, 4)
    Vs = np.stack([V, 0.5 * V + 0.2])
    Ws, Hs = np.stack([W0, W0[::-1]]), np.stack([H0, H0[::-1]])
    Wr, Hr, nr = jx.F.nmf_fit_batched(jx.bf16(Vs), Ws, Hs, beta=beta, tol=0,
                                      max_iter=ITERS)
    W, H, n = F.nmf_fit_batched(_bf16(Vs), torch.from_numpy(Ws.copy()),
                                torch.from_numpy(Hs.copy()), beta=beta, tol=0,
                                max_iter=ITERS)
    assert n.tolist() == np.asarray(nr).tolist()
    _close(W, Wr, "W")
    _close(H, Hr, "H")


@pytest.mark.parametrize("host", ["torch", "ml_dtypes"])
@pytest.mark.parametrize("beta", [1, 0.5, 2])
def test_streaming_fit_matches_jax(jx, host, beta):
    """A bfloat16 host V (a torch tensor, or numpy ``ml_dtypes.bfloat16``)
    streams at half width; the JAX package streams its host dtype."""
    V, W0, H0 = _nmf_problem(7, 40, 30, 4)
    Vj = np.asarray(jx.bf16(V))
    Wr, Hr, nr = jx.F.streaming_nmf_fit(Vj, W0, H0, beta=beta, tol=0,
                                        max_iter=ITERS, row_block=16)
    Vh = _bf16(V) if host == "torch" else Vj
    W, H, n = F.streaming_nmf_fit(Vh, torch.from_numpy(W0),
                                  torch.from_numpy(H0), beta=beta, tol=0,
                                  max_iter=ITERS, row_block=16)
    assert n == int(nr)
    _close(W, Wr, "W")
    _close(H, Hr, "H")


def test_streaming_blocks_are_bf16(monkeypatch):
    from pytorch_nmf_tpu_torch.ops import streaming

    seen = set()
    real = streaming._Blocks.__iter__

    def spy(self):
        for b, Vb in real(self):
            seen.add(Vb.dtype)
            yield b, Vb

    monkeypatch.setattr(streaming._Blocks, "__iter__", spy)
    V, W0, H0 = _nmf_problem(7, 40, 30, 4)
    F.streaming_nmf_fit(_bf16(V), torch.from_numpy(W0), torch.from_numpy(H0),
                        beta=1, tol=0, max_iter=2, row_block=16)
    assert seen == {torch.bfloat16}


def test_checkpointed_fits_match_jax(jx, tmp_path):
    V, W0, H0 = _nmf_problem(8, 40, 30, 4)
    ref = jx.nmf.NMF(W=W0, H=H0)
    nr = jx.ckpt.checkpointed_fit(ref, jx.bf16(V), beta=1, tol=0,
                                  max_iter=ITERS, every=10,
                                  directory=str(tmp_path / "jax"))
    port = NMF(W=W0, H=H0, device="cpu")
    n = ckpt.checkpointed_fit(port, _bf16(V), beta=1, tol=0, max_iter=ITERS,
                              every=10, directory=str(tmp_path / "port"))
    assert n == nr
    _close(port.W, ref.W.data, "W")
    _close(port.H, ref.H.data, "H")

    V, W0, H0, Z0 = _plca_problem(0, 9)
    ref = jx.plca.PLCA(W=W0, H=H0, Z=Z0)
    nr, norm_ref = jx.ckpt.checkpointed_plca_fit(
        ref, jx.bf16(V), tol=0, max_iter=ITERS, every=10,
        directory=str(tmp_path / "jax_plca"))
    port = PLCA(W=W0, H=H0, Z=Z0, device="cpu")
    n, norm = ckpt.checkpointed_plca_fit(
        port, _bf16(V), tol=0, max_iter=ITERS, every=10,
        directory=str(tmp_path / "port_plca"))
    assert n == nr and float(norm) == float(norm_ref)
    _close(port.W, ref.W.data, "W")
    _close(port.H, ref.H.data, "H")


# --------------------------------------------------------------------------
# the sharded fit: 2 gloo ranks, each keeping its block of V in bfloat16
# --------------------------------------------------------------------------
SHARDED_BETAS = (2, 1, 0.5)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    cases, arrays = [], {}

    def add(name, case, inputs):
        cases.append(dict(case, name=name, bf16=["V"]))
        arrays.update({f"{name}:{k}": v for k, v in inputs.items()})

    for i, beta in enumerate(SHARDED_BETAS):
        V, W, H = _nmf_problem(20 + i, 40, 24, 4)
        add(f"bf16_nmf_b{beta}", {"kind": "nmf", "axes": {"data": 2},
                                  "kw": {"beta": beta, "tol": 0,
                                         "max_iter": 10}},
            {"V": V, "W": W, "H": H})
    V, W, H = _deconv_problem(1, 25)
    add("bf16_nmfd", {"kind": "deconv", "nd": 1, "axes": {"seq": 2},
                      "kw": {"beta": 1, "tol": 0, "max_iter": 10}},
        {"V": V, "W": W, "H": H})
    V, W, H, Z = _plca_problem(0, 26)
    add("bf16_plca", {"kind": "plca", "axes": {"data": 2},
                      "kw": {"tol": 0, "max_iter": 10}},
        {"V": V, "W": W, "H": H, "Z": Z})
    return run_group(tmp_path_factory.mktemp("torch_bf16"), 2, cases,
                     arrays), arrays


def _sharded_got(sharded, name):
    port, arrays = sharded
    got = port[0][name]
    for k, v in got.items():
        np.testing.assert_array_equal(port[1][name][k], v, err_msg=k)
    return got, {k.split(":", 1)[1]: v for k, v in arrays.items()
                 if k.startswith(name + ":")}


@pytest.mark.parametrize("beta", SHARDED_BETAS)
def test_sharded_nmf_fit_matches_jax(jx, sharded, beta):
    import jax

    from pytorch_nmf_tpu.parallel import make_mesh, sharded_nmf_fit

    got, inp = _sharded_got(sharded, f"bf16_nmf_b{beta}")
    assert bool(got["v_local_bf16"])
    mesh = make_mesh({"data": 2}, jax.devices()[:2])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        W, H, n = sharded_nmf_fit(jx.bf16(inp["V"]), inp["W"], inp["H"], mesh,
                                  beta=beta, tol=0, max_iter=10)
    assert int(got["n_iter"]) == int(n)
    _close(got["W"], np.asarray(W), "W")
    _close(got["H"], np.asarray(H), "H")


def test_sharded_nmfd_fit_matches_jax(jx, sharded):
    """The halo NMFD fit, each rank holding its chunk of V in bfloat16,
    against the JAX package's halo fit on the bfloat16 V."""
    import jax

    from pytorch_nmf_tpu.parallel import make_mesh, sharded_nmfd_fit

    got, inp = _sharded_got(sharded, "bf16_nmfd")
    mesh = make_mesh({"seq": 2}, jax.devices()[:2])
    W, H, n = sharded_nmfd_fit(jx.bf16(inp["V"]), inp["W"], inp["H"], mesh,
                               beta=1, tol=0, max_iter=10)
    assert int(got["n_iter"]) == int(n)
    _close(got["W"], np.asarray(W), "W")
    _close(got["H"], np.asarray(H), "H")


def test_sharded_plca_fit_matches_the_single_device_fit(jx, sharded):
    """The sharded PLCA fit sums V in float32 over the ranks (every
    collective carries float32) and rounds the sum to bfloat16 once, as the
    single-device fit's ``V.sum()``: it equals the JAX package's
    single-device fit on the bfloat16 V."""
    got, inp = _sharded_got(sharded, "bf16_plca")
    ref = jx.plca.PLCA(W=inp["W"], H=inp["H"], Z=inp["Z"])
    n, norm = ref.fit(jx.bf16(inp["V"]), tol=0, max_iter=10)
    assert int(got["n_iter"]) == int(n) and float(got["norm"]) == float(norm)
    for key, r in (("W", ref.W.data), ("H", ref.H.data), ("Z", ref.Z.data)):
        _close(got[key], np.asarray(r), key)

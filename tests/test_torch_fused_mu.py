"""The fused MU contractions (B1) and fused loss (B2) of the port.

* CPU: the wrappers' plain versions against the JAX package's Pallas
  kernels run through the Pallas interpreter, at the ragged 300×260×24 of
  ``tests/test_pallas.py`` and at rank 1.  Tolerance rtol 2e-5, that
  file's own: both are float32 sums of non-negative terms in another order.
* CUDA (marked ``cuda``, skipped without a card): the hand-written kernels
  against the plain versions on the card, rtol 1e-4 — f32 reordering over
  reductions of up to a few thousand terms.  JAX is imported only by the
  CPU tests, so on a GPU host without it the card's tests run alone:
  ``python -m pytest --noconftest -m cuda tests/test_torch_fused_mu.py``.
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pytorch_nmf_tpu_torch.ops import fused_mu  # noqa: E402
from pytorch_nmf_tpu_torch.ops import mu as tmu  # noqa: E402

M, K, R = 300, 260, 24
RTOL_JAX = 2e-5
RTOL_CUDA = 1e-4


def _inputs(m, k, r, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.rand(m, k).astype("f"), rs.rand(k, r).astype("f") + 0.1,
            rs.rand(m, r).astype("f") + 0.1)


@pytest.fixture(scope="module")
def data():
    return _inputs(M, K, R)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's kernels, run through the Pallas interpreter."""
    jnp = pytest.importorskip("jax.numpy")
    from pytorch_nmf_tpu.ops import mu
    from pytorch_nmf_tpu.ops.pallas_mu import _fused_contractions, fused_beta_loss

    return SimpleNamespace(jnp=jnp, mu=mu, contractions=_fused_contractions,
                           beta_loss=fused_beta_loss)


def _mu_pos(w_side, W, H, lib):
    """The analytic β=1 denominator the solver hands the epilogue."""
    return lib.kl_pos_W(H) if w_side else lib.kl_pos_H(W).reshape(1, -1)


def _jax_contractions(jx, V, W, H, beta, need_pos, w_side, epilogue):
    Vj, Wj, Hj = map(jx.jnp.asarray, (V, W, H))
    mu_pos = _mu_pos(w_side, Wj, Hj, jx.mu) if epilogue else None
    return jx.contractions(Vj, Hj, Wj, beta=beta, need_pos=need_pos,
                           w_side=w_side, mu_pos=mu_pos, interpret=True)


def _torch_contractions(V, W, H, beta, need_pos, w_side, epilogue, fn,
                        device="cpu"):
    Vt, Wt, Ht = (torch.from_numpy(x).to(device) for x in (V, W, H))
    mu_pos = _mu_pos(w_side, Wt, Ht, tmu) if epilogue else None
    return fn(Vt, Ht, Wt, beta=beta, need_pos=need_pos, w_side=w_side,
              mu_pos=mu_pos)


# (beta, need_pos, epilogue): every call the dense fit makes, and β=3
CONTRACTION_CASES = [
    (0.0, True, False),
    (0.5, True, False),
    (1.0, False, False),
    (1.5, True, False),
    (3.0, True, False),
    (1.0, False, True),
]


@pytest.mark.parametrize("beta, need_pos, epilogue", CONTRACTION_CASES)
@pytest.mark.parametrize("w_side", [True, False])
def test_plain_contractions_match_jax_kernel(jx, data, beta, need_pos,
                                             epilogue, w_side):
    V, W, H = data
    neg, pos = _torch_contractions(V, W, H, beta, need_pos, w_side, epilogue,
                                   fused_mu.fused_contractions)
    rneg, rpos = _jax_contractions(jx, V, W, H, beta, need_pos, w_side, epilogue)
    assert tuple(neg.shape) == ((K, R) if w_side else (M, R))
    np.testing.assert_allclose(neg.numpy(), np.asarray(rneg), rtol=RTOL_JAX)
    if need_pos:
        np.testing.assert_allclose(pos.numpy(), np.asarray(rpos), rtol=RTOL_JAX)
    else:
        assert pos is None and rpos is None


@pytest.mark.parametrize("w_side", [True, False])
def test_plain_rank_one_matches_jax_kernel(jx, w_side):
    V, W, H = _inputs(70, 50, 1, seed=1)
    neg, _ = _torch_contractions(V, W, H, 1.0, False, w_side, False,
                                 fused_mu.fused_contractions)
    rneg, _ = _jax_contractions(jx, V, W, H, 1.0, False, w_side, False)
    np.testing.assert_allclose(neg.numpy(), np.asarray(rneg), rtol=RTOL_JAX)


@pytest.mark.parametrize("beta", [2.0, 1.0, 0.0, 0.5, -1.0])
def test_plain_loss_matches_jax_kernel(jx, data, beta):
    V, W, H = data
    got = fused_mu.fused_beta_loss(*(torch.from_numpy(x) for x in (V, H, W)),
                                   beta)
    ref = jx.beta_loss(*(jx.jnp.asarray(x) for x in (V, H, W)), beta,
                       interpret=True)
    np.testing.assert_allclose(float(got), float(ref), rtol=RTOL_JAX)


@pytest.mark.parametrize("beta, need_pos, epilogue", CONTRACTION_CASES)
@pytest.mark.parametrize("w_side", [True, False])
def test_plain_bf16_contractions_match_jax_kernel(jx, data, beta, need_pos,
                                                  epilogue, w_side):
    """A bfloat16 V: the plain version (which upcasts V) against the JAX
    package's kernel on the same bfloat16 V, which promotes it."""
    V, W, H = data
    Vt = torch.from_numpy(V).bfloat16()
    mu_pos = _mu_pos(w_side, torch.from_numpy(W), torch.from_numpy(H),
                     tmu) if epilogue else None
    neg, pos = fused_mu.fused_contractions(
        Vt, torch.from_numpy(H), torch.from_numpy(W), beta=beta,
        need_pos=need_pos, w_side=w_side, mu_pos=mu_pos)
    Vj = jx.jnp.asarray(V, jx.jnp.bfloat16)
    Wj, Hj = jx.jnp.asarray(W), jx.jnp.asarray(H)
    rneg, rpos = jx.contractions(
        Vj, Hj, Wj, beta=beta, need_pos=need_pos, w_side=w_side,
        mu_pos=_mu_pos(w_side, Wj, Hj, jx.mu) if epilogue else None,
        interpret=True)
    assert neg.dtype == torch.float32
    np.testing.assert_allclose(neg.numpy(), np.asarray(rneg), rtol=RTOL_JAX)
    if need_pos:
        np.testing.assert_allclose(pos.numpy(), np.asarray(rpos), rtol=RTOL_JAX)


@pytest.mark.parametrize("beta", [2.0, 1.0, 0.0, 0.5])
def test_plain_bf16_loss_matches_jax_kernel(jx, data, beta):
    """B2's plain version with a bfloat16 V against the JAX package's kernel
    on it.  (At β < 0 the JAX kernel raises V+eps to β in bfloat16, which
    rounds; the port's kernel and its plain version upcast V first, so they
    equal the float32 loss on the rounded V: the next test.)"""
    V, W, H = data
    got = fused_mu.fused_beta_loss(torch.from_numpy(V).bfloat16(),
                                   torch.from_numpy(H), torch.from_numpy(W),
                                   beta)
    ref = jx.beta_loss(jx.jnp.asarray(V, jx.jnp.bfloat16), jx.jnp.asarray(H),
                       jx.jnp.asarray(W), beta, interpret=True)
    np.testing.assert_allclose(float(got), float(ref), rtol=RTOL_JAX)


@pytest.mark.parametrize("beta", [2.0, 1.0, 0.0, 0.5, -1.0])
def test_plain_bf16_is_the_f32_version_on_the_rounded_v(data, beta):
    """The plain versions read a bfloat16 V as its exact float32 upcast."""
    V, W, H = (torch.from_numpy(x) for x in data)
    Vb = V.bfloat16()
    torch.testing.assert_close(fused_mu.plain_beta_loss(Vb, H, W, beta),
                               fused_mu.plain_beta_loss(Vb.float(), H, W,
                                                        beta), rtol=0, atol=0)
    for w_side in (True, False):
        kw = dict(beta=beta, need_pos=beta != 1, w_side=w_side)
        got = fused_mu.plain_contractions(Vb, H, W, **kw)
        ref = fused_mu.plain_contractions(Vb.float(), H, W, **kw)
        for g, r in zip(got, ref):
            torch.testing.assert_close(g, r, rtol=0, atol=0)


def test_operand_check_takes_a_bf16_v_only(data):
    """The kernels take V in float32 or bfloat16, H and W in float32."""
    V, W, H = (torch.from_numpy(x) for x in data)
    assert fused_mu._check_operands(V.bfloat16(), H, W) == (M, K, R)
    for args in ((V.half(), H, W), (V.bfloat16(), H.bfloat16(), W),
                 (V.double(), H, W)):
        with pytest.raises(TypeError):
            fused_mu._check_operands(*args)


@pytest.mark.parametrize("n", [1025, 4097, 88, 3])
def test_padded_bf16_rows_keep_values(n):
    """A bfloat16 V's rows pad to a multiple of 8 values (16 bytes), on a
    copy whose dtype may change on the way (``aligned_copy``)."""
    x = torch.from_numpy(np.random.RandomState(n).rand(5, n).astype("f"))
    p = fused_mu.aligned_copy(x, "cpu", torch.bfloat16)
    assert p.dtype == torch.bfloat16 and p.shape == x.shape
    assert p.stride(0) % 8 == 0 and p.stride(0) - n < 8 and p.stride(1) == 1
    assert torch.equal(p, x.bfloat16()) and p.data_ptr() % 16 == 0
    q = fused_mu._padded(x.bfloat16())
    assert q.stride(0) == p.stride(0) and torch.equal(q, p)


def test_side_wrappers_are_the_contraction(data):
    V, W, H = (torch.from_numpy(x) for x in data)
    for wrapper, w_side in ((fused_mu.w_side_contractions, True),
                            (fused_mu.h_side_contractions, False)):
        neg, pos = wrapper(V, H, W, 0.5)
        ref = fused_mu.plain_contractions(V, H, W, beta=0.5, need_pos=True,
                                          w_side=w_side)
        torch.testing.assert_close(neg, ref[0], rtol=0, atol=0)
        torch.testing.assert_close(pos, ref[1], rtol=0, atol=0)


def test_epilogue_excludes_need_pos(data):
    V, W, H = (torch.from_numpy(x) for x in data)
    with pytest.raises(ValueError):
        fused_mu.fused_contractions(V, H, W, beta=1.0, need_pos=True,
                                    w_side=True, mu_pos=tmu.kl_pos_W(H))


@pytest.mark.parametrize("n", [1025, 88, 3])
def test_padded_rows_keep_values(n):
    """The kernels copy rows in 16-byte pieces: ``_padded`` keeps the values
    and pads each row to a multiple of 4 floats with zeros; a CPU tensor
    passes ``aligned_rows`` as it is."""
    x = torch.from_numpy(np.random.RandomState(n).rand(5, n).astype("f"))
    p = fused_mu._padded(x)
    assert p.shape == x.shape and p.stride(0) % 4 == 0 and p.stride(1) == 1
    assert torch.equal(p, x) and p.data_ptr() % 16 == 0
    full = p.as_strided((5, p.stride(0)), (p.stride(0), 1))
    assert not bool(full[:, n:].any())
    assert fused_mu.aligned_rows(x) is x
    F, G = fused_mu._factor_rows(x, x[:, :n])
    assert F.stride(0) == G.stride(0)


def test_cpu_tensors_never_launch(data):
    V, W, H = (torch.from_numpy(x) for x in data)
    before = (fused_mu.fused_contractions.launches,
              fused_mu.fused_beta_loss.launches)
    fused_mu.w_side_contractions(V, H, W, 1.5)
    fused_mu.fused_beta_loss(V, H, W, 1.5)
    assert (fused_mu.fused_contractions.launches,
            fused_mu.fused_beta_loss.launches) == before


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return "cuda"


# ragged, exact-tile, rank 1, R=88 (not a multiple of 4), wide ranks, and
# ranks over 256 (more than one block of rank columns, the last one ragged)
CUDA_SHAPES = [(300, 260, 24), (256, 128, 16), (70, 50, 1), (517, 1025, 88),
               (64, 96, 160), (200, 300, 256), (90, 70, 512), (130, 90, 301)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CUDA_SHAPES)
@pytest.mark.parametrize("beta, need_pos, epilogue", CONTRACTION_CASES)
@pytest.mark.parametrize("w_side", [True, False])
def test_cuda_contractions_match_plain(cuda, shape, beta, need_pos, epilogue,
                                       w_side):
    V, W, H = _inputs(*shape)
    got = _torch_contractions(V, W, H, beta, need_pos, w_side, epilogue,
                              fused_mu.fused_contractions, cuda)
    ref = _torch_contractions(V, W, H, beta, need_pos, w_side, epilogue,
                              fused_mu.plain_contractions, cuda)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert (g is None) == (r is None)
        if g is not None:
            assert g.is_cuda and g.shape == r.shape
            torch.testing.assert_close(g, r, rtol=RTOL_CUDA, atol=0)


# the tile edges of the tensor-core contraction (64 F rows, 32-row G steps,
# 8-column rank tiles, 128 rank columns a block): ranks 1, 3, 13, 88 and
# 257 (three rank blocks, the last one column wide), dimensions of 1025;
# a G extent of 30 runs one split on the H side and many on the W side;
# every branch of the cotangents, β=2 included
TILE_EDGE_SHAPES = [(1025, 30, 1), (30, 1025, 3), (1025, 1025, 13),
                    (1025, 517, 88), (300, 1025, 257)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", TILE_EDGE_SHAPES)
@pytest.mark.parametrize("beta, need_pos, epilogue",
                         CONTRACTION_CASES + [(2.0, True, False)])
@pytest.mark.parametrize("w_side", [True, False])
def test_cuda_contraction_tile_edges(cuda, shape, beta, need_pos, epilogue,
                                     w_side):
    test_cuda_contractions_match_plain(cuda, shape, beta, need_pos, epilogue,
                                       w_side)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CUDA_SHAPES)
@pytest.mark.parametrize("beta", [2.0, 1.0, 0.0, 0.5, 1.5, -1.0])
def test_cuda_loss_matches_plain(cuda, shape, beta):
    V, W, H = (torch.from_numpy(x).to(cuda) for x in _inputs(*shape))
    got = fused_mu.fused_beta_loss(V, H, W, beta)
    ref = fused_mu.plain_beta_loss(V, H, W, beta)
    torch.testing.assert_close(got, ref, rtol=RTOL_CUDA, atol=0)


# the tile edges of the loss on B1's kernel (64 H rows, 32-row W steps, the
# WH product rank-chunked above 256): M and K ragged, K = 1025 (rows the
# wrapper pads), ranks 1, 13, 88, 256 and 300
LOSS_EDGE_SHAPES = [(1025, 30, 1), (70, 1025, 13), (517, 1025, 88),
                    (130, 90, 256), (90, 70, 300)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", LOSS_EDGE_SHAPES)
@pytest.mark.parametrize("beta", [0.0, 0.5, 1.5, 3.0])
@pytest.mark.parametrize("offset", [0, 1])
def test_cuda_loss_tile_edges(cuda, shape, beta, offset):
    """``offset`` 1: V a view one float into its storage, so no row is
    16-byte aligned."""
    V, W, H = (torch.from_numpy(x).to(cuda) for x in _inputs(*shape))
    if offset:
        V = torch.cat([V.new_zeros(1), V.reshape(-1)])[1:].reshape(V.shape)
        assert V.data_ptr() % 16
    got = fused_mu.fused_beta_loss(V, H, W, beta)
    ref = fused_mu.plain_beta_loss(V, H, W, beta)
    torch.testing.assert_close(got, ref, rtol=RTOL_CUDA, atol=0)


# a bfloat16 V: ragged K (1025 and 4097 pad to 1032 and 4104 values), the
# main path's 5168×1025 at R=88, both sides, and rank 1
BF16_SHAPES = [(517, 1025, 88), (5168, 1025, 88), (300, 4097, 64),
               (1025, 30, 1), (70, 50, 13)]


def _bf16_inputs(shape, device):
    V, W, H = _inputs(*shape)
    return (torch.from_numpy(V).to(device).bfloat16(),
            torch.from_numpy(W).to(device), torch.from_numpy(H).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BF16_SHAPES)
@pytest.mark.parametrize("beta, need_pos, epilogue",
                         CONTRACTION_CASES + [(2.0, True, False)])
@pytest.mark.parametrize("w_side", [True, False])
def test_cuda_bf16_contractions_match_plain(cuda, shape, beta, need_pos,
                                            epilogue, w_side):
    """B1 reading a bfloat16 V against its plain version (V upcast), which
    equals the float32 kernel's input on the rounded V."""
    Vb, W, H = _bf16_inputs(shape, cuda)
    mu_pos = _mu_pos(w_side, W, H, tmu) if epilogue else None
    kw = dict(beta=beta, need_pos=need_pos, w_side=w_side, mu_pos=mu_pos)
    n = fused_mu.fused_contractions.launches
    got = fused_mu.fused_contractions(Vb, H, W, **kw)
    assert fused_mu.fused_contractions.launches == n + 1
    ref = fused_mu.plain_contractions(Vb, H, W, **kw)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert (g is None) == (r is None)
        if g is not None:
            assert g.dtype == torch.float32 and g.shape == r.shape
            torch.testing.assert_close(g, r, rtol=RTOL_CUDA, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BF16_SHAPES)
@pytest.mark.parametrize("beta", [2.0, 1.0, 0.0, 0.5, 1.5, -1.0])
@pytest.mark.parametrize("offset", [0, 1])
def test_cuda_bf16_loss_matches_plain(cuda, shape, beta, offset):
    """B2 reading a bfloat16 V; ``offset`` 1: V a view one value into its
    storage, so no row is 16-byte aligned and the wrapper pads it."""
    Vb, W, H = _bf16_inputs(shape, cuda)
    if offset:
        Vb = torch.cat([Vb.new_zeros(1), Vb.reshape(-1)])[1:].reshape(Vb.shape)
        assert Vb.data_ptr() % 16
    got = fused_mu.fused_beta_loss(Vb, H, W, beta)
    ref = fused_mu.plain_beta_loss(Vb, H, W, beta)
    torch.testing.assert_close(got, ref, rtol=RTOL_CUDA, atol=0)


@pytest.mark.cuda
def test_cuda_bf16_rejects_bf16_factors(cuda):
    Vb, W, H = _bf16_inputs((64, 48, 8), cuda)
    n = fused_mu.fused_contractions.launches
    with pytest.raises(TypeError):
        fused_mu.h_side_contractions(Vb, H.bfloat16(), W, 0.5)
    with pytest.raises(TypeError):
        fused_mu.fused_beta_loss(Vb.half(), H, W, 0.5)
    assert fused_mu.fused_contractions.launches == n


@pytest.mark.cuda
def test_cuda_wrappers_count_and_reject(cuda):
    V, W, H = (torch.from_numpy(x).to(cuda) for x in _inputs(64, 48, 8))
    n = fused_mu.fused_contractions.launches
    fused_mu.h_side_contractions(V, H, W, 0.5)
    assert fused_mu.fused_contractions.launches == n + 1
    with pytest.raises(TypeError):
        fused_mu.h_side_contractions(V.double(), H.double(), W.double(), 0.5)
    with pytest.raises(ValueError):
        fused_mu.h_side_contractions(V.T, H, W, 0.5)
    with pytest.raises(ValueError):
        fused_mu.h_side_contractions(V, H.cpu(), W, 0.5)
    assert fused_mu.fused_contractions.launches == n + 1

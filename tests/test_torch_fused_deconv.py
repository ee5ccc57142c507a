"""The deconv MU contractions B3 ``hgrad`` and B4 ``wgrad`` of the port, and
the flat layouts that feed them.

* CPU: the wrappers' plain versions against the JAX package's Pallas
  kernels run through the Pallas interpreter (``interpret=True``), at the
  shapes of ``tests/test_pallas.py``: ragged C, K not a multiple of the
  Pallas τ tile, odd ranks, two cotangents, the β=1 epilogue, the stacked
  N=2 layout (``lead_pad=False``) and a 2-D flat-offset ``geom``.  The
  tolerance is that file's own, ``atol = 2e-6·max|ref|``: both sides are
  float32 sums of the same non-negative products in another order.  The
  Pallas operand carries zero τ-tile rows past ``K·R``; the port's has none,
  so only the first ``K·R`` rows of the Pallas W side are compared.
* CUDA (marked ``cuda``, skipped without a card): the hand-written kernels
  against the plain versions on the card, ``max|kernel - plain| ≤
  1e-4·max|plain|``.  JAX is imported only by the CPU tests, so on a GPU
  host the card's tests run alone:
  ``python -m pytest --noconftest -m cuda tests/test_torch_fused_deconv.py``.
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pytorch_nmf_tpu_torch.ops import fast_nmfd as F  # noqa: E402
from pytorch_nmf_tpu_torch.ops import fused_deconv as D  # noqa: E402
from pytorch_nmf_tpu_torch.ops.mu import kl_pos_W  # noqa: E402

ATOL_JAX = 2e-6
RTOL_CUDA = 1e-4
TK = 16  # the Pallas kernels' τ tile

# (C, L_in, R, T): ragged C, T not a multiple of TK, odd and tiny ranks; a
# narrow copy of the reference demo's layout (R=3, a long kernel)
SHAPES_1D = [(17, 300, 8, 12), (33, 400, 16, 20), (7, 260, 3, 5),
             (65, 300, 3, 40)]


@pytest.fixture(scope="module")
def jx():
    """The JAX package's kernels and layout helpers."""
    jnp = pytest.importorskip("jax.numpy")
    from pytorch_nmf_tpu.ops import fast_nmfd, pallas_deconv

    return SimpleNamespace(jnp=jnp, pd=pallas_deconv, fd=fast_nmfd)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _w2f(W2, K, R):
    """The Pallas operand: ``W2`` padded with zero rows to whole τ tiles."""
    nkr = -(-K // TK)
    return np.pad(W2, ((0, (nkr * TK - K) * R), (0, 0)))


def _close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=ATOL_JAX * float(np.abs(ref).max()))


def _problem_1d(C, L_in, R, T, seed=0):
    rs = np.random.RandomState(seed)
    Lp = L_in + T - 1
    H = rs.rand(1, R, L_in).astype("f")
    W = rs.rand(C, R, T).astype("f")
    cots = [rs.rand(Lp, C).astype("f") for _ in range(2)]
    return H, W, cots


@pytest.mark.parametrize("C, L_in, R, T", SHAPES_1D)
def test_plain_hgrad_matches_jax_kernel(jx, C, L_in, R, T):
    H, W, (cot, _) = _problem_1d(C, L_in, R, T)
    W2 = F._w2(_t(W)).numpy()
    ref = jx.pd.hgrad(jx.jnp.asarray(cot), jx.jnp.asarray(_w2f(W2, T, R)), R,
                      TK, L_in, interpret=True)
    got = D.hgrad(_t(cot), _t(W2), R, L_in)
    assert tuple(got.shape) == (R, L_in)
    _close(got, ref)


@pytest.mark.parametrize("C, L_in, R, T", SHAPES_1D)
def test_plain_wgrad_pair_matches_jax_kernel(jx, C, L_in, R, T):
    H, W, cots = _problem_1d(C, L_in, R, T)
    H2 = H[0].T
    refs = jx.pd.wgrad([jx.jnp.asarray(c) for c in cots], jx.jnp.asarray(H2),
                       R, TK, T, interpret=True)
    gots = D.wgrad([_t(c) for c in cots], _t(H2), R, T)
    assert len(gots) == 2
    for got, ref in zip(gots, refs):
        assert tuple(got.shape) == (T * R, C)
        _close(got, np.asarray(ref)[:T * R])


def test_plain_wgrad_epilogue_matches_jax_kernel(jx):
    C, L_in, R, T = 33, 400, 16, 20
    H, W, (cot, _) = _problem_1d(C, L_in, R, T, seed=1)
    H2, W2 = H[0].T, F._w2(_t(W)).numpy()
    pos = kl_pos_W(_t(H)).reshape(-1)
    ref = jx.pd.wgrad([jx.jnp.asarray(cot)], jx.jnp.asarray(H2), R, TK, T,
                      mu_w2=jx.jnp.asarray(_w2f(W2, T, R)),
                      mu_pos=jx.jnp.asarray(pos.numpy()), interpret=True)[0]
    got = D.wgrad([_t(cot)], _t(H2), R, T, mu_w2=_t(W2), mu_pos=pos)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref)[:T * R], rtol=2e-6)


def _problem_stacked(N, C, L_in, R, T, seed=2):
    rs = np.random.RandomState(seed)
    H = rs.rand(N, R, L_in).astype("f")
    W = rs.rand(C, R, T).astype("f")
    cot = rs.rand(N, L_in + T - 1, C).astype("f")
    return H, W, cot


def test_stacked_layouts_match_jax(jx):
    N, C, L_in, R, T = 2, 9, 50, 3, 7
    H, _, cot = _problem_stacked(N, C, L_in, R, T)
    seg = T - 1 + L_in
    np.testing.assert_array_equal(
        F._h_stacked(_t(H), (T,), T).numpy(),
        np.asarray(jx.fd._h_stacked(jx.jnp.asarray(H), (T,), T)))
    np.testing.assert_array_equal(
        F._cot_stacked(_t(cot), seg).numpy(),
        np.asarray(jx.fd._cot_stacked(jx.jnp.asarray(cot), seg)))


def test_plain_kernels_stacked_n2_match_jax_kernel(jx):
    """The batched layout: ``lead_pad=False`` over per-segment separators,
    and one hgrad over both segments."""
    N, C, L_in, R, T = 2, 17, 150, 4, 12
    H, W, cot = _problem_stacked(N, C, L_in, R, T)
    seg = T - 1 + L_in
    H2 = F._h_stacked(_t(H), (T,), T)
    cotf = F._cot_stacked(_t(cot), seg)
    ref_w = jx.pd.wgrad([jx.jnp.asarray(cotf.numpy())],
                        jx.jnp.asarray(H2.numpy()), R, TK, T,
                        lead_pad=False, interpret=True)[0]
    got_w = D.wgrad([cotf], H2, R, T, lead_pad=False)[0]
    _close(got_w, np.asarray(ref_w)[:T * R])
    W2 = F._w2(_t(W))
    ref_h = jx.pd.hgrad(jx.jnp.asarray(cotf.numpy()),
                        jx.jnp.asarray(_w2f(W2.numpy(), T, R)), R, TK, N * seg,
                        interpret=True)
    got_h = D.hgrad(cotf, W2, R, N * seg)
    _close(got_h, ref_h)


@pytest.mark.parametrize("Y_in, X_in, ky, kx", [(16, 20, 3, 5), (12, 24, 4, 4)])
def test_plain_kernels_2d_geom_match_jax_kernel(jx, Y_in, X_in, ky, kx):
    """The flat-offset mode of ``test_deconv_nd_kernels_match_direct``."""
    rs = np.random.RandomState(3)
    C, R = 7, 5
    Yp, Xp = Y_in + ky - 1, X_in + kx - 1
    K = ky * kx
    H = rs.rand(1, R, Y_in, X_in).astype("f")
    W = rs.rand(C, R, ky, kx).astype("f")
    cot = rs.rand(Yp * Xp, C).astype("f")
    geom = D.nd_geom((ky, kx), (Y_in, Xp))
    assert geom == jx.pd.nd_geom((ky, kx), (Y_in, Xp))
    T_flat = D._flat_T(geom)
    H2 = F._h_flat_nd(_t(H), (ky, kx))
    ref_w = jx.pd.wgrad([jx.jnp.asarray(cot)], jx.jnp.asarray(H2.numpy()), R,
                        TK, T_flat, geom=geom, interpret=True)[0]
    _close(D.wgrad([_t(cot)], H2, R, T_flat, geom=geom)[0],
           np.asarray(ref_w)[:K * R])
    W2 = F._w2(_t(W))
    ref_h = jx.pd.hgrad(jx.jnp.asarray(cot),
                        jx.jnp.asarray(_w2f(W2.numpy(), K, R)), R, TK,
                        Y_in * Xp, geom=geom, interpret=True)
    _close(D.hgrad(_t(cot), W2, R, Y_in * Xp, geom=geom), ref_h)


@pytest.mark.parametrize("kernel, s_in", [((5,), (30,)), ((3, 4), (7, 9)),
                                          ((2, 3, 2), (4, 5, 3))])
def test_flat_layouts_match_jax(jx, kernel, s_in):
    """The host-side reshapes and pads every kernel call depends on."""
    rs = np.random.RandomState(4)
    N, C, R = 1, 3, 2
    H = rs.rand(N, R, *s_in).astype("f")
    W = rs.rand(C, R, *kernel).astype("f")
    V_shape = (N, C) + tuple(s + k - 1 for s, k in zip(s_in, kernel))
    V = rs.rand(*V_shape).astype("f")
    jnp = jx.jnp
    assert F._flat_geom(V_shape, H.shape) == jx.fd._flat_geom(V_shape, H.shape)
    np.testing.assert_array_equal(F._w2(_t(W)).numpy(),
                                  np.asarray(jx.fd._w2(jnp.asarray(W))))
    np.testing.assert_array_equal(F._v2_flat(_t(V)).numpy(),
                                  np.asarray(jx.fd._v2_flat(jnp.asarray(V))))
    flat = F._h_flat_nd(_t(H), kernel)
    np.testing.assert_array_equal(
        flat.numpy(), np.asarray(jx.fd._h_flat_nd(jnp.asarray(H), kernel)))
    np.testing.assert_array_equal(
        F._h_unflat_nd(flat.T, H.shape, kernel).numpy(), H)
    for j in range(int(np.prod(kernel))):
        assert F._tau_of_flat(j, kernel) == tuple(
            int(t) for t in jx.fd._tau_of_flat(j, kernel))
    np.testing.assert_allclose(  # sums in another order
        F._kl_pos_w_rows(_t(H), 6).numpy(),
        np.asarray(jx.fd._kl_pos_w_rows(jnp.asarray(H), 6)), rtol=1e-6)


def test_wrappers_reject_bad_calls():
    H, W, cots = _problem_1d(5, 40, 2, 4)
    W2 = F._w2(_t(W))
    with pytest.raises(ValueError):
        D.wgrad([_t(c) for c in cots], _t(H[0].T), 2, 4, mu_w2=W2,
                mu_pos=torch.ones(2))
    with pytest.raises(ValueError):
        D.wgrad([], _t(H[0].T), 2, 4)


# --------------------------------------------------------------------------
# hgrad's launch plan (fused_deconv._hgrad_plan), pure arithmetic
# --------------------------------------------------------------------------
def _geom(K, geom=None):
    return D._geom_args(K, geom)


def _emulate_plan(cot, W2, R, L_in, g, p):
    """The gemm regime's blocks, in numpy: each block (output tile, offset
    group, channel split) forms its window ``G`` of 256 cotangent rows
    against its group's W2 rows and folds it along the diagonals into its
    own slab; the slabs are summed.  Asserts that every (offset, column,
    channel) term is summed exactly once and that the fold reads only rows
    of the window."""
    k0, k1, k2, s0, s1, s2 = g
    K = k0 * k1 * k2
    Lp, C = cot.shape
    assert p.regime == "gemm" and p.group * R <= 8 * p.nt <= 128
    stages = -(-C // D._GEMM_DEPTH)
    per_row = -(-k2 // p.group)
    assert p.groups == k0 * k1 * per_row
    assert -(-stages // p.sper) == p.splits and p.sper <= D._GEMM_CHAIN
    assert p.splits == 1 or p.sper >= min(D._GEMM_MIN_RUN, stages)
    cotp = np.zeros((Lp + 2 * D._GEMM_ROWS + K * max(s0, s1, s2, 1), C))
    cotp[:Lp] = cot
    slabs = np.zeros((p.slabs, R, L_in))
    seen = np.zeros((K, L_in, stages), dtype=int)
    taus = [D._flat_tau(j, ((k0, k1, k2), (s0, s1, s2))) for j in range(K)]
    for bx in range(-(-L_in // p.bm)):
        l0 = bx * p.bm
        for by in range(p.groups):
            a = by % per_row * p.group
            n = min(p.group, k2 - a)
            js = [by // per_row * k2 + a + jj for jj in range(n)]
            t0 = taus[js[0]]
            for bz in range(p.splits):
                st = range(bz * p.sper, min((bz + 1) * p.sper, stages))
                c0, c1 = st[0] * 32, min(C, (st[-1] + 1) * 32)
                win = cotp[l0 + t0:l0 + t0 + D._GEMM_ROWS, c0:c1]
                Wg = np.concatenate([W2[j * R:(j + 1) * R, c0:c1] for j in js])
                G = win @ Wg.T
                for i in range(min(p.bm, L_in - l0)):
                    for jj, j in enumerate(js):
                        m = i + jj * s2
                        assert m < D._GEMM_ROWS and taus[j] == t0 + jj * s2
                        slabs[by * p.splits + bz, :, l0 + i] += \
                            G[m, jj * R:(jj + 1) * R]
                        seen[j, l0 + i, list(st)] += 1
    assert (seen == 1).all()
    return slabs.sum(0)


# (R, L_in, C, geom): ranks at the regime's edges; K not a multiple of the
# group; ragged L_in, C = 1025; 1-D, the stacked N=2 layout (one long 1-D
# run), 2-D and 3-D flat offsets; an innermost stride of 3, whose groups stop
# at the span limit (43 offsets: 126 rows of a 256-row window)
PLAN_CASES = [
    (1, 300, 9, (37, None)),
    (3, 517, 1025, (40, None)),
    (8, 300, 17, (23, None)),
    (9, 401, 33, (20, None)),
    (16, 300, 7, (21, None)),
    (3, 2 * 150, 12, (12, None)),
    (5, 16 * 24, 12, (12, ((3, 4), (24, 1)))),
    (16, 6 * 9 * 9, 9, (12, ((2, 3, 2), (81, 9, 1)))),
    (1, 260, 5, (120, ((2, 60), (400, 3)))),
]


@pytest.mark.parametrize("R, L_in, C, kg", PLAN_CASES)
def test_hgrad_plan_covers_every_term_once(R, L_in, C, kg):
    """The gemm plan's blocks, emulated in numpy, sum every (offset, column,
    channel) term once and equal the plain version; slabs and the W2 tiles
    stay within the int32 checks."""
    K, geom = kg
    rs = np.random.RandomState(R)
    g = _geom(K, geom)
    Lp = L_in + max(D._taus(K, geom))
    cot = rs.rand(Lp, C)
    W2 = rs.rand(K * R, C)
    p = D._hgrad_plan(R, L_in, -(-C // 4) * 4, K, g, 132)
    assert p.slabs * R * L_in < 2**31 and p.wsplit < 2**31
    got = _emulate_plan(cot, W2, R, L_in, g, p)
    ref = D.plain_hgrad(_t(cot), _t(W2), R, L_in, geom).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12)


@pytest.mark.parametrize("R, regime", [(1, "gemm"), (3, "gemm"), (8, "gemm"),
                                       (9, "gemm"), (16, "gemm"), (17, "tc"),
                                       (88, "tc")])
def test_hgrad_plan_regime_by_rank(R, regime):
    """Ranks ≤ 16 take the gemm regime at the NMFD flagship's width (C
    padded to 1028, L_in 4601, T=400); larger ranks the tensor-core kernel
    (its instance and splits as before: 88 ranks are N = 88, 30 splits on
    132 SMs)."""
    p = D._hgrad_plan(R, 4601, 1028, 400, _geom(400), 132)
    assert p.regime == regime
    if regime == "gemm":
        assert p.group * R <= 8 * p.nt and 8 * p.nt - p.group * R < 8 + R
        assert p.bm == 256 - (p.group - 1) and p.sper * p.splits >= 33
        assert p.wsplit == p.groups * 33 * 2 * 8 * p.nt * 32
    else:
        assert p.groups == 1 and p.nt == min(-(-R // 8), 16) + (R == 17)
    if R == 88:
        assert (p.nt, p.splits, p.sper) == (11, 30, 429)


def test_hgrad_plan_demo_and_rank_rows():
    """The reference demo (R=3, T=400, 4598 columns) and the rank-8/16 rows:
    wide groups (at most 7 columns of rank padding), 2 channel splits of 17
    stages at C=1028."""
    demo = D._hgrad_plan(3, 4598, 1028, 400, _geom(400), 132)
    assert (demo.regime, demo.group, demo.nt, demo.splits, demo.sper) == \
        ("gemm", 32, 12, 2, 17)
    assert demo.groups == 13 and demo.bm == 225
    r8 = D._hgrad_plan(8, 4601, 1028, 400, _geom(400), 132)
    assert (r8.group, r8.nt, r8.groups) == (16, 16, 25)
    r16 = D._hgrad_plan(16, 4601, 1028, 400, _geom(400), 132)
    assert (r16.group, r16.nt, r16.groups) == (8, 16, 50)


def test_hgrad_plan_splits_fill_the_card():
    """A SIPLCA rank-8 shape (516 channels: 17 stages, one run; 3000
    columns) has 169 blocks a split: on 132 SMs it splits in 2 to fill two
    waves; on 16 SMs one run fills them."""
    g = _geom(200)
    wide = D._hgrad_plan(8, 3000, 516, 200, g, 132)
    assert (wide.groups * -(-3000 // wide.bm), wide.splits, wide.sper) == \
        (169, 2, 9)
    narrow = D._hgrad_plan(8, 3000, 516, 200, g, 16)
    assert (narrow.splits, narrow.sper) == (1, 17)


def test_hgrad_plan_span_limit():
    """An innermost stride of 3: groups stop at 43 offsets (span 126, at
    the limit of half the 256-row window); 44 (span 129) would pass it."""
    g = _geom(120, ((2, 60), (400, 3)))
    plans = [p for _, p in D._gemm_plans(1, 260, 8, 120, g, 132)]
    assert max(p.group for p in plans) == 43
    assert all((p.group - 1) * 3 <= 128 and p.bm >= 128 for p in plans)


def test_hgrad_plan_slab_cap_takes_tc():
    """Where every gemm launch's slabs would pass the 2^26-float cap (rank
    16, 400 offsets, 100,000 columns: 50 groups x 2 splits), the tensor-core
    kernel runs, its slabs under the cap."""
    p = D._hgrad_plan(16, 100_000, 1028, 400, _geom(400), 132)
    assert p.regime == "tc" and p.slabs * 16 * 100_000 <= 1 << 26
    small = D._hgrad_plan(16, 20_000, 1028, 400, _geom(400), 132)
    assert small.regime == "gemm"
    assert small.slabs * 16 * 20_000 <= 1 << 26


def test_cpu_tensors_never_launch():
    H, W, cots = _problem_1d(5, 40, 2, 4)
    before = (D.hgrad.launches, D.wgrad.launches)
    D.hgrad(_t(cots[0]), F._w2(_t(W)), 2, 40)
    D.wgrad([_t(cots[0])], _t(H[0].T), 2, 4)
    assert (D.hgrad.launches, D.wgrad.launches) == before


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


def _assert_kernel(got, ref):
    torch.cuda.synchronize()
    assert got.is_cuda and got.shape == ref.shape
    assert bool(torch.isfinite(got).all())
    err = float((got - ref).abs().max())
    assert err <= RTOL_CUDA * float(ref.abs().max()), err


def _nd_problem(N, C, s_in, kernel, R, seed=5):
    """``(H, W, cot)`` on the CPU in the model layouts, cot ``(N, Lp, C)``."""
    rs = np.random.RandomState(seed)
    H = _t(rs.rand(N, R, *s_in).astype("f"))
    W = _t(rs.rand(C, R, *kernel).astype("f"))
    Lp = int(np.prod([s + k - 1 for s, k in zip(s_in, kernel)]))
    cots = [_t(rs.rand(N, Lp, C).astype("f")) for _ in range(2)]
    return H, W, cots


def _kernel_operands(N, C, s_in, kernel, R):
    """Everything one hgrad/wgrad call of the engine takes, on the CPU."""
    H, W, cots = _nd_problem(N, C, s_in, kernel, R)
    V_shape = (N, C) + tuple(s + k - 1 for s, k in zip(s_in, kernel))
    _, geom, T_geo, L_flat = F._flat_geom(V_shape, H.shape)
    if N > 1:
        seg = T_geo - 1 + L_flat
        H2, lead = F._h_stacked(H, kernel, T_geo), False
        cots, L_h = [F._cot_stacked(c, seg) for c in cots], N * seg
    else:
        H2, lead, cots, L_h = F._h_flat_nd(H, kernel), True, \
            [c[0].contiguous() for c in cots], L_flat
    return SimpleNamespace(H=H, W2=F._w2(W), H2=H2, cots=cots, R=R, geom=geom,
                           T=T_geo, L_h=L_h, lead=lead)


# ragged and whole C, rank 1, K not a multiple of any τ tile or offset group,
# N=2, 2-D and 3-D geom; ranks ≤ 16 take hgrad's gemm regime, the N-D ones
# in offset groups along the kernel's innermost axis (the last two cases'
# flat offsets span 55 and 201 rows)
CUDA_CASES = [
    (1, 17, (300,), (12,), 8),
    (1, 7, (260,), (5,), 3),
    (1, 1025, (900,), (37,), 1),
    (1, 130, (517,), (23,), 88),
    (1, 33, (400,), (20,), 160),
    (1, 40, (700,), (45,), 24),
    (1, 256, (300,), (9,), 40),
    (2, 65, (300,), (21,), 12),
    (1, 12, (16, 20), (3, 5), 5),
    (2, 20, (9, 11), (4, 3), 7),
    (1, 9, (6, 7, 5), (2, 3, 2), 4),
    (1, 6, (4, 98), (3, 3), 4),
]


@pytest.mark.cuda
@pytest.mark.parametrize("N, C, s_in, kernel, R", CUDA_CASES)
def test_cuda_hgrad_matches_plain(cuda, N, C, s_in, kernel, R):
    op = _kernel_operands(N, C, s_in, kernel, R)
    cot, W2 = op.cots[0].to(cuda), op.W2.to(cuda)
    got = D.hgrad(cot, W2, R, op.L_h, geom=op.geom)
    _assert_kernel(got, D.plain_hgrad(cot, W2, R, op.L_h, geom=op.geom))


# the tile edges of the tensor-core hgrad (128 l' rows, 32-deep steps of
# k = j*C + c, 8-rank tiles, 128 ranks a block): ranks 88 and 257 in 1-D;
# L_in and C ragged (1025); one split (7 x 5 reduction terms) and many.
# Ranks 1, 3 and 13 through N-D kernels take the gemm regime here, and the
# tensor-core kernel forced (test_cuda_hgrad_tc_at_small_rank)
TILE_EDGE_CASES = [
    (1, 9, (5, 70), (3, 4), 1),
    (1, 9, (5, 70), (3, 4), 3),
    (1, 17, (6, 60), (2, 5), 13),
    (1, 1025, (600,), (37,), 88),
    (1, 7, (2000,), (5,), 88),
    (1, 65, (300,), (9,), 257),
    (2, 33, (150,), (12,), 88),
]


@pytest.mark.cuda
@pytest.mark.parametrize("N, C, s_in, kernel, R", TILE_EDGE_CASES)
def test_cuda_hgrad_tile_edges(cuda, N, C, s_in, kernel, R):
    test_cuda_hgrad_matches_plain(cuda, N, C, s_in, kernel, R)


@pytest.mark.cuda
@pytest.mark.parametrize("N, C, s_in, kernel, R", TILE_EDGE_CASES[:3])
def test_cuda_hgrad_tc_at_small_rank(cuda, N, C, s_in, kernel, R):
    """The tensor-core kernel at ranks ≤ 16 (its N = 16 and 32 instances),
    which the plan gives a shape whose gemm slabs would pass the cap."""
    op = _kernel_operands(N, C, s_in, kernel, R)
    cot, W2 = op.cots[0].to(cuda), op.W2.to(cuda)
    K = W2.shape[0] // R
    plan = D._tc_plan(R, op.L_h, -(-C // 4) * 4, K,
                      torch.cuda.get_device_properties(0).multi_processor_count)
    assert plan.regime == "tc"
    got = D.hgrad(cot, W2, R, op.L_h, geom=op.geom, plan=plan)
    _assert_kernel(got, D.plain_hgrad(cot, W2, R, op.L_h, geom=op.geom))


# the gemm regime at every rank 1-16 (N = 64-128 columns of (offset, rank)
# here): groups that do not divide K; L_in ragged against the block's
# 256 - (J - 1) output columns; C from 7 (one stage) to 1025 (33 stages in
# 2 splits); N-D kernels (SIPLCA2's 8x8, NMF3D's 4x4x4) and N=2
SMALL_RANK_CASES = [
    (1, 417, (1200,), (129,), 1),
    (1, 65, (700,), (65,), 2),
    (1, 1025, (517,), (43,), 3),
    (1, 33, (1000,), (33,), 4),
    (1, 129, (300,), (26,), 5),
    (1, 385, (600,), (22,), 6),
    (1, 800, (450,), (19,), 7),
    (1, 1025, (1200,), (17,), 8),
    (1, 7, (300,), (15,), 9),
    (1, 256, (500,), (13,), 10),
    (1, 417, (241,), (12,), 11),
    (1, 100, (800,), (11,), 12),
    (1, 1025, (300,), (10,), 13),
    (1, 64, (700,), (10,), 14),
    (1, 513, (400,), (9,), 15),
    (1, 1025, (900,), (9,), 16),
    (1, 64, (6, 6, 6), (4, 4, 4), 16),
    (1, 64, (20, 20), (8, 8), 16),
    (2, 65, (300,), (21,), 3),
]


@pytest.mark.cuda
@pytest.mark.parametrize("N, C, s_in, kernel, R", SMALL_RANK_CASES)
def test_cuda_hgrad_small_rank(cuda, N, C, s_in, kernel, R):
    op = _kernel_operands(N, C, s_in, kernel, R)
    K = op.W2.shape[0] // R
    plan = D._hgrad_plan(R, op.L_h, -(-C // 4) * 4, K,
                         D._geom_args(K, op.geom), 132)
    assert plan.regime == "gemm"
    test_cuda_hgrad_matches_plain(cuda, N, C, s_in, kernel, R)


@pytest.mark.cuda
def test_cuda_hgrad_small_rank_is_reproducible(cuda):
    """No atomics: two calls give the same bits (3 groups x 2 splits of
    slabs summed in a fixed order)."""
    op = _kernel_operands(1, 1025, (600,), (100,), 3)
    cot, W2 = op.cots[0].to(cuda), op.W2.to(cuda)
    a = D.hgrad(cot, W2, 3, op.L_h)
    b = D.hgrad(cot, W2, 3, op.L_h)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_hgrad_demo_shape(cuda):
    """The reference demo's B3: V 1x1025x4997, R=3, T=400."""
    test_cuda_hgrad_matches_plain(cuda, 1, 1025, (4598,), (400,), 3)


@pytest.mark.cuda
@pytest.mark.parametrize("n_cots", [1, 2])
@pytest.mark.parametrize("N, C, s_in, kernel, R", CUDA_CASES)
def test_cuda_wgrad_matches_plain(cuda, N, C, s_in, kernel, R, n_cots):
    op = _kernel_operands(N, C, s_in, kernel, R)
    cots, H2 = [c.to(cuda) for c in op.cots[:n_cots]], op.H2.to(cuda)
    kw = dict(lead_pad=op.lead, geom=op.geom)
    gots = D.wgrad(cots, H2, R, op.T, **kw)
    refs = D.plain_wgrad(cots, H2, R, op.T, **kw)
    assert len(gots) == n_cots
    for got, ref in zip(gots, refs):
        _assert_kernel(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("N, C, s_in, kernel, R", CUDA_CASES)
def test_cuda_wgrad_epilogue_matches_plain(cuda, N, C, s_in, kernel, R):
    op = _kernel_operands(N, C, s_in, kernel, R)
    cot, H2, W2 = op.cots[0].to(cuda), op.H2.to(cuda), op.W2.to(cuda)
    kw = dict(mu_w2=W2, mu_pos=kl_pos_W(op.H).reshape(-1).to(cuda),
              lead_pad=op.lead, geom=op.geom)
    _assert_kernel(D.wgrad([cot], H2, R, op.T, **kw)[0],
                   D.plain_wgrad([cot], H2, R, op.T, **kw)[0])


# the tile edges of the tensor-core wgrad (128 (j, r) rows, 32-deep steps of
# l, 128 channels a block, 64 a cotangent of the pair, the N = 16 instance
# for a last tile of at most 16 channels): ranks 1, 3 and 13 (4-byte patch
# copies) through 1-D and N-D kernels whose row tiles span up to 150 flat
# offsets, 8, 16 and 88 (16-byte copies), 257; C = 1025 and C < 16; N = 2;
# one split (10 steps) and many
WGRAD_EDGE_CASES = [
    (1, 1025, (2000,), (5,), 1),
    (1, 9, (5, 70), (3, 4), 3),
    (1, 17, (6, 60), (2, 5), 13),
    (1, 1025, (700,), (40,), 8),
    (1, 64, (9, 9, 9), (4, 4, 4), 16),
    (1, 1025, (300,), (9,), 88),
    (1, 7, (2000,), (5,), 88),
    (1, 65, (300,), (9,), 257),
    (2, 33, (150,), (12,), 88),
]


@pytest.mark.cuda
@pytest.mark.parametrize("n_cots", [1, 2])
@pytest.mark.parametrize("N, C, s_in, kernel, R", WGRAD_EDGE_CASES)
def test_cuda_wgrad_tile_edges(cuda, N, C, s_in, kernel, R, n_cots):
    test_cuda_wgrad_matches_plain(cuda, N, C, s_in, kernel, R, n_cots)


@pytest.mark.cuda
@pytest.mark.parametrize("N, C, s_in, kernel, R", WGRAD_EDGE_CASES)
def test_cuda_wgrad_epilogue_tile_edges(cuda, N, C, s_in, kernel, R):
    test_cuda_wgrad_epilogue_matches_plain(cuda, N, C, s_in, kernel, R)


@pytest.mark.cuda
def test_cuda_wgrad_takes_unaligned_rows(cuda):
    """Cotangent rows of 1025 floats, and H2 at an odd offset, are copied
    as the kernel takes them; results agree with the plain version."""
    op = _kernel_operands(1, 1025, (300,), (9,), 88)
    cots = [c.to(cuda) for c in op.cots]
    H2 = torch.cat([torch.zeros(1, device=cuda),
                    op.H2.to(cuda).reshape(-1)])[1:].reshape(op.H2.shape)
    assert H2.data_ptr() % 16 and cots[0].data_ptr() % 16 == 0
    gots = D.wgrad(cots, H2, 88, op.T, lead_pad=op.lead, geom=op.geom)
    refs = D.plain_wgrad(cots, H2, 88, op.T, lead_pad=op.lead, geom=op.geom)
    for got, ref in zip(gots, refs):
        _assert_kernel(got, ref)


@pytest.mark.cuda
def test_cuda_wrappers_count_and_reject(cuda):
    op = _kernel_operands(1, 9, (40,), (4,), 2)
    cot, W2, H2 = op.cots[0].to(cuda), op.W2.to(cuda), op.H2.to(cuda)
    n_h, n_w = D.hgrad.launches, D.wgrad.launches
    D.hgrad(cot, W2, 2, op.L_h)
    D.wgrad([cot], H2, 2, op.T)
    assert (D.hgrad.launches, D.wgrad.launches) == (n_h + 1, n_w + 1)
    with pytest.raises(TypeError):
        D.hgrad(cot.double(), W2.double(), 2, op.L_h)
    with pytest.raises(ValueError):
        D.hgrad(cot, W2.cpu(), 2, op.L_h)
    with pytest.raises(ValueError):
        D.wgrad([cot.T], H2, 2, op.T)
    assert (D.hgrad.launches, D.wgrad.launches) == (n_h + 1, n_w + 1)

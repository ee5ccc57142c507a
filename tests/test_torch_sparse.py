"""The sparse slice: the port's ``NMF.fit`` on a sparse COO target against
the JAX package's, from the same numpy data and inits, tier by tier.

Each tier is forced through the environment switches both packages read
(``PNT_SPARSE_DENSIFY``, ``PNT_SPARSE_ELL``, ``PNT_SPARSE_ELL_MAX_PAD``).
Tolerance: after 12 iterations at ``tol=0``, ``max|Δ|/max|ref| < 5e-5`` for
W and H (float32 reordering of the same sums); the scalars of the split
β-divergence within 1e-5 relative.

CUDA tests (marked ``cuda``, skipped without a card):
``python -m pytest --noconftest -m cuda tests/test_torch_sparse.py``.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pytorch_nmf_tpu_torch.nmf import NMFD
from pytorch_nmf_tpu_torch.ops import budget, fused_mu, solver, sparse
from pytorch_nmf_tpu_torch.utils import nmf_from_numpy

RTOL_FIT = 5e-5
TIERS = {  # tier → the environment that forces it in both packages
    "densify": {"PNT_SPARSE_DENSIFY": "1"},
    "ell": {"PNT_SPARSE_DENSIFY": "0", "PNT_SPARSE_ELL": "1",
            "PNT_SPARSE_ELL_MAX_PAD": "1e9"},
    "gather": {"PNT_SPARSE_DENSIFY": "0", "PNT_SPARSE_ELL": "0"},
}


@pytest.fixture(scope="module")
def jx():
    """The JAX package's NMF and sparse module, imported only by the tests
    that compare with it: the CUDA tests need no JAX."""
    pytest.importorskip("jax")
    from pytorch_nmf_tpu.models import nmf
    from pytorch_nmf_tpu.ops import sparse as jsparse

    return SimpleNamespace(NMF=nmf.NMF, sparse=jsparse)


def _rel(got, ref):
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(got) - ref).max() / np.abs(ref).max())


def _problem(M=70, K=50, R=4, keep=0.9, seed=0):
    rs = np.random.RandomState(seed)
    V = rs.rand(M, K).astype("f")
    V = np.where(V > keep, V, 0.0).astype("f")
    return V, rs.rand(K, R).astype("f") + 0.1, rs.rand(M, R).astype("f") + 0.1


def _set_tier(monkeypatch, tier):
    for name in ("PNT_SPARSE_DENSIFY", "PNT_SPARSE_ELL", "PNT_SPARSE_ELL_MAX_PAD"):
        monkeypatch.delenv(name, raising=False)
    for name, value in TIERS[tier].items():
        monkeypatch.setenv(name, value)


def _dense_from_ell(idx, val, rem, shape, transpose=False):
    out = torch.zeros(shape)
    rows = torch.arange(idx.shape[0])[:, None].expand_as(idx)
    out.index_put_((rows.reshape(-1), idx.long().reshape(-1)), val.reshape(-1),
                   accumulate=True)
    seg, oth, v = rem
    out.index_put_((seg.long(), oth.long()), v, accumulate=True)
    return out.T if transpose else out


@pytest.mark.parametrize("beta", [2, 1, 0.5, 1.5])
def test_v_norm_and_scalars_match_jax(jx, beta):
    V, W0, H0 = _problem(seed=1)
    Vs = sparse.sparse_from_dense(V)
    Vj = jx.sparse.sparse_from_dense(V)
    assert Vs.is_coalesced() and Vs._nnz() == Vj.nnz
    assert float(sparse.get_V_norm(Vs, beta)) == pytest.approx(
        float(jx.sparse.get_V_norm(Vj, beta)), rel=1e-5)
    W, H = torch.from_numpy(W0), torch.from_numpy(H0)
    got = sparse.nmf_sp_pos_neg(Vs, H, W, beta, row_block=32)
    want = jx.sparse.nmf_sp_pos_neg(Vj, H0, W0, beta, row_block=32)
    for g, w in zip(got, want):
        assert float(g) == pytest.approx(float(w), rel=1e-5)
    ell = sparse.build_ell(Vs)
    pos = sparse.nmf_ell_pos_scalar(W, H, beta)
    neg = sparse.ell_neg_scalar(ell.row_idx, ell.row_val, H, W, beta)
    assert float(pos) == pytest.approx(float(want[0]), rel=1e-5)
    assert float(neg) == pytest.approx(float(want[1]), rel=1e-5)


def test_build_ell_round_trip(jx):
    V, _, _ = _problem(seed=2)
    Vs = sparse.sparse_from_dense(V)
    ell = sparse.build_ell(Vs)
    assert ell.row_rem[2].numel() == ell.col_rem[2].numel() == 0
    assert ell.row_idx.dtype == torch.int32 and ell.shape == V.shape
    want = torch.from_numpy(V)
    assert torch.equal(_dense_from_ell(ell.row_idx, ell.row_val, ell.row_rem,
                                       V.shape), want)
    assert torch.equal(_dense_from_ell(ell.col_idx, ell.col_val, ell.col_rem,
                                       V.T.shape, transpose=True), want)
    jell = jx.sparse.build_ell(jx.sparse.sparse_from_dense(V))
    np.testing.assert_array_equal(ell.row_idx.numpy(), np.asarray(jell.row_idx))
    np.testing.assert_array_equal(ell.col_val.numpy(), np.asarray(jell.col_val))


def test_build_ell_skewed_hybrid():
    """A row far above the mean degree spills past the cap into the COO
    remainder, and the hybrid still holds the whole target."""
    V, _, _ = _problem(seed=3)
    V[5] = 0.5  # one dense row
    ell = sparse.build_ell(sparse.sparse_from_dense(V))
    assert ell.row_rem[2].numel() > 0
    assert ell.row_idx.shape[1] < V.shape[1]
    want = torch.from_numpy(V)
    assert torch.equal(_dense_from_ell(ell.row_idx, ell.row_val, ell.row_rem,
                                       V.shape), want)
    assert torch.equal(_dense_from_ell(ell.col_idx, ell.col_val, ell.col_rem,
                                       V.T.shape, transpose=True), want)


def test_build_ell_sorts_unsorted_input():
    V, _, _ = _problem(seed=4)
    Vs = sparse.sparse_from_dense(V)
    perm = torch.from_numpy(np.random.RandomState(5).permutation(Vs._nnz()))
    shuffled = torch.sparse_coo_tensor(Vs.indices()[:, perm], Vs.values()[perm],
                                       Vs.shape, check_invariants=True)
    assert not shuffled.is_coalesced()
    a, b = sparse.build_ell(Vs), sparse.build_ell(shuffled)
    for x, y in zip(a[1:5], b[1:5]):
        assert torch.equal(x, y)


def test_maybe_ell_caches_and_obeys_the_switch(monkeypatch):
    Vs = sparse.sparse_from_dense(_problem(seed=6)[0])
    monkeypatch.delenv("PNT_SPARSE_ELL", raising=False)
    first = sparse.maybe_ell(Vs)
    assert first is not None and sparse.maybe_ell(Vs) is first
    monkeypatch.setenv("PNT_SPARSE_ELL", "0")
    assert sparse.maybe_ell(Vs) is None
    monkeypatch.delenv("PNT_SPARSE_ELL")
    monkeypatch.setenv("PNT_SPARSE_ELL_MAX_BYTES", "8")
    assert sparse.maybe_ell(Vs) is None  # over the byte budget


def test_budget_and_should_densify(monkeypatch):
    monkeypatch.delenv("PNT_SPARSE_DENSIFY_MAX_BYTES", raising=False)
    monkeypatch.delenv("PNT_SPARSE_DENSIFY", raising=False)
    assert budget.budget_bytes("PNT_SPARSE_DENSIFY_MAX_BYTES", 123, 0.25,
                               torch.device("cpu")) == 123
    Vs = sparse.sparse_from_dense(_problem(seed=7)[0])
    assert sparse.should_densify(Vs)
    monkeypatch.setenv("PNT_SPARSE_DENSIFY_MAX_BYTES", "100")
    assert not sparse.should_densify(Vs)
    monkeypatch.setenv("PNT_SPARSE_DENSIFY", "1")
    assert sparse.should_densify(Vs)
    monkeypatch.setenv("PNT_SPARSE_DENSIFY", "0")
    monkeypatch.delenv("PNT_SPARSE_DENSIFY_MAX_BYTES")
    assert not sparse.should_densify(Vs)


@pytest.mark.parametrize("tier", ["densify", "ell", "gather"])
@pytest.mark.parametrize("beta", [2, 1, 0.5, 1.5])
def test_sparse_fit_matches_jax_tier(jx, monkeypatch, beta, tier):
    V, W0, H0 = _problem(seed=8)
    _set_tier(monkeypatch, tier)
    ref = jx.NMF(W=W0, H=H0)
    ref_n = ref.fit(jx.sparse.sparse_from_dense(V), beta=beta, tol=0, max_iter=12)
    port = nmf_from_numpy({"W": W0, "H": H0}, "cpu")
    port_n = port.fit(sparse.sparse_from_dense(V), beta=beta, tol=0, max_iter=12)
    assert port_n == ref_n == 12
    assert _rel(port.W.detach().numpy(), ref.W.data) < RTOL_FIT
    assert _rel(port.H.detach().numpy(), ref.H.data) < RTOL_FIT


def test_sparse_tol_fit_stops_like_jax(jx, monkeypatch):
    V, W0, H0 = _problem(seed=9)
    _set_tier(monkeypatch, "ell")
    ref = jx.NMF(W=W0, H=H0)
    ref_n = ref.fit(jx.sparse.sparse_from_dense(V), beta=1, tol=1e-3, max_iter=200)
    port = nmf_from_numpy({"W": W0, "H": H0}, "cpu")
    port_n = port.fit(sparse.sparse_from_dense(V), beta=1, tol=1e-3, max_iter=200)
    assert port_n == ref_n < 200


@pytest.mark.parametrize("beta", [1, 0.5, 2])
@pytest.mark.parametrize("tier", ["ell", "gather"])
def test_sparse_fit_equals_dense_fit(monkeypatch, beta, tier):
    """Zero entries add nothing to any β cotangent: the sparse fit is the
    dense fit of the densified target (reference tests/test_nmf_sparse.py),
    with L1/L2 regularization too."""
    V, W0, H0 = _problem(seed=10)
    _set_tier(monkeypatch, tier)
    dense = nmf_from_numpy({"W": W0, "H": H0}, "cpu")
    dense.fit(torch.from_numpy(V), beta=beta, tol=0, max_iter=10, alpha=0.1,
              l1_ratio=0.5)
    sp = nmf_from_numpy({"W": W0, "H": H0}, "cpu")
    sp.fit(sparse.sparse_from_dense(V), beta=beta, tol=0, max_iter=10,
           alpha=0.1, l1_ratio=0.5)
    assert _rel(sp.W.detach().numpy(), dense.W.detach().numpy()) < RTOL_FIT
    assert _rel(sp.H.detach().numpy(), dense.H.detach().numpy()) < RTOL_FIT


@pytest.mark.parametrize("tier", ["densify", "ell"])
def test_float64_target_warns_and_matches_jax(jx, monkeypatch, tier):
    """A float64 sparse V on a float32 model is cast to float32 with a
    ``UserWarning``; the JAX package casts it when it builds its target."""
    V, W0, H0 = _problem(seed=12)
    _set_tier(monkeypatch, tier)
    ref = jx.NMF(W=W0, H=H0)
    ref.fit(jx.sparse.sparse_from_dense(V), beta=1, tol=0, max_iter=12)
    port = nmf_from_numpy({"W": W0, "H": H0}, "cpu")
    Vs = sparse.sparse_from_dense(V.astype("f8"))
    assert Vs.dtype == torch.float64
    with pytest.warns(UserWarning, match="float64 factors"):
        assert port.fit(Vs, beta=1, tol=0, max_iter=12) == 12
    assert port.W.dtype == torch.float32
    assert _rel(port.W.detach().numpy(), ref.W.data) < RTOL_FIT
    assert _rel(port.H.detach().numpy(), ref.H.data) < RTOL_FIT


@pytest.mark.parametrize("beta", [0, -1])
def test_nonpositive_beta_raises(beta):
    V, W0, H0 = _problem()
    with pytest.raises(ValueError, match="beta <= 0"):
        nmf_from_numpy({"W": W0, "H": H0}, "cpu").fit(
            sparse.sparse_from_dense(V), beta=beta)


def test_deconv_models_refuse_sparse_targets():
    m = NMFD((1, 6, 30), 2, T=3, device="cpu", generator=torch.Generator())
    Vs = sparse.sparse_from_dense(np.ones((6, 30), "f"))
    with pytest.raises(NotImplementedError, match="sparse"):
        m.fit(Vs, beta=1)


def test_negative_or_other_layouts_raise():
    V, W0, H0 = _problem()
    m = nmf_from_numpy({"W": W0, "H": H0}, "cpu")
    with pytest.raises(ValueError, match="non-negative"):
        m.fit(sparse.sparse_from_dense(-V, threshold=-2.0), beta=1)
    with pytest.raises(ValueError, match="COO"):
        m.fit(torch.from_numpy(V).to_sparse_csr(), beta=1)


@pytest.mark.parametrize("beta", [1, 1.5])
def test_densify_oom_falls_back_once(monkeypatch, beta):
    """A densify fit that runs out of card memory runs once more on the
    nnz tiers, with the same result as that tier; other errors
    propagate."""
    V, W0, H0 = _problem(seed=11)
    _set_tier(monkeypatch, "ell")
    want = nmf_from_numpy({"W": W0, "H": H0}, "cpu")
    want.fit(sparse.sparse_from_dense(V), beta=beta, tol=0, max_iter=12)
    monkeypatch.setenv("PNT_SPARSE_DENSIFY", "1")
    calls = []

    def oom(V):
        calls.append(V)
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(sparse, "densify", oom)
    got = nmf_from_numpy({"W": W0, "H": H0}, "cpu")
    assert got.fit(sparse.sparse_from_dense(V), beta=beta, tol=0,
                   max_iter=12) == 12
    assert len(calls) == 1
    assert torch.equal(got.W, want.W) and torch.equal(got.H, want.H)

    def broken(V):
        raise RuntimeError("not a memory error")

    monkeypatch.setattr(sparse, "densify", broken)
    with pytest.raises(RuntimeError, match="not a memory error"):
        nmf_from_numpy({"W": W0, "H": H0}, "cpu").fit(
            sparse.sparse_from_dense(V), beta=beta)


def test_ell_blocks_do_not_change_the_result(monkeypatch):
    """Block size only splits the ELL reductions into launches; each row's
    sums are the same."""
    V, W0, H0 = _problem(M=90, seed=12)
    ell = sparse.build_ell(sparse.sparse_from_dense(V))
    W, H = torch.from_numpy(W0), torch.from_numpy(H0)
    one = sparse.ell_neg_grad(ell.row_idx, ell.row_val, H, W, 0.5)
    monkeypatch.setattr(sparse, "_CPU_STAGE_BYTES", 700)
    many = sparse.ell_neg_grad(ell.row_idx, ell.row_val, H, W, 0.5)
    assert torch.equal(one, many)
    torch.testing.assert_close(sparse.nmf_ell_pos_grad(W, H, 0.5, want_H=False),
                               sparse.nmf_ell_pos_grad(W, H, 0.5, want_H=False))


def test_unknown_tier_raises():
    with pytest.raises(ValueError, match="tier"):
        solver.get_sparse_fit(sparse.nmf_sp_pos_neg, 1.0, 0.0, 10, True, True,
                              0.0, 0.0, tier="dense")


# ----------------------------------------------------------------- the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("beta", [1, 0.5, 2])
def test_cuda_tiers_agree(cuda, monkeypatch, beta):
    V, W0, H0 = _problem(M=300, K=260, R=8, seed=13)
    fits = {}
    for tier in TIERS:
        _set_tier(monkeypatch, tier)
        m = nmf_from_numpy({"W": W0, "H": H0}, cuda)
        b1 = fused_mu.fused_contractions.launches
        Vs = sparse.sparse_from_dense(torch.from_numpy(V).to(cuda))
        assert m.fit(Vs, beta=beta, tol=0, max_iter=12) == 12
        launched = fused_mu.fused_contractions.launches - b1
        assert (launched > 0) == (tier == "densify" and beta != 2)
        assert m.W.is_cuda and bool(torch.isfinite(m.W).all())
        fits[tier] = m
    ref = nmf_from_numpy({"W": W0, "H": H0}, "cpu")
    _set_tier(monkeypatch, "gather")
    ref.fit(sparse.sparse_from_dense(V), beta=beta, tol=0, max_iter=12)
    for m in fits.values():
        assert _rel(m.W.detach().cpu().numpy(), ref.W.detach().numpy()) < RTOL_FIT
        assert _rel(m.H.detach().cpu().numpy(), ref.H.detach().numpy()) < RTOL_FIT


@pytest.mark.cuda
def test_cuda_budget_reads_the_card(cuda, monkeypatch):
    monkeypatch.delenv("PNT_SPARSE_DENSIFY_MAX_BYTES", raising=False)
    total = torch.cuda.mem_get_info(0)[1]
    assert budget.budget_bytes("PNT_SPARSE_DENSIFY_MAX_BYTES", 1, 0.25,
                               torch.device(cuda)) == int(total * 0.25)

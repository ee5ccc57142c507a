"""The functional API: the port's ``functional`` module against the port's
own model fits (``torch.equal``: the same code, the same engine) and the JAX
package's ``functional``, from the same numpy data and inits.

Tolerances (``max|Δ|/max|ref|``): the single fits within 1e-5 of JAX's
after 6 iterations; the batched fits within 1e-4 of JAX's and of the
port's single-problem fits with the same ``n_iter`` each (up to 100
iterations, float32 reordering grown over the run); the trainer steps
within 1e-5.
"""

import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pytorch_nmf_tpu_torch import functional as F
from pytorch_nmf_tpu_torch.nmf import NMFD
from pytorch_nmf_tpu_torch.ops.sparse import sparse_from_dense
from pytorch_nmf_tpu_torch.plca import PLCA, SIPLCA
from pytorch_nmf_tpu_torch.utils import nmf_from_numpy, plca_from_numpy

ITERS = 6


@pytest.fixture(scope="module")
def jx():
    """The JAX package's functional API and models."""
    pytest.importorskip("jax")
    from pytorch_nmf_tpu import functional
    from pytorch_nmf_tpu.models import nmf, plca
    from pytorch_nmf_tpu.ops import sparse as jsparse

    return SimpleNamespace(F=functional, nmf=nmf, plca=plca, sparse=jsparse)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _t(*xs):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in xs)


# (V shape, W shape, H shape) per model
SHAPES = {
    "NMF": ((40, 30), (30, 4), (40, 4)),
    "NMFD": ((1, 10, 50), (10, 3, 6), (1, 3, 45)),
    "NMF2D": ((1, 3, 12, 14), (3, 3, 3, 4), (1, 3, 10, 11)),
    "NMF3D": ((1, 2, 5, 6, 7), (2, 2, 2, 3, 2), (1, 2, 4, 4, 6)),
}
FITS = {"NMF": "nmf_fit", "NMFD": "nmfd_fit", "NMF2D": "nmf2d_fit",
        "NMF3D": "nmf3d_fit"}


def _problem(name, seed=0):
    rs = np.random.RandomState(seed)
    return tuple(rs.rand(*s).astype("f") + off
                 for s, off in zip(SHAPES[name], (0.01, 0.1, 0.1)))


@pytest.mark.parametrize("name, beta", [("NMF", 0.5), ("NMF", 2), ("NMFD", 1),
                                        ("NMF2D", 1), ("NMF3D", 1)])
def test_fit_equals_model_and_matches_jax(jx, name, beta):
    V, W0, H0 = _problem(name)
    W, H, n = getattr(F, FITS[name])(*_t(V, W0, H0), beta=beta, tol=0,
                                     max_iter=ITERS)
    m = nmf_from_numpy({"W": W0, "H": H0}, "cpu")
    assert m.fit(torch.from_numpy(V), beta=beta, tol=0, max_iter=ITERS) == n
    assert torch.equal(W, m.W.detach()) and torch.equal(H, m.H.detach())
    jW, jH, jn = getattr(jx.F, FITS[name])(V, W0, H0, beta=beta, tol=0,
                                           max_iter=ITERS)
    assert n == int(jn) == ITERS
    assert _rel(W, jW) < 1e-5 and _rel(H, jH) < 1e-5


def test_sparse_nmf_fit_and_frozen_factor(jx):
    V, W0, H0 = _problem("NMF", seed=1)
    V = np.where(V > 0.6, V, 0).astype("f")
    W, H, _ = F.nmf_fit(sparse_from_dense(V), *_t(W0, H0), beta=1, tol=0,
                        max_iter=ITERS, update_W=False)
    assert torch.equal(W, torch.from_numpy(W0))
    jW, jH, _ = jx.F.nmf_fit(jx.sparse.sparse_from_dense(V), W0, H0, beta=1,
                             tol=0, max_iter=ITERS, update_W=False)
    assert _rel(H, jH) < 1e-5


def test_float64_target_warns_and_matches_jax(jx):
    """C1: a float64 numpy V with float32 factors is cast with a warning."""
    V, W0, H0 = _problem("NMF", seed=2)
    with pytest.warns(UserWarning, match="float64 factors"):
        W, H, n = F.nmf_fit(V.astype("f8"), *_t(W0, H0), beta=1, tol=0,
                            max_iter=ITERS)
    assert W.dtype == torch.float32
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        jW, jH, _ = jx.F.nmf_fit(V.astype("f8"), W0, H0, beta=1, tol=0,
                                 max_iter=ITERS)
    assert _rel(W, jW) < 1e-5 and _rel(H, jH) < 1e-5


@pytest.mark.parametrize("name", ["PLCA", "SIPLCA"])
def test_plca_fit_equals_model_and_matches_jax(jx, name):
    rs = np.random.RandomState(3)
    if name == "PLCA":
        V, W0, H0 = rs.rand(40, 30), rs.rand(30, 4), rs.rand(40, 4)
    else:
        V, W0, H0 = rs.rand(1, 10, 50), rs.rand(10, 3, 6), rs.rand(1, 3, 45)
    V, W0, H0 = (x.astype("f") + 0.05 for x in (V, W0, H0))
    m = plca_from_numpy({"W": W0, "H": H0, "Z": rs.rand(W0.shape[1]).astype("f")},
                        "cpu")
    inits = [p.detach().clone() for p in (m.W, m.H, m.Z)]  # normalized
    n_m, norm_m = m.fit(torch.from_numpy(V), tol=0, max_iter=ITERS)
    model_cls = PLCA if name == "PLCA" else SIPLCA
    W, H, Z, n, norm = F.plca_fit(torch.from_numpy(V), *inits,
                                  model_cls=model_cls, tol=0, max_iter=ITERS)
    assert n == n_m == ITERS - 1 and torch.equal(norm, norm_m)
    for a, b in zip((W, H, Z), (m.W, m.H, m.Z)):
        assert torch.equal(a, b.detach())
    out = jx.F.plca_fit(V, *(x.numpy() for x in inits),
                        model_cls=getattr(jx.plca, name), tol=0, max_iter=ITERS)
    for a, b in zip((W, H, Z), out[:3]):
        assert _rel(a, b) < 1e-5


def test_hoyer_fit_equals_model_and_matches_jax(jx):
    V, W0, H0 = _problem("NMFD", seed=4)
    W, H, n = F.nmf_hoyer_fit(*_t(V, W0, H0), beta=2, max_iter=ITERS, sW=0.5,
                              model_cls=NMFD)
    m = nmf_from_numpy({"W": W0, "H": H0}, "cpu")
    assert m.sparse_fit(torch.from_numpy(V), beta=2, max_iter=ITERS,
                        sW=0.5) == n == ITERS
    assert torch.equal(W, m.W.detach()) and torch.equal(H, m.H.detach())
    jW, jH, _ = jx.F.nmf_hoyer_fit(V, W0, H0, beta=2, max_iter=ITERS, sW=0.5,
                                   model_cls=jx.nmf.NMFD)
    assert _rel(W, jW) < 1e-5 and _rel(H, jH) < 1e-5


def _batch(B=4, M=30, K=20, R=3, seed=5):
    rs = np.random.RandomState(seed)
    return ((rs.rand(B, M, K) + 0.01).astype("f"),
            (rs.rand(B, K, R) + 0.1).astype("f"),
            (rs.rand(B, M, R) + 0.1).astype("f"))


@pytest.mark.parametrize("beta", [2, 1, 0.5])
def test_nmf_fit_batched(jx, beta):
    """Each problem stops on its own (at tol=1e-3 these stop at different
    chunks), with the trajectory and ``n_iter`` it has alone."""
    V, W0, H0 = _batch()
    W, H, n = F.nmf_fit_batched(*_t(V, W0, H0), beta=beta, tol=1e-3,
                                max_iter=100)
    assert n.shape == (4,)
    jW, jH, jn = jx.F.nmf_fit_batched(V, W0, H0, beta=beta, tol=1e-3,
                                      max_iter=100)
    assert n.tolist() == np.asarray(jn).tolist()
    assert _rel(W, jW) < 1e-4 and _rel(H, jH) < 1e-4
    if beta == 2:
        assert len(set(n.tolist())) > 1
    for b in range(4):
        w, h, nb = F.nmf_fit(*_t(V[b], W0[b], H0[b]), beta=beta, tol=1e-3,
                             max_iter=100)
        assert nb == int(n[b])
        assert _rel(W[b], w) < 1e-4 and _rel(H[b], h) < 1e-4


def test_nmfd_fit_batched_matches_jax(jx):
    rs = np.random.RandomState(6)
    V, W0, H0 = ((rs.rand(2, 1, 6, 40) + 0.01).astype("f"),
                 (rs.rand(2, 6, 2, 4) + 0.1).astype("f"),
                 (rs.rand(2, 1, 2, 37) + 0.1).astype("f"))
    W, H, n = F.nmf_fit_batched(*_t(V, W0, H0), beta=1, tol=0, max_iter=20,
                                model_cls=NMFD)
    jW, jH, jn = jx.F.nmf_fit_batched(V, W0, H0, beta=1, tol=0, max_iter=20,
                                      model_cls=jx.nmf.NMFD)
    assert n.tolist() == np.asarray(jn).tolist() == [20, 20]
    assert _rel(W, jW) < 1e-4 and _rel(H, jH) < 1e-4


@pytest.mark.parametrize("name", ["PLCA", "SIPLCA"])
def test_plca_fit_batched(jx, name):
    rs = np.random.RandomState(7)
    if name == "PLCA":
        V, W0, H0 = _batch(seed=7)
        axes_w = axes_h = (1,)
    else:
        V, W0, H0 = ((rs.rand(2, 1, 6, 40) + 0.01).astype("f"),
                     (rs.rand(2, 6, 2, 4) + 0.1).astype("f"),
                     (rs.rand(2, 1, 2, 37) + 0.1).astype("f"))
        axes_w, axes_h = (1, 3), (1, 3)
    B, R = W0.shape[0], W0.shape[2]
    W0 = W0 / W0.sum(axes_w, keepdims=True)
    H0 = H0 / H0.sum(axes_h, keepdims=True)
    Z0 = np.full((B, R), 1.0 / R, "f")
    model_cls = PLCA if name == "PLCA" else SIPLCA
    W, H, Z, n, norm = F.plca_fit_batched(*_t(V, W0, H0, Z0), tol=1e-3,
                                          max_iter=100, model_cls=model_cls)
    out = jx.F.plca_fit_batched(V, W0, H0, Z0, tol=1e-3, max_iter=100,
                                model_cls=getattr(jx.plca, name))
    assert n.tolist() == np.asarray(out[3]).tolist()
    assert _rel(norm, out[4]) < 1e-6
    for a, b in zip((W, H, Z), out[:3]):
        assert _rel(a, b) < 1e-4
    for b in range(B):
        w, h, z, nb, _ = F.plca_fit(*_t(V[b], W0[b], H0[b], Z0[b]),
                                    model_cls=model_cls, tol=1e-3, max_iter=100)
        assert nb == int(n[b]) and _rel(W[b], w) < 1e-4


def test_nmf_hoyer_fit_batched(jx):
    V, W0, H0 = _batch(seed=8)
    W, H, n = F.nmf_hoyer_fit_batched(*_t(V, W0, H0), beta=2, max_iter=ITERS,
                                      sW=0.5)
    assert n.tolist() == [ITERS] * 4
    jW, jH, _ = jx.F.nmf_hoyer_fit_batched(V, W0, H0, beta=2, max_iter=ITERS,
                                           sW=0.5)
    assert _rel(W, jW) < 1e-4 and _rel(H, jH) < 1e-4
    for b in range(4):
        w, h, _ = F.nmf_hoyer_fit(*_t(V[b], W0[b], H0[b]), beta=2,
                                  max_iter=ITERS, sW=0.5)
        assert torch.equal(W[b], w) and torch.equal(H[b], h)
    with pytest.raises(NotImplementedError):
        F.nmf_hoyer_fit_batched(sparse_from_dense(V[0]), *_t(W0, H0), sW=0.5)


def _chain(seed=9):
    rs = np.random.RandomState(seed)
    return [(rs.rand(*s) + 0.1).astype("f") for s in ((16, 4), (30, 4), (20, 16))]


def _predict(p):
    W1, H1, W2 = p
    return (H1 @ W1.T) @ W2.T  # NMF(W1, H1) then NMF(W=W2): (30, 20)


@pytest.mark.parametrize("beta, regs", [(1, (0, 0, 0)), (0.5, (1e-3, 1e-3, 1e-2)),
                                        (2, (0, 0, 1e-2))])
def test_betamu_step_matches_jax(jx, beta, regs):
    params = _chain()
    V = np.random.RandomState(10).rand(30, 20).astype("f")
    new, grads = F.betamu_step(_predict, list(_t(*params)), torch.from_numpy(V),
                               beta, *regs, trainable=[True, False, True])
    jnew, jgrads = jx.F.betamu_step(_predict, params, V, beta, *regs,
                                    trainable=[True, False, True])
    assert torch.equal(new[1], torch.from_numpy(params[1]))
    for a, b in zip(new + grads, list(jnew) + list(jgrads)):
        if np.abs(np.asarray(b)).max() > 0:
            assert _rel(a, b) < 1e-5
        else:
            assert float(a.abs().max()) == 0


@pytest.mark.parametrize("case", ["nmf", "all_fail"])
def test_sparsity_proj_step_matches_jax(jx, case):
    """``all_fail``: a loss that any projection makes worse, so every
    attempt fails: the last one is undone and the step halved once more."""
    rs = np.random.RandomState(11)
    W0, H0 = rs.rand(30, 4).astype("f") + 0.1, rs.rand(40, 4).astype("f") + 0.1
    V = rs.rand(40, 30).astype("f")
    Vt, Ht, Wt = torch.from_numpy(V), torch.from_numpy(H0), torch.from_numpy(W0)

    if case == "nmf":
        def loss(p):
            d = Ht @ p[0].T - Vt
            return 0.5 * torch.sum(d * d)

        def jloss(p):
            d = H0 @ p[0].T - V
            return 0.5 * (d * d).sum()
    else:
        def loss(p):
            return torch.sum((p[0] - Wt) ** 2) + 1e-3 * torch.sum(p[0])

        def jloss(p):
            return ((p[0] - W0) ** 2).sum() + 1e-3 * p[0].sum()

    new, new_lr, val, grads = F.sparsity_proj_step(
        loss, [Wt], 1.0, 0.3, max_iter=3, return_grads=True)
    jnew, jlr, jval, jgrads = jx.F.sparsity_proj_step(
        jloss, [W0], 1.0, 0.3, max_iter=3, return_grads=True)
    assert new_lr == pytest.approx(float(jlr), rel=1e-7)
    assert float(val) == pytest.approx(float(jval), rel=1e-5)
    assert _rel(new[0], jnew[0]) < 1e-5 and _rel(grads[0], jgrads[0]) < 1e-5
    if case == "all_fail":
        assert new_lr == pytest.approx(0.5**3 * 1.2, rel=1e-6)


def test_exports_match_jax(jx):
    assert set(F.__all__) == set(jx.F.__all__)
    for name in ("mu_update", "proj_func", "gamma_from_beta", "renorm"):
        assert callable(getattr(F, name))
    V, W0, H0 = _problem("NMF")
    with pytest.raises(ValueError, match="non-negative"):
        F.nmf_fit(-V, *_t(W0, H0))

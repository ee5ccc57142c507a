"""A kept fit sees its target's current values.

The fits' cache (``ops/solver``) keys an entry by the target's identity,
its address and its version counter.  A write through ``V.numpy()``,
``V.data`` or a sparse target's ``_values().numpy()`` moves none of them,
so the next fit of the configuration is a hit: it must recompute what the
entry derives from V (PLCA's ``norm`` and ``Vn``, the densified target,
``V_norm``, the ELL layout's values, the updaters' padded copy of V) from
the values V holds now, as the JAX package's jitted fit derives them at
every call.

Each case fits once, writes new values into the same tensor, and fits
again from the same inits: the second fit is a hit, captures nothing, and
equals the eager loop (``_graph=False``) on the new values bit for bit and
the JAX package's fit of the new values within ``1e-5`` of the largest
value, with the same ``n_iter`` (the losses of verbose fits too).  The
padded copy of V exists only on the card (the kernels read 16-byte rows);
here ``fused_mu.aligned_rows`` is made to pad every target, so the CPU
runs the copy and its refresh.
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pytorch_nmf_tpu_torch.nmf import NMF  # noqa: E402
from pytorch_nmf_tpu_torch.ops import (fast_nmf, fast_plca, fused_mu,  # noqa: E402
                                       graphs, solver, sparse)
from pytorch_nmf_tpu_torch.plca import PLCA  # noqa: E402
from pytorch_nmf_tpu_torch.utils import LossHistory, plca_from_numpy  # noqa: E402

RTOL = 1e-5
MAX_ITER = 30
TIERS = {  # tier → the environment that forces it in both packages
    "densify": {"PNT_SPARSE_DENSIFY": "1"},
    "ell": {"PNT_SPARSE_DENSIFY": "0", "PNT_SPARSE_ELL": "1",
            "PNT_SPARSE_ELL_MAX_PAD": "1e9"},
    "gather": {"PNT_SPARSE_DENSIFY": "0", "PNT_SPARSE_ELL": "0"},
}


@pytest.fixture(scope="module")
def jx():
    """The JAX package's models, functional API and sparse module."""
    pytest.importorskip("jax")
    from pytorch_nmf_tpu import functional, utils
    from pytorch_nmf_tpu.models import nmf, plca
    from pytorch_nmf_tpu.ops import sparse as jsparse

    return SimpleNamespace(NMF=nmf.NMF, PLCA=plca.PLCA, SIPLCA=plca.SIPLCA,
                           F=functional, sparse=jsparse,
                           LossHistory=utils.LossHistory)


@pytest.fixture(autouse=True)
def fresh_cache():
    """One intra-op thread (these small fits run several times faster on
    it) and an empty cache before and after each test."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    solver.compiled_cache_clear()
    yield
    solver.compiled_cache_clear()
    torch.set_num_threads(threads)


def _rel(got, ref):
    got, ref = np.asarray(got, "f8"), np.asarray(ref, "f8")
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _recorded(fn):
    """``fn()``'s result and the losses it reported (a verbose fit)."""
    with LossHistory() as hist:
        out = fn()
    return out, hist.losses


def _write(V, how, new):
    """Writes the values ``new`` (numpy, V's shape; a sparse V: its values)
    into ``V`` by a path its version counter does not see."""
    values = V._values() if V.layout == torch.sparse_coo else V
    if how == "numpy":
        values.numpy()[:] = new
    else:  # "data": new is 3·V
        values.data.mul_(3)
    return V


# ------------------------------------------------------------------ cases
def _plca_problem(seed=0):
    rs = np.random.RandomState(seed)
    return (rs.rand(40, 30).astype("f") + 0.01, rs.rand(30, 5).astype("f"),
            rs.rand(40, 5).astype("f"), rs.rand(5).astype("f") + 0.1)


def _siplca_problem(seed=0):
    rs = np.random.RandomState(seed)
    return (rs.rand(1, 12, 64).astype("f") + 0.01,
            rs.rand(12, 3, 5).astype("f") + 0.1,
            rs.rand(1, 3, 60).astype("f") + 0.1, rs.rand(3).astype("f") + 0.1)


def _em_case(name, engine=None):
    """PLCA or SIPLCA through ``get_plca_fit`` as the model builds it."""
    problem = _plca_problem if name == "PLCA" else _siplca_problem

    def setup(device="cpu"):
        V0, W0, H0, Z0 = problem()
        m = plca_from_numpy({"W": W0, "H": H0, "Z": Z0}, device)
        inits = tuple(p.detach().clone() for p in (m.W, m.H, m.Z))
        V = torch.from_numpy(V0.copy()).to(device)
        recon3 = type(m)._resolve_fit_recon3(V, *inits)

        def fit(V, graph):
            f = solver.get_plca_fit(recon3, 0.0, MAX_ITER, True, True, True,
                                    False, False, False, True, em_engine=engine,
                                    _graph=graph)
            one = V.new_ones(())
            return _recorded(lambda: f(V, *inits, one, one, one))

        def jax(jx, Vnew):
            ref = getattr(jx, name)(W=W0, H=H0, Z=Z0)
            (n, norm), losses = _recorded_jax(
                jx, lambda: ref.fit(Vnew, tol=0, max_iter=MAX_ITER,
                                    verbose=True))
            return [ref.W.data, ref.H.data, ref.Z.data, int(n),
                    float(norm)], losses

        return SimpleNamespace(V=V, V0=V0, fit=fit, jax=jax)

    return setup


def _batched_plca_case():
    def setup(device="cpu"):
        rs = np.random.RandomState(5)
        V0, W0, H0 = (rs.rand(*s).astype("f") + off for s, off in zip(
            ((3, 30, 20), (3, 20, 3), (3, 30, 3)), (0.01, 0.1, 0.1)))
        W0 = W0 / W0.sum(1, keepdims=True)
        H0 = H0 / H0.sum(1, keepdims=True)
        Z0 = np.full((3, 3), 1 / 3, "f")
        inits = tuple(torch.from_numpy(a).to(device) for a in (W0, H0, Z0))
        V = torch.from_numpy(V0.copy()).to(device)

        def fit(V, graph):
            f = solver.get_batched_plca_fit(PLCA.reconstruct, 0.0, MAX_ITER,
                                            True, True, True, False, False,
                                            False, _graph=graph)
            one = V.new_ones(())
            return f(V, *inits, one, one, one), None

        def jax(jx, Vnew):
            out = jx.F.plca_fit_batched(Vnew, W0, H0, Z0, model_cls=jx.PLCA,
                                        tol=0, max_iter=MAX_ITER)
            return list(out), None

        return SimpleNamespace(V=V, V0=V0, fit=fit, jax=jax)

    return setup


def _dense_case(beta):
    """Dense NMF on the fused updaters, whose padded copy of V (every
    target padded here) is what the entry keeps from V."""
    def setup(device="cpu"):
        rs = np.random.RandomState(2)
        V0 = rs.rand(30, 21).astype("f") + 0.01
        W0, H0 = rs.rand(21, 3).astype("f") + 0.1, rs.rand(30, 3).astype("f") + 0.1
        V = torch.from_numpy(V0.copy()).to(device)

        def fit(V, graph):
            f = solver.get_dense_fit(
                NMF.reconstruct, beta, 0.0, MAX_ITER, True, True, 0.0, 0.0,
                True, fast_nmf.nmf_updater_factory_fused, _graph=graph)
            return _recorded(lambda: f(V, torch.from_numpy(W0).to(device),
                                       torch.from_numpy(H0).to(device)))

        def jax(jx, Vnew):
            ref = jx.NMF(W=W0, H=H0)
            n, losses = _recorded_jax(jx, lambda: ref.fit(
                Vnew, beta=beta, tol=0, max_iter=MAX_ITER, verbose=True))
            return [ref.W.data, ref.H.data, int(n)], losses

        return SimpleNamespace(V=V, V0=V0, fit=fit, jax=jax)

    return setup


def _sparse_problem(seed=1):
    rs = np.random.RandomState(seed)
    V = rs.rand(60, 40).astype("f")
    V = np.where(V > 0.7, V, 0).astype("f")  # 30% density
    return V, rs.rand(40, 4).astype("f") + 0.1, rs.rand(60, 4).astype("f") + 0.1


def _sparse_case(tier, beta):
    def setup(device="cpu"):
        V0, W0, H0 = _sparse_problem()
        Vs = sparse.sparse_from_dense(torch.from_numpy(V0).to(device))
        target = sparse.build_ell(Vs) if tier == "ell" else Vs

        def fit(V, graph):
            # the densify tier on the fused updaters: their padded copy of
            # the densified target is kept too
            factory = (fast_nmf.nmf_updater_factory_fused
                       if tier == "densify" else None)
            f = solver.get_sparse_fit(NMF._sp_pos_neg, beta, 0.0, MAX_ITER,
                                      True, True, 0.0, 0.0, True, tier,
                                      NMF.reconstruct, factory, _graph=graph)
            return _recorded(lambda: f(target, torch.from_numpy(W0).to(device),
                                       torch.from_numpy(H0).to(device)))

        def jax(jx, Vnew):
            ref = jx.NMF(W=W0, H=H0)
            n, losses = _recorded_jax(jx, lambda: ref.fit(
                jx.sparse.sparse_from_dense(Vnew), beta=beta, tol=0,
                max_iter=MAX_ITER, verbose=True))
            return [ref.W.data, ref.H.data, int(n)], losses

        return SimpleNamespace(V=Vs, V0=V0, fit=fit, jax=jax, env=TIERS[tier])

    return setup


def _sparse_hoyer_case():
    """The sparse-target Hoyer fit, verbose: ``V_norm`` shows in its
    losses (the line search's comparisons cancel it)."""
    def setup(device="cpu"):
        rs = np.random.RandomState(4)
        V0, W0, H0 = (rs.rand(*s).astype("f") + off for s, off in zip(
            ((40, 30), (30, 5), (40, 5)), (0.01, 0.1, 0.1)))
        V0 = np.where(V0 > 0.6, V0, 0).astype("f")
        Vs = sparse.sparse_from_dense(torch.from_numpy(V0).to(device))

        def fit(V, graph):
            f = solver.get_hoyer_fit(None, NMF._sp_pos_neg, 2.0, MAX_ITER,
                                     True, True, 0.5, None, 30, 40, True,
                                     _graph=graph)
            return _recorded(lambda: f(V, torch.from_numpy(W0).to(device),
                                       torch.from_numpy(H0).to(device)))

        def jax(jx, Vnew):
            ref = jx.NMF(W=W0, H=H0)
            n, losses = _recorded_jax(jx, lambda: ref.sparse_fit(
                jx.sparse.sparse_from_dense(Vnew), beta=2, max_iter=MAX_ITER,
                verbose=True, sW=0.5))
            return [ref.W.data, ref.H.data, int(n)], losses

        return SimpleNamespace(V=Vs, V0=V0, fit=fit, jax=jax)

    return setup


def _recorded_jax(jx, fn):
    with jx.LossHistory() as hist:
        out = fn()
    return out, hist.losses


CASES = {
    "plca": (_em_case("PLCA"), ("numpy", "data")),
    "plca-fused": (_em_case("PLCA", fast_plca.plca_em_engine_plain),
                   ("numpy", "data")),
    "siplca": (_em_case("SIPLCA"), ("numpy", "data")),
    "batched-plca": (_batched_plca_case(), ("numpy", "data")),
    "nmf-fused-b1": (_dense_case(1.0), ("numpy", "data")),
    "nmf-fused-b0.5": (_dense_case(0.5), ("numpy", "data")),
    **{f"sparse-{t}-b{b}": (_sparse_case(t, b), ("numpy", "data"))
       for t in TIERS for b in (1.0, 1.5, 2.0)},
    "sparse-hoyer": (_sparse_hoyer_case(), ("numpy", "data")),
}
PARAMS = [(name, how) for name, (_, hows) in CASES.items() for how in hows]


def _new_values(V0, how, sparse_target):
    """The dense values after the write, and what :func:`_write` takes."""
    if how == "data":
        return 3 * V0, None
    rs = np.random.RandomState(9)
    new = (V0 * (0.5 + rs.rand(*V0.shape))).astype("f") if sparse_target \
        else (rs.rand(*V0.shape) + 0.01).astype("f")
    return new, (new[new > 0] if sparse_target else new)


def _tensors(out):
    flat = []
    for x in out:
        flat.extend(x if isinstance(x, (tuple, list)) else [x])
    return [x for x in flat if isinstance(x, torch.Tensor)]


def _set_env(monkeypatch, case):
    env = getattr(case, "env", {})
    for k in ("PNT_SPARSE_DENSIFY", "PNT_SPARSE_ELL", "PNT_SPARSE_ELL_MAX_PAD"):
        if k in env:
            monkeypatch.setenv(k, env[k])
        else:
            monkeypatch.delenv(k, raising=False)


def _fit_write_fit(case, how):
    """Fits (the entry kept), writes new values into the target, fits
    again (a hit, no capture) and eagerly; the warm fit equals the eager
    one bit for bit.  Returns ``(new dense values, warm out, its losses)``."""
    case.fit(case.V, True)  # the configuration's first fit: kept
    sparse_target = case.V.layout == torch.sparse_coo
    Vnew, written = _new_values(case.V0, how, sparse_target)
    _write(case.V, how, written)
    info, captures = solver.compiled_cache_info(), graphs._Graphs.captures
    warm, warm_losses = case.fit(case.V, True)
    assert solver.compiled_cache_info()["hits"] == info["hits"] + 1
    assert graphs._Graphs.captures == captures
    eager, eager_losses = case.fit(case.V, False)
    for a, b in zip(_tensors(warm), _tensors(eager)):
        assert torch.equal(a, b)
    assert warm_losses == eager_losses
    return Vnew, warm, warm_losses


@pytest.mark.parametrize("name, how", PARAMS, ids=[f"{n}-{h}" for n, h in PARAMS])
def test_a_kept_fit_sees_its_targets_new_values(jx, monkeypatch, name, how):
    monkeypatch.setattr(fused_mu, "aligned_rows", fused_mu._padded)
    case = CASES[name][0]()
    _set_env(monkeypatch, case)
    Vnew, warm, warm_losses = _fit_write_fit(case, how)
    ref, ref_losses = case.jax(jx, Vnew)
    for a, b in zip(list(warm), ref):
        if isinstance(b, int):
            assert int(a) == b
        elif isinstance(b, float):
            assert float(a) == pytest.approx(b, rel=1e-6)
        else:
            assert _rel(a, b) <= RTOL
    if ref_losses is not None:
        assert len(warm_losses) == len(ref_losses) == MAX_ITER // 10
        assert _rel(warm_losses, ref_losses) <= RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_cuda_a_kept_fit_sees_its_targets_new_values(monkeypatch, name):
    """On the card, through ``V.data`` (a sparse V's ``_values().data``):
    the kernels' own padded copies (84- and 160-byte rows here), graphed
    chunks, the warm fit bit for bit the eager one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    case = CASES[name][0]("cuda")
    _set_env(monkeypatch, case)
    _fit_write_fit(case, "data")


@pytest.mark.parametrize("how", ["numpy", "data"])
def test_refresh_ell_equals_a_layout_of_the_new_values(how, monkeypatch):
    """Both sides spilled: the refreshed layout is, array by array, the
    layout a fresh build of the changed target makes."""
    V0, _, _ = _sparse_problem(seed=3)
    V0[3] = 0.5
    V0[:, 4] = 0.5
    monkeypatch.setattr(sparse, "_ell_cap", lambda nnz, n, f=None: 2)
    Vs = sparse.sparse_from_dense(torch.from_numpy(V0))
    ell = sparse.build_ell(Vs)
    assert ell.row_rem[2].numel() and ell.col_rem[2].numel()
    new = (V0[V0 > 0] * np.arange(1, 1 + (V0 > 0).sum())).astype("f")
    if how == "numpy":
        Vs._values().numpy()[:] = new
    else:
        Vs._values().data.copy_(torch.from_numpy(new))
    arrays = [ell.row_val, ell.col_val, ell.row_rem[2], ell.col_rem[2]]
    ptrs = [a.data_ptr() for a in arrays]
    assert sparse.refresh_ell(ell) is ell
    fresh = sparse.build_ell(torch.sparse_coo_tensor(
        Vs._indices(), torch.from_numpy(new), Vs.shape, is_coalesced=True))
    for a, b in zip(ell[1:], fresh[1:]):
        for x, y in zip(a if isinstance(a, tuple) else [a],
                        b if isinstance(b, tuple) else [b]):
            assert torch.equal(x, y)
    assert [a.data_ptr() for a in arrays] == ptrs


def test_densify_into_equals_to_dense():
    V0, _, _ = _sparse_problem(seed=5)
    Vs = sparse.sparse_from_dense(torch.from_numpy(V0))
    out = torch.full(V0.shape, 7.0)
    assert sparse.densify(Vs, out=out) is out
    assert torch.equal(out, sparse.densify(Vs))

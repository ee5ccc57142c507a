"""The port's ``utils``: ``.npz`` checkpoints and segmented fits that resume
(``tests/test_module.py``'s cases), directories written by one package and
resumed by the other, ``LossHistory`` against the JAX package's, the
profiling helpers on the CPU and ``PNT_SKIP_VALIDATE``.

Tolerances: a segmented fit equals the uninterrupted one to 1e-7 (the same
updates in the same order); a fit resumed across the packages ends within
1e-5 (``max|Δ|/max|ref|``) of the uninterrupted fit of the package that
finishes it, and the recorded losses are within 1e-5 of JAX's.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pytorch_nmf_tpu_torch.nmf import NMF, NMFD  # noqa: E402
from pytorch_nmf_tpu_torch.ops import solver  # noqa: E402
from pytorch_nmf_tpu_torch.ops.sparse import sparse_from_dense  # noqa: E402
from pytorch_nmf_tpu_torch.plca import PLCA  # noqa: E402
from pytorch_nmf_tpu_torch.utils import LossHistory, checkpoint, profiling  # noqa: E402
from pytorch_nmf_tpu_torch.utils.checkpoint import (checkpointed_fit,  # noqa: E402
                                                    checkpointed_plca_fit)

NEG_INF = float("-inf")


@pytest.fixture(scope="module")
def jx():
    """The JAX package's models and utilities."""
    pytest.importorskip("jax")
    from pytorch_nmf_tpu import utils
    from pytorch_nmf_tpu.models import nmf, plca
    from pytorch_nmf_tpu.utils import checkpoint as jckpt

    return SimpleNamespace(nmf=nmf, plca=plca, utils=utils, ckpt=jckpt)


def _rel(got, ref):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    ref = ref.detach().cpu().numpy() if isinstance(ref, torch.Tensor) else ref
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _diff(a, b):
    return float((a.detach() - b.detach()).abs().max())


def _nmf_problem(seed, M=60, K=40, R=5):
    rng = np.random.RandomState(seed)
    V = rng.rand(M, K).astype("f")
    W0 = rng.rand(K, R).astype("f") + 0.1
    H0 = rng.rand(M, R).astype("f") + 0.1
    return V, W0, H0


def _cpu(**kw):
    return NMF(device="cpu", **kw)


def test_checkpoint_npz_roundtrip(tmp_path):
    m = NMF((20, 10), 4, device="cpu")
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save(path, m)
    m2 = NMF((20, 10), 4, device="cpu")
    assert checkpoint.load(path, m2) is m2
    assert torch.equal(m2.W, m.W) and torch.equal(m2.H, m.H)
    state = checkpoint.load(path)
    assert set(state) == {"W", "H"}
    assert torch.equal(state["W"], m.W.detach())
    checkpoint.save(str(tmp_path / "map.npz"), {"x": torch.ones(3)})
    assert torch.equal(checkpoint.load(str(tmp_path / "map.npz"))["x"],
                       torch.ones(3))


@pytest.mark.parametrize("beta", [1, 0.5, 2])
def test_checkpointed_fit_matches_plain_fit(tmp_path, beta):
    V, W0, H0 = _nmf_problem(7)
    a = _cpu(W=W0, H=H0)
    n = checkpointed_fit(a, V, beta=beta, tol=NEG_INF, max_iter=15, every=5,
                         directory=str(tmp_path / "ck"))
    b = _cpu(W=W0, H=H0)
    b.fit(V, beta, NEG_INF, 15)
    assert n == 15
    assert _diff(a.W, b.W) < 1e-7 and _diff(a.H, b.H) < 1e-7
    files = [f for f in os.listdir(tmp_path / "ck") if f.endswith(".npz")]
    assert len(files) <= 2


def test_checkpointed_nmfd_fit_matches_plain_fit(tmp_path):
    rng = np.random.RandomState(3)
    V = rng.rand(1, 12, 60).astype("f") + 0.01
    W0 = rng.rand(12, 3, 6).astype("f") + 0.1
    H0 = rng.rand(1, 3, 55).astype("f") + 0.1
    a = NMFD(W=W0, H=H0, device="cpu")
    n = checkpointed_fit(a, V, beta=0.5, tol=NEG_INF, max_iter=12, every=4,
                         directory=str(tmp_path / "ck"))
    b = NMFD(W=W0, H=H0, device="cpu")
    b.fit(V, 0.5, NEG_INF, 12)
    assert n == 12
    assert _diff(a.W, b.W) < 1e-7 and _diff(a.H, b.H) < 1e-7


def test_checkpointed_fit_resume(tmp_path):
    V, W0, H0 = _nmf_problem(11, M=50, K=30, R=4)
    ckdir = str(tmp_path / "ck")
    a = _cpu(W=W0, H=H0)
    checkpointed_fit(a, V, beta=2, tol=NEG_INF, max_iter=10, every=5,
                     directory=ckdir)
    c = NMF(V.shape, 4, device="cpu")  # a new session: factors from disk
    n = checkpointed_fit(c, V, beta=2, tol=NEG_INF, max_iter=20, every=5,
                         directory=ckdir)
    b = _cpu(W=W0, H=H0)
    b.fit(V, 2, NEG_INF, 20)
    assert n == 20
    assert _diff(c.W, b.W) < 1e-7 and _diff(c.H, b.H) < 1e-7


def test_checkpointed_fit_converged_resume_is_noop(tmp_path):
    V = np.random.RandomState(17).rand(40, 24).astype("f")
    ckdir = str(tmp_path / "ck")
    m = NMF(V.shape, 3, device="cpu")
    n1 = checkpointed_fit(m, V, beta=1, tol=0.5, max_iter=200, every=10,
                          directory=ckdir)
    assert n1 < 200
    m2 = NMF(V.shape, 3, device="cpu")
    assert checkpointed_fit(m2, V, beta=1, tol=0.5, max_iter=200, every=10,
                            directory=ckdir) == n1
    assert torch.equal(m2.W, m.W)
    with pytest.raises(ValueError, match="different run"):
        checkpointed_fit(NMF(V.shape, 3, device="cpu"), V, beta=2, tol=0.5,
                         max_iter=50, every=10, directory=ckdir)


def test_checkpointed_fit_identity_and_tighter_tol(tmp_path):
    V = np.random.RandomState(29).rand(40, 24).astype("f")
    ckdir = str(tmp_path / "ck")
    n1 = checkpointed_fit(NMF(V.shape, 3, device="cpu"), V, beta=1, tol=0.5,
                          max_iter=200, every=10, directory=ckdir)
    assert n1 < 200
    with pytest.raises(ValueError):
        checkpointed_fit(NMF(V.shape, 3, device="cpu"), V, beta=1, tol=0.5,
                         max_iter=50, every=10, directory=ckdir, alpha=0.1,
                         l1_ratio=0.5)
    n3 = checkpointed_fit(NMF(V.shape, 3, device="cpu"), V, beta=1, tol=1e-9,
                          max_iter=n1 + 20, every=10, directory=ckdir)
    assert n3 > n1


def test_checkpointed_fit_rejects_bad_input(tmp_path):
    V, W0, H0 = _nmf_problem(5)
    with pytest.raises(ValueError, match="every"):
        checkpointed_fit(_cpu(W=W0, H=H0), V, every=0,
                         directory=str(tmp_path / "a"))
    os.makedirs(tmp_path / "b")
    np.savez(str(tmp_path / "b" / "ckpt_00000005.npz"), W=W0, H=H0)
    with pytest.raises(ValueError, match="resume metadata"):
        checkpointed_fit(_cpu(W=W0, H=H0), V, directory=str(tmp_path / "b"))


def test_checkpointed_fit_sparse_target(tmp_path):
    V = np.random.RandomState(13).rand(40, 24).astype("f")
    Vs = sparse_from_dense(torch.from_numpy(np.where(V > 0.7, V, 0)))
    m = NMF(V.shape, 3, device="cpu")
    W0, H0 = m.W.detach().clone(), m.H.detach().clone()
    n = checkpointed_fit(m, Vs, beta=1, tol=NEG_INF, max_iter=20, every=10,
                         directory=str(tmp_path / "c"))
    ref = NMF(W=W0, H=H0, device="cpu")
    ref.fit(Vs, 1, NEG_INF, 20)
    assert n == 20
    assert _diff(m.W, ref.W) < 1e-7 and bool(torch.isfinite(m.W).all())
    n2 = checkpointed_fit(NMF(V.shape, 3, device="cpu"), Vs, beta=1,
                          tol=1e-3, max_iter=60, every=20,
                          directory=str(tmp_path / "d"))
    assert 0 < n2 <= 60


def test_checkpointed_plca_fit_matches_and_resumes(tmp_path):
    V = np.random.RandomState(23).rand(40, 24).astype("f")
    a = PLCA(V.shape, 3, device="cpu")
    # the same start for the uninterrupted fit: the constructor would
    # renormalize given factors, which moves them by a few ulps
    b = PLCA(V.shape, 3, device="cpu")
    b.load_state_dict(a.state_dict())
    ckdir = str(tmp_path / "ck")
    n, norm = checkpointed_plca_fit(a, V, tol=NEG_INF, max_iter=15, every=5,
                                    directory=ckdir)
    b.fit(V, NEG_INF, 15)
    assert n == 15 and abs(float(norm) - float(V.sum())) < 1e-3
    for p, q in zip((a.W, a.H, a.Z), (b.W, b.H, b.Z)):
        assert _diff(p, q) < 1e-7
    c = PLCA(V.shape, 3, device="cpu")
    n2, _ = checkpointed_plca_fit(c, V, tol=NEG_INF, max_iter=25, every=5,
                                  directory=ckdir)
    b.fit(V, NEG_INF, 10)
    assert n2 == 25 and _diff(c.W, b.W) < 1e-7


# ---------------------------------------------------- across the packages
@pytest.mark.parametrize("beta", [1, 0.5])
def test_jax_checkpoint_resumed_by_port(jx, tmp_path, beta):
    V, W0, H0 = _nmf_problem(41)
    ckdir = str(tmp_path / "ck")
    jx.ckpt.checkpointed_fit(jx.nmf.NMF(W=W0, H=H0), V, beta=beta, tol=NEG_INF,
                             max_iter=10, every=5, directory=ckdir)
    m = NMF(V.shape, W0.shape[1], device="cpu")
    n = checkpointed_fit(m, V, beta=beta, tol=NEG_INF, max_iter=20, every=5,
                         directory=ckdir)
    ref = _cpu(W=W0, H=H0)
    ref.fit(V, beta, NEG_INF, 20)
    assert n == 20
    assert _rel(m.W, ref.W) < 1e-5 and _rel(m.H, ref.H) < 1e-5


@pytest.mark.parametrize("beta", [1, 2])
def test_port_checkpoint_resumed_by_jax(jx, tmp_path, beta):
    V, W0, H0 = _nmf_problem(43)
    ckdir = str(tmp_path / "ck")
    checkpointed_fit(_cpu(W=W0, H=H0), V, beta=beta, tol=NEG_INF, max_iter=10,
                     every=5, directory=ckdir)
    j = jx.nmf.NMF(V.shape, W0.shape[1])
    n = jx.ckpt.checkpointed_fit(j, V, beta=beta, tol=NEG_INF, max_iter=20,
                                 every=5, directory=ckdir)
    ref = jx.nmf.NMF(W=W0, H=H0)
    ref.fit(V, beta, NEG_INF, 20)
    assert n == 20
    assert _rel(np.asarray(j.W.data), np.asarray(ref.W.data)) < 1e-5
    assert _rel(np.asarray(j.H.data), np.asarray(ref.H.data)) < 1e-5


def test_plca_checkpoints_cross_the_packages(jx, tmp_path):
    V = np.random.RandomState(47).rand(30, 20).astype("f")
    p = PLCA(V.shape, 3, device="cpu")
    W0, H0, Z0 = (x.detach().numpy().copy() for x in (p.W, p.H, p.Z))
    ckdir = str(tmp_path / "ck")
    jx.ckpt.checkpointed_plca_fit(jx.plca.PLCA(W=W0, H=H0, Z=Z0), V,
                                  tol=NEG_INF, max_iter=10, every=5,
                                  directory=ckdir)
    n, _ = checkpointed_plca_fit(PLCA(V.shape, 3, device="cpu"), V,
                                 tol=NEG_INF, max_iter=20, every=5,
                                 directory=ckdir)
    q = PLCA(V.shape, 3, device="cpu")
    n2, _ = checkpointed_plca_fit(q, V, tol=NEG_INF, max_iter=20, every=5,
                                  directory=ckdir)
    ref = PLCA(W=W0, H=H0, Z=Z0, device="cpu")
    ref.fit(V, NEG_INF, 20)
    assert n == n2 == 20
    for a, b in zip((q.W, q.H, q.Z), (ref.W, ref.H, ref.Z)):
        assert _rel(a, b) < 1e-5


def test_foreign_run_is_refused_across_the_packages(jx, tmp_path):
    V, W0, H0 = _nmf_problem(53)
    ckdir = str(tmp_path / "ck")
    jx.ckpt.checkpointed_fit(jx.nmf.NMF(W=W0, H=H0), V, beta=1, tol=NEG_INF,
                             max_iter=5, every=5, directory=ckdir)
    with pytest.raises(ValueError, match="different run"):
        checkpointed_fit(_cpu(W=W0, H=H0), V, beta=2, tol=NEG_INF,
                         max_iter=10, every=5, directory=ckdir)


# ------------------------------------------------------------ LossHistory
def test_loss_history_matches_jax(jx):
    V, W0, H0 = _nmf_problem(31, M=50, K=30, R=4)
    m = _cpu(W=W0, H=H0)
    with LossHistory() as hist:
        m.fit(V, 1, 0, 40, verbose=True)
    with jx.utils.LossHistory() as jhist:
        jx.nmf.NMF(W=W0, H=H0).fit(V, 1, 0, 40, verbose=True)
    assert hist.chunks == jhist.chunks == [1, 2, 3, 4]
    assert hist.extras == [None] * 4
    np.testing.assert_allclose(hist.losses, jhist.losses, rtol=1e-5)
    assert hist.losses[-1] <= hist.losses[0]


def test_loss_history_plca_extras_match_jax(jx):
    V = np.random.RandomState(31).rand(50, 30).astype("f")
    p = PLCA(V.shape, 3, device="cpu")
    W0, H0, Z0 = (x.detach().numpy().copy() for x in (p.W, p.H, p.Z))
    with LossHistory() as hist:
        p.fit(V, 0, 30, verbose=True)
    with jx.utils.LossHistory() as jhist:
        jx.plca.PLCA(W=W0, H=H0, Z=Z0).fit(V, 0, 30, verbose=True)
    assert len(hist.losses) == 3 and all(e is not None for e in hist.extras)
    np.testing.assert_allclose(hist.losses, jhist.losses, rtol=1e-5)
    np.testing.assert_allclose(hist.extras, jhist.extras, rtol=1e-5)


def test_loss_history_records_only_verbose_fits_and_nests():
    V, W0, H0 = _nmf_problem(2)
    with LossHistory() as outer:
        _cpu(W=W0, H=H0).fit(V, 1, 0, 20)
        with LossHistory() as inner:
            _cpu(W=W0, H=H0).fit(V, 1, 0, 20, verbose=True)
    assert inner.chunks == outer.chunks == [1, 2]
    assert not solver._PROGRESS_HANDLERS


def test_progress_handlers_see_hoyer_and_sparse_fits():
    V, W0, H0 = _nmf_problem(4)
    seen = []
    solver.push_progress_handler(lambda k, loss, extra: seen.append(k))
    try:
        _cpu(W=W0, H=H0).sparse_fit(V, beta=2, max_iter=20, verbose=True,
                                    sW=0.5)
        Vs = sparse_from_dense(torch.from_numpy(np.where(V > 0.5, V, 0)))
        _cpu(W=W0, H=H0).fit(Vs, 1, 0, 10, verbose=True)
    finally:
        solver.pop_progress_handler()
    assert seen == [1, 2, 1]
    solver.pop_progress_handler()  # an empty stack: no error


# --------------------------------------------------------------- profiling
def test_profiling_helpers_on_the_cpu(tmp_path):
    logdir = str(tmp_path / "trace")
    with profiling.trace(logdir) as prof:
        with profiling.annotate("tiny-fit"):
            m = NMF((16, 8), 2, device="cpu")
            m.fit(np.random.RandomState(0).rand(16, 8).astype("f"), 2, 0, 5)
    files = os.listdir(logdir)
    assert files and all(f.endswith(".pt.trace.json") for f in files)
    assert any(e.key == "tiny-fit" for e in prof.key_averages())
    with profiling.trace(str(tmp_path / "quiet"), host_tracer_level=0):
        torch.ones(3).sum()
    assert os.listdir(tmp_path / "quiet")
    assert profiling.device_memory_stats("cpu") == {}
    assert isinstance(profiling.device_memory_stats(), dict)


# ------------------------------------------------------- PNT_SKIP_VALIDATE
def test_skip_validate(monkeypatch):
    V, W0, H0 = _nmf_problem(9)
    V[0, 0] = 0.0
    with pytest.raises(ValueError, match="beta <= 0"):
        _cpu(W=W0, H=H0).fit(V, 0, 0, 2)
    monkeypatch.setenv("PNT_SKIP_VALIDATE", "1")
    _cpu(W=W0, H=H0).fit(V + 0.01, 0, 0, 2)  # validation skipped, fits
    _cpu(W=W0, H=H0).fit(-V, 1, 0, 1)  # not even non-negativity is read
    Vs = sparse_from_dense(torch.from_numpy(V))
    with pytest.raises(ValueError, match="beta <= 0"):
        _cpu(W=W0, H=H0).fit(Vs, 0, 0, 2)  # a sparse target still refuses

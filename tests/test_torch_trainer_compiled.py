"""The trainers' compiled execution (``jit_compile=True``, the default).

On the CPU the compiled sweep is called directly: the port's default
``BetaMu`` and ``SparsityProj`` against the JAX package's compiled trainers
(``jit_compile=True``) from the same numpy inits, and the step cache (the
closure fingerprint, the LRU).  Tolerances (``max|Δ|/max|ref|``): every
parameter within 1e-4 after each of 3 ``BetaMu`` steps over β ∈ [-1, 3]
(the powers magnify float32 reordering), ``.grad`` after the first;
``SparsityProj`` within 1e-4 with the same float32 step size (1e-5 for a
step whose attempts all fail and for two groups with an unused
parameter), one host read a step and one a ``run``.  The seeds are ones
where no line-search decision sits at the edge.

CUDA tests (marked ``cuda``, skipped without a card): the graphed step
against the eager one on the card, within 1e-6 relative with the same
``.grad``; ``run(c, 30)`` against 30 eager steps; ``SparsityProj`` one
replay and one host read a step, one read a ``run``, allocated memory flat
over three optimizers; a closure that reads the host raises; ``.grad`` is
the caller's own.
``python -m pytest --noconftest -m cuda tests/test_torch_trainer_compiled.py``.
"""

import functools
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pytorch_nmf_tpu_torch import trainer as T  # noqa: E402
from pytorch_nmf_tpu_torch.metrics import beta_div  # noqa: E402
from pytorch_nmf_tpu_torch.nmf import NMF  # noqa: E402
from pytorch_nmf_tpu_torch.trainer import BetaMu, SparsityProj  # noqa: E402

RTOL = 1e-4


@pytest.fixture(scope="module")
def jx():
    """The JAX package's trainers, models and metrics."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    import pytorch_nmf_tpu as pnt
    from pytorch_nmf_tpu import metrics, trainer
    from pytorch_nmf_tpu.nmf import NMF as JNMF

    return SimpleNamespace(pnt=pnt, NMF=JNMF, trainer=trainer, metrics=metrics,
                           jnp=jnp)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    scale = np.abs(ref).max()
    return float(np.abs(got - ref).max() / scale) if scale else float(
        np.abs(got).max())


def _chain_inits(seed=0):
    rs = np.random.RandomState(seed)
    return [(rs.rand(*s) + 0.1).astype("f")
            for s in ((16, 8), (60, 8), (32, 16), (40, 32))]


def _port_chain(inits, device="cpu"):
    W1, H1, W2, W3 = inits
    return torch.nn.Sequential(NMF(W=W1, H=H1, device=device),
                               NMF(W=W2, device=device),
                               NMF(W=W3, device=device))


def _assert_params(port, ref, grads=True):
    for p, r in zip(port.parameters(), ref.parameters()):
        assert _rel(p.detach().cpu().numpy(), r.data) < RTOL
        if grads:
            assert _rel(p.grad.cpu().numpy(), r.grad) < RTOL


def _target(seed=1, shape=(60, 40)):
    return np.random.RandomState(seed).rand(*shape).astype("f")


@pytest.mark.parametrize("beta", [-1, 0, 0.5, 1, 1.5, 2, 3])
@pytest.mark.parametrize("regs", [(0, 0, 0), (1e-3, 1e-3, 1e-2)])
def test_compiled_betamu_matches_jax_jit(jx, beta, regs):
    inits, target = _chain_inits(), _target()
    port = _port_chain(inits)
    ref = jx.pnt.Sequential(*(jx.NMF(W=w, H=h) if h is not None else
                              jx.NMF(W=w) for w, h in
                              ((inits[0], inits[1]), (inits[2], None),
                               (inits[3], None))))
    tp = BetaMu(port.parameters(), beta, *regs)
    tj = jx.trainer.BetaMu(ref.parameters(), beta, *regs, jit_compile=True)
    V = torch.from_numpy(target)
    for i in range(3):
        tp.step(lambda: (V, port(None)))
        tj.step(lambda: (target, ref(None)))
        _assert_params(port, ref, grads=i == 0)
    assert len(tp._step_cache) == 1 and len(tj._step_cache) == 1


@pytest.mark.parametrize("beta", [0.5, 1, 2])
def test_compiled_betamu_run_matches_jax_jit(jx, beta):
    inits, target = _chain_inits(5), _target(6)
    port = _port_chain(inits)
    ref = jx.pnt.Sequential(jx.NMF(W=inits[0], H=inits[1]),
                            jx.NMF(W=inits[2]), jx.NMF(W=inits[3]))
    V = torch.from_numpy(target)
    assert BetaMu(port.parameters(), beta).run(lambda: (V, port(None)), 4) is None
    jx.trainer.BetaMu(ref.parameters(), beta).run(lambda: (target, ref(None)), 4)
    _assert_params(port, ref, grads=False)
    assert all(p.grad is not None for p in port.parameters())


def _sparsity_problem(jx, seed=7):
    rs = np.random.RandomState(seed)
    W0, H0 = rs.rand(40, 5).astype("f") + 0.1, rs.rand(80, 5).astype("f") + 0.1
    target = rs.rand(80, 40).astype("f")
    return NMF(W=W0, H=H0, device="cpu"), jx.NMF(W=W0, H=H0), target


@pytest.mark.parametrize("attr", ["W", "H"])
@pytest.mark.parametrize("how", ["step", "run"])
def test_compiled_sparsity_proj_matches_jax_jit(jx, attr, how):
    port, ref, target = _sparsity_problem(jx)
    V = torch.from_numpy(target)
    tp = SparsityProj([getattr(port, attr)], 0.3, max_iter=5)
    tj = jx.trainer.SparsityProj([getattr(ref, attr)], 0.3, max_iter=5,
                                 jit_compile=True)

    def cp():
        return beta_div(port(), V)

    def cj():
        return jx.metrics.beta_div(ref(), target)

    if how == "step":
        for _ in range(3):
            lp, lj = tp.step(cp), tj.step(cj)
    else:
        lp, lj = tp.run(cp, 3), tj.run(cj, 3)
    assert float(lp) == pytest.approx(float(lj), rel=RTOL)
    # the same float32 step size, to the bit
    assert tp.param_groups[0]["lr"] == tj.param_groups[0]["lr"]
    p, r = getattr(port, attr), getattr(ref, attr)
    assert _rel(p.detach().numpy(), r.data) < RTOL
    assert _rel(p.grad.numpy(), r.grad) < RTOL
    assert bool((p >= 0).all()) and len(tp._step_cache) == 1


@pytest.mark.parametrize("beta", [0, 1, 2])
def test_compiled_betamu_equals_eager(beta):
    """On the CPU the compiled sweep runs the eager step's operations: the
    parameters and every ``.grad`` agree to the bit, ``run`` included."""
    inits, V = _chain_inits(2), torch.from_numpy(_target(3))
    chains = [_port_chain(inits) for _ in range(2)]
    tc = BetaMu(chains[0].parameters(), beta, l2_reg=1e-3)
    te = BetaMu(chains[1].parameters(), beta, l2_reg=1e-3, jit_compile=False)
    closures = [lambda c=c: (V, c(None)) for c in chains]
    for _ in range(2):
        tc.step(closures[0])
        te.step(closures[1])
    tc.run(closures[0], 3)
    te.run(closures[1], 3)
    for a, b in zip(chains[0].parameters(), chains[1].parameters()):
        assert torch.equal(a, b) and torch.equal(a.grad, b.grad)
    assert len(tc._step_cache) == 1 and not te._step_cache


def _loss_fn(W0):
    def loss_of(w):
        return torch.sum((w - W0) ** 2) + 1e-3 * torch.sum(w)
    return loss_of


def test_compiled_sparsity_proj_all_attempts_fail_matches_eager():
    """Every attempt fails: the last one is undone too and the step halved
    once more, compiled as eagerly (float32 step sizes, exact here)."""
    W0 = torch.from_numpy(np.random.RandomState(8).rand(30, 4).astype("f") + 0.1)
    loss_of = _loss_fn(W0)
    Wc, We = (torch.nn.Parameter(W0.clone()) for _ in range(2))
    tc = SparsityProj([Wc], 0.3, max_iter=3)
    te = SparsityProj([We], 0.3, max_iter=3, jit_compile=False)
    lc, le = tc.step(lambda: loss_of(Wc)), te.step(lambda: loss_of(We))
    assert tc.param_groups[0]["lr"] == pytest.approx(0.5**3 * 1.2)
    assert tc.param_groups[0]["lr"] == pytest.approx(te.param_groups[0]["lr"])
    torch.testing.assert_close(Wc.detach(), We.detach(), rtol=1e-6, atol=1e-7)
    assert float(lc) == pytest.approx(float(le), rel=1e-6)
    torch.testing.assert_close(Wc.grad, We.grad)


def test_compiled_sparsity_proj_groups_and_disconnected_parameters():
    """Two groups, each with its own line search and step size, and a
    parameter the loss does not depend on (left alone, ``.grad`` None), as
    the eager step does."""
    rs = np.random.RandomState(9)
    vals = [torch.from_numpy(rs.rand(10, 4).astype("f") + 0.1) for _ in range(5)]
    A, B = vals[3], vals[4]

    def make(jit):
        pa, pb, pc = (torch.nn.Parameter(v.clone()) for v in vals[:3])
        sp = SparsityProj([{"params": [pa, pc]}, {"params": [pb], "lr": 0.5,
                                                   "sparsity": 0.6}],
                          0.4, jit_compile=jit)
        return sp, (pa, pb, pc), lambda: (torch.sum((pa - A) ** 2)
                                          + torch.sum((pb - B) ** 2))

    (sc, pc_, cc), (se, pe, ce) = make(True), make(False)
    for _ in range(3):
        lc, le = sc.step(cc), se.step(ce)
    assert np.isfinite(float(lc))
    assert float(lc) == pytest.approx(float(le), rel=1e-6)
    for g, h in zip(sc.param_groups, se.param_groups):
        assert g["lr"] == pytest.approx(h["lr"], rel=1e-6)
    for a, b in zip(pc_, pe):
        torch.testing.assert_close(a.detach(), b.detach(), rtol=1e-6, atol=1e-7)
    assert torch.equal(pc_[2].detach(), vals[2]) and pc_[2].grad is None
    assert sc.run(cc, 0) is None and len(sc._step_cache) == 1


def _fail_problem(seed=8):
    """A start from which every attempt of the first step fails: the
    loss's minimum is the start itself, off the sparse set."""
    return np.random.RandomState(seed).rand(30, 4).astype("f") + 0.1


@pytest.mark.parametrize("how", ["step", "run"])
def test_compiled_sparsity_proj_all_attempts_fail_matches_jax(jx, how):
    """Every attempt fails (the last undone, the step halved once more) in
    the first step, compiled against JAX's compiled step and ``run``: the
    same float32 step size, the parameter, loss and ``.grad`` within
    1e-5."""
    from pytorch_nmf_tpu.module import Parameter

    W0 = _fail_problem()
    pt, pj = torch.nn.Parameter(torch.from_numpy(W0.copy())), Parameter(W0)
    Wt = torch.from_numpy(W0)
    tp = SparsityProj([pt], 0.3, max_iter=3)
    tj = jx.trainer.SparsityProj([pj], 0.3, max_iter=3, jit_compile=True)

    def cp():
        return torch.sum((pt - Wt) ** 2) + 1e-3 * torch.sum(pt)

    def cj():
        return jx.jnp.sum((pj.value - W0) ** 2) + 1e-3 * jx.jnp.sum(pj.value)

    if how == "step":
        lp, lj = tp.step(cp), tj.step(cj)
        assert tp.param_groups[0]["lr"] == pytest.approx(0.5**3 * 1.2)
        for _ in range(2):
            lp, lj = tp.step(cp), tj.step(cj)
    else:
        lp, lj = tp.run(cp, 3), tj.run(cj, 3)
    assert tp.param_groups[0]["lr"] == tj.param_groups[0]["lr"]
    assert float(lp) == pytest.approx(float(lj), rel=1e-5)
    assert _rel(pt.detach().numpy(), pj.data) < 1e-5
    assert _rel(pt.grad.numpy(), pj.grad) < 1e-5


@pytest.mark.parametrize("how", ["step", "run"])
def test_compiled_sparsity_proj_groups_match_jax(jx, how):
    """Two groups (their own step sizes and sparseness) and a parameter the
    loss does not use (left alone, ``.grad`` None), compiled against JAX's
    compiled step and ``run``: every step size bit for bit, the parameters,
    the loss and ``.grad`` within 1e-5."""
    from pytorch_nmf_tpu.module import Parameter

    rs = np.random.RandomState(9)
    vals = [rs.rand(10, 4).astype("f") + 0.1 for _ in range(5)]
    A, B = vals[3], vals[4]
    pt = [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in vals[:3]]
    pj = [Parameter(v) for v in vals[:3]]

    def groups(ps):
        return [{"params": [ps[0], ps[2]]},
                {"params": [ps[1]], "lr": 0.5, "sparsity": 0.6}]

    tp = SparsityProj(groups(pt), 0.4)
    tj = jx.trainer.SparsityProj(groups(pj), 0.4, jit_compile=True)
    At, Bt = torch.from_numpy(A), torch.from_numpy(B)

    def cp():
        return torch.sum((pt[0] - At) ** 2) + torch.sum((pt[1] - Bt) ** 2)

    def cj():
        jnp = jx.jnp
        return (jnp.sum((pj[0].value - A) ** 2)
                + jnp.sum((pj[1].value - B) ** 2))

    if how == "step":
        for _ in range(3):
            lp, lj = tp.step(cp), tj.step(cj)
    else:
        lp, lj = tp.run(cp, 3), tj.run(cj, 3)
    assert float(lp) == pytest.approx(float(lj), rel=1e-5)
    for g, h in zip(tp.param_groups, tj.param_groups):
        assert g["lr"] == h["lr"]
    for a, b in zip(pt[:2], pj[:2]):
        assert _rel(a.detach().numpy(), b.data) < 1e-5
        assert _rel(a.grad.numpy(), b.grad) < 1e-5
    assert np.array_equal(pt[2].detach().numpy(), vals[2]) and pt[2].grad is None
    assert pj[2].grad is None


def test_compiled_sparsity_proj_reads_the_host_once_a_step():
    """The compiled step reads the step sizes once (one read for every
    group); ``run`` reads them once in all.  Each keeps the eager loop's
    flag reads on the CPU only (``_line_search.reads``: one more than the
    attempts a group)."""
    m, V = _small_nmf(16)
    sp = SparsityProj([m.W], 0.5)

    def closure():
        return beta_div(m(), V, 2)

    r0 = T._read_lrs.reads
    sp.step(closure)
    assert T._read_lrs.reads - r0 == 1
    sp.run(closure, 4)
    assert T._read_lrs.reads - r0 == 2
    assert sp.run(closure, 0) is None and T._read_lrs.reads - r0 == 2
    assert T._line_search.reads > 5


def _small_nmf(seed=10):
    rs = np.random.RandomState(seed)
    m = NMF(W=rs.rand(20, 4).astype("f") + 0.1, H=rs.rand(30, 4).astype("f") + 0.1,
            device="cpu")
    return m, torch.from_numpy(rs.rand(30, 20).astype("f"))


def test_step_cache_keys():
    """Two lambdas on one source line share an entry; rebinding the captured
    target, or a parameter's ``.data``, or changing β misses."""
    m, V = _small_nmf()
    tr = BetaMu(m.parameters(), 1)
    for _ in range(3):
        tr.step(lambda: (V, m()))
    assert len(tr._step_cache) == 1
    V = V * 0.5  # the closure's cell now holds another tensor
    tr.step(lambda: (V, m()))
    assert len(tr._step_cache) == 2
    m.H.data = m.H.detach().clone()  # new storage, same values
    tr.step(lambda: (V, m()))
    assert len(tr._step_cache) == 3
    tr.param_groups[0]["beta"] = 2
    for _ in range(2):
        tr.step(lambda: (V, m()))
    assert len(tr._step_cache) == 4


def test_in_place_writes_to_a_captured_tensor_are_seen():
    """A target written in place keeps the key, and the next compiled step
    reads its new values (the JAX package would replay its baked copy)."""
    (m1, V1), (m2, V2) = _small_nmf(11), _small_nmf(11)
    tc = BetaMu(m1.parameters(), 1)
    te = BetaMu(m2.parameters(), 1, jit_compile=False)
    for k in range(2):
        if k:
            for V in (V1, V2):
                V.mul_(2.0)
        tc.step(lambda: (V1, m1()))
        te.step(lambda: (V2, m2()))
    assert len(tc._step_cache) == 1
    for a, b in zip(m1.parameters(), m2.parameters()):
        assert torch.equal(a, b)


def test_partial_closure_runs_the_eager_step():
    (m1, V1), (m2, V2) = _small_nmf(12), _small_nmf(12)
    tc = BetaMu(m1.parameters(), 0.5)
    te = BetaMu(m2.parameters(), 0.5, jit_compile=False)

    def closure(V, m):
        return V, m()

    assert T._closure_fingerprint(functools.partial(closure, V1, m1)) is None
    tc.step(functools.partial(closure, V1, m1))
    te.step(lambda: (V2, m2()))
    assert not tc._step_cache
    for a, b in zip(m1.parameters(), m2.parameters()):
        assert torch.equal(a, b) and torch.equal(a.grad, b.grad)


def test_step_cache_holds_at_most_eight_entries():
    m, V = _small_nmf(13)
    tr = BetaMu(m.parameters(), 2)
    targets = [V * (1 + k / 10) for k in range(T._STEP_CACHE_MAX + 3)]
    for t in targets:
        tr.step(lambda t=t: (t, m()))  # each a distinct captured target
    assert len(tr._step_cache) == T._STEP_CACHE_MAX
    # the oldest entries went: their captured targets are no longer pinned
    pinned = {id(r) for e in tr._step_cache.values() for r in e["refs"]}
    assert id(targets[0]) not in pinned and id(targets[-1]) in pinned


def test_compiled_step_on_mixed_devices_raises():
    m, V = _small_nmf(14)
    stray = torch.nn.Parameter(torch.ones(3, device="meta"))
    with pytest.raises(ValueError, match="one device"):
        BetaMu(list(m.parameters()) + [stray], 1).step(lambda: (V, m()))
    with pytest.raises(ValueError, match="one device"):
        SparsityProj([m.W, stray], 0.5).step(lambda: beta_div(m(), V))


def test_grad_is_the_callers_own_tensor():
    m, V = _small_nmf(15)
    tr = BetaMu(m.parameters(), 1)

    def closure():
        return V, m()

    tr.step(closure)
    kept = m.W.grad
    snapshot = kept.clone()
    tr.step(closure)
    assert m.W.grad is not kept and torch.equal(kept, snapshot)
    (entry,) = tr._step_cache.values()
    assert m.W.grad.data_ptr() not in {g.data_ptr() for g in entry["grads"]}


# -- on the card -------------------------------------------------------------
def _card_pair(cuda, seed=20):
    inits, target = _chain_inits(seed), _target(seed + 1)
    chains = [_port_chain(inits, cuda) for _ in range(2)]
    V = torch.from_numpy(target).to(cuda)
    return chains, V


def _card_rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("beta", [0.5, 1, 2])
def test_cuda_graphed_step_matches_eager(cuda, beta):
    (cc, ce), V = _card_pair(cuda)
    tc = BetaMu(cc.parameters(), beta)
    te = BetaMu(ce.parameters(), beta, jit_compile=False)
    before = T._Graphs.replays
    tc.step(lambda: (V, cc(None)))  # warm-up, capture, one replay
    te.step(lambda: (V, ce(None)))
    assert T._Graphs.replays - before == 1
    for a, b in zip(cc.parameters(), ce.parameters()):
        assert _card_rel(a.detach(), b.detach()) <= 1e-6
        assert _card_rel(a.grad, b.grad) <= 1e-6
    tc.run(lambda: (V, cc(None)), 30)
    te.run(lambda: (V, ce(None)), 30)
    assert T._Graphs.replays - before == 31
    for a, b in zip(cc.parameters(), ce.parameters()):
        assert _card_rel(a.detach(), b.detach()) <= 1e-5
        assert bool(torch.isfinite(a.grad).all())


@pytest.mark.cuda
def test_cuda_graphed_sparsity_proj_matches_eager(cuda):
    rs = np.random.RandomState(21)
    W0, H0 = rs.rand(400, 8).astype("f") + 0.1, rs.rand(300, 8).astype("f") + 0.1
    V = torch.from_numpy(rs.rand(300, 400).astype("f")).to(cuda)
    ms = [NMF(W=W0, H=H0, device=cuda) for _ in range(2)]
    H = ms[0].H.detach()
    lr = float(np.float32(1.0 / float(torch.linalg.matrix_norm(H.T @ H, 2))))
    tc = SparsityProj([{"params": [ms[0].W], "lr": lr}], 0.5)
    te = SparsityProj([{"params": [ms[1].W], "lr": lr}], 0.5, jit_compile=False)

    def cc():
        return beta_div(ms[0](), V, 2)

    def ce():
        return beta_div(ms[1](), V, 2)

    tc.step(cc)  # builds: warm-ups, capture, one replay
    te.step(ce)
    r0, p0 = T._read_lrs.reads, T._Graphs.replays
    s0 = T._line_search.reads
    for _ in range(4):
        lc, le = tc.step(cc), te.step(ce)
    # one replay and one host read a step, whatever the attempts
    assert T._read_lrs.reads - r0 == 4 and T._Graphs.replays - p0 == 4
    assert T._line_search.reads == s0
    assert float(lc) == pytest.approx(float(le), rel=1e-5)
    assert _card_rel(ms[0].W.detach(), ms[1].W.detach()) <= 1e-5
    assert tc.param_groups[0]["lr"] == pytest.approx(te.param_groups[0]["lr"],
                                                     rel=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["fail", "groups"])
def test_cuda_graphed_sparsity_proj_step_and_run(cuda, case):
    """Backtracking steps (every attempt failing; two groups and an unused
    parameter): the graphed step against the same step called eagerly on
    the card (``_graph=False``), bit for bit with the same float32 step
    sizes; one replay and one host read a step, ``steps`` replays and one
    read a ``run``."""
    def make(graph):
        if case == "fail":
            W0 = torch.from_numpy(_fail_problem()).to(cuda)
            p = torch.nn.Parameter(W0.clone())
            return [p], SparsityProj([p], 0.3, max_iter=3, _graph=graph), (
                lambda: torch.sum((p - W0) ** 2) + 1e-3 * torch.sum(p))
        rs = np.random.RandomState(9)
        vals = [torch.from_numpy(rs.rand(10, 4).astype("f") + 0.1).to(cuda)
                for _ in range(5)]
        ps = [torch.nn.Parameter(v.clone()) for v in vals[:3]]
        sp = SparsityProj([{"params": [ps[0], ps[2]]},
                           {"params": [ps[1]], "lr": 0.5, "sparsity": 0.6}],
                          0.4, _graph=graph)
        return ps, sp, lambda: (torch.sum((ps[0] - vals[3]) ** 2)
                                + torch.sum((ps[1] - vals[4]) ** 2))

    (pg, sg, cg), (pe, se, ce) = make(True), make(False)
    lg, le = sg.step(cg), se.step(ce)
    r0, p0 = T._read_lrs.reads, T._Graphs.replays
    for _ in range(3):
        lg = sg.step(cg)
        le = se.step(ce)
    assert T._read_lrs.reads - r0 == 6 and T._Graphs.replays - p0 == 3
    lg = sg.run(cg, 5)
    le = se.run(ce, 5)
    assert T._read_lrs.reads - r0 == 8 and T._Graphs.replays - p0 == 8
    assert torch.equal(lg, le)
    for g, h in zip(sg.param_groups, se.param_groups):
        assert g["lr"] == h["lr"]
    for a, b in zip(pg, pe):
        assert torch.equal(a.detach(), b.detach())
        assert (a.grad is None) == (b.grad is None)
        if a.grad is not None:
            assert torch.equal(a.grad, b.grad)


@pytest.mark.cuda
def test_cuda_sparsity_proj_keeps_no_memory(cuda):
    """Three compiled optimizers in turn, each dropped: the card's
    allocated memory as before (the graphs, their device loops' pools and
    streams go with them)."""
    import gc

    def one():
        rs = np.random.RandomState(17)
        m = NMF(W=rs.rand(20, 4).astype("f") + 0.1,
                H=rs.rand(30, 4).astype("f") + 0.1, device=cuda)
        V = torch.from_numpy(rs.rand(30, 20).astype("f")).to(cuda)
        sp = SparsityProj([m.W], 0.5)
        sp.run(lambda: beta_div(m(), V, 2), 3)

    one()
    gc.collect()
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated()
    for _ in range(3):
        one()
        gc.collect()
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated() == allocated


@pytest.mark.cuda
def test_cuda_closure_reading_the_host_raises(cuda):
    (cc, _), V = _card_pair(cuda, 22)
    tr = BetaMu(cc.parameters(), 1)
    before = [p.detach().clone() for p in cc.parameters()]

    def closure():
        WH = cc(None)
        if float(WH.detach().sum()) < 0:  # a host read
            raise AssertionError
        return V, WH

    with pytest.raises(RuntimeError, match="jit_compile=False"):
        tr.step(closure)
    for b, p in zip(before, cc.parameters()):
        assert torch.equal(b, p.detach())  # the warm-up was undone
    BetaMu(cc.parameters(), 1, jit_compile=False).step(closure)


@pytest.mark.cuda
def test_cuda_grad_is_not_the_graphs_buffer(cuda):
    (cc, _), V = _card_pair(cuda, 23)
    tr = BetaMu(cc.parameters(), 1)

    def closure():
        return V, cc(None)

    tr.step(closure)
    kept = [p.grad for p in cc.parameters()]
    snap = [g.clone() for g in kept]
    tr.run(closure, 3)
    (entry,) = tr._step_cache.values()
    buffers = {g.data_ptr() for g in entry["grads"]}
    for p, k, s in zip(cc.parameters(), kept, snap):
        assert torch.equal(k, s) and p.grad.data_ptr() not in buffers


@pytest.mark.cuda
def test_cuda_step_with_nothing_to_update(cuda):
    """No parameter the closure depends on: nothing is captured or run, and
    the parameters and their ``.grad`` are left alone."""
    (cc, ce), V = _card_pair(cuda, 24)
    tr = BetaMu(ce.parameters(), 1)
    before = [p.detach().clone() for p in ce.parameters()]
    tr.step(lambda: (V, cc(None)))
    tr.run(lambda: (V, cc(None)), 2)
    for b, p in zip(before, ce.parameters()):
        assert torch.equal(b, p.detach()) and p.grad is None

"""The trainers: the port's ``BetaMu`` and ``SparsityProj`` optimizers
against the JAX package's, from the same numpy inits: ``BetaMu`` eager
(``jit_compile=False``, the semantics the port keeps), ``SparsityProj``
compiled (the JAX default; its step size is float32, the eager one's a
Python float, which takes the same decisions at these seeds).

Composition is ``torch.nn.Sequential`` of the port's ``NMF`` modules against
the JAX package's ``Sequential``.  Tolerances (``max|Δ|/max|ref|``): every
parameter within 1e-4 after each of 3 ``BetaMu`` steps (β ∈ [-1, 3]: the
powers magnify float32 reordering), every ``.grad`` after the first;
``SparsityProj`` after 3 steps within 1e-4, with the same step size.  The seeds are ones where no line
search decision sits at the edge.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pytorch_nmf_tpu_torch.metrics import beta_div
from pytorch_nmf_tpu_torch.nmf import NMF
from pytorch_nmf_tpu_torch.ops.trainer_core import sparsity_proj_step
from pytorch_nmf_tpu_torch.trainer import BetaMu, SparsityProj

RTOL = 1e-4


@pytest.fixture(scope="module")
def jx():
    """The JAX package's trainers, models and metrics."""
    pytest.importorskip("jax")
    import pytorch_nmf_tpu as pnt
    from pytorch_nmf_tpu import metrics, trainer
    from pytorch_nmf_tpu.nmf import NMF as JNMF

    return SimpleNamespace(pnt=pnt, NMF=JNMF, trainer=trainer, metrics=metrics)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    scale = np.abs(ref).max()
    return float(np.abs(got - ref).max() / scale) if scale else float(
        np.abs(got).max())


def _chain_inits(seed=0):
    rs = np.random.RandomState(seed)
    return [(rs.rand(*s) + 0.1).astype("f")
            for s in ((16, 8), (60, 8), (32, 16), (40, 32))]


def _chains(jx, inits):
    """The same three-layer chain in both packages: ``NMF`` of a 60×16
    output, then two ``NMF``\\ s that take the previous output as ``H``."""
    W1, H1, W2, W3 = inits
    port = torch.nn.Sequential(NMF(W=W1, H=H1, device="cpu"),
                               NMF(W=W2, device="cpu"), NMF(W=W3, device="cpu"))
    ref = jx.pnt.Sequential(jx.NMF(W=W1, H=H1), jx.NMF(W=W2), jx.NMF(W=W3))
    return port, ref


def _assert_params(port, ref, grads=True):
    for p, r in zip(port.parameters(), ref.parameters()):
        assert _rel(p.detach().numpy(), r.data) < RTOL
        if grads:
            assert _rel(p.grad.numpy(), r.grad) < RTOL


@pytest.mark.parametrize("beta", [-1, 0, 0.5, 1, 1.5, 2, 3])
@pytest.mark.parametrize("regs", [(0, 0, 0), (1e-3, 1e-3, 1e-2)])
def test_betamu_chain_matches_jax(jx, beta, regs):
    port, ref = _chains(jx, _chain_inits())
    target = np.random.RandomState(1).rand(60, 40).astype("f")
    tp = BetaMu(port.parameters(), beta, *regs)
    tj = jx.trainer.BetaMu(ref.parameters(), beta, *regs, jit_compile=False)
    for i in range(3):
        tp.step(lambda: (torch.from_numpy(target), port(None)))
        tj.step(lambda: (target, ref(None)))
        # the gradient is a difference of two near-equal terms: held on the
        # first sweep, before the inputs drift apart in float32
        _assert_params(port, ref, grads=i == 0)
    for p in port.parameters():
        assert bool((p >= 0).all())


@pytest.mark.parametrize("beta", [0, 1, 2])
@pytest.mark.parametrize("attr", ["W", "H"])
def test_betamu_grad_is_the_divergence_gradient(beta, attr):
    """After one step, ``.grad`` is the autograd gradient of the
    β-divergence at the parameter's value before the step (reference
    tests/test_trainer.py:54-73)."""
    rs = np.random.RandomState(2)
    W0, H0 = rs.rand(50, 5).astype("f") + 0.1, rs.rand(100, 5).astype("f") + 0.1
    target = torch.from_numpy(rs.rand(100, 50).astype("f"))
    m = NMF(W=W0, H=H0, device="cpu")
    p = getattr(m, attr)
    trainer = BetaMu([p], beta)

    def closure():
        trainer.zero_grad()
        return target, m()

    trainer.step(closure)
    x = torch.from_numpy(W0 if attr == "W" else H0).requires_grad_(True)
    args = (torch.from_numpy(H0), x) if attr == "W" else (x, torch.from_numpy(W0))
    (want,) = torch.autograd.grad(beta_div(NMF.reconstruct(*args), target, beta), x)
    torch.testing.assert_close(p.grad, want, rtol=0, atol=1e-4)


def test_betamu_skips_frozen_and_disconnected_parameters():
    """A frozen parameter and one the prediction does not depend on keep
    their values, and their ``.grad`` stays ``None``, even with
    regularization (reference trainer.py:75-77)."""
    rs = np.random.RandomState(3)
    m1 = NMF(W=rs.rand(20, 4).astype("f"), H=rs.rand(30, 4).astype("f"),
             device="cpu")
    m2 = NMF(W=rs.rand(15, 3).astype("f"), H=rs.rand(25, 3).astype("f"),
             device="cpu")  # not in the closure's graph
    m1.W.requires_grad_(False)
    before = [p.detach().clone() for p in (m1.W, m2.W, m2.H, m1.H)]
    target = torch.from_numpy(rs.rand(30, 20).astype("f"))
    trainer = BetaMu(list(m1.parameters()) + list(m2.parameters()), beta=2,
                     l1_reg=0.1)
    trainer.step(lambda: (target, m1()))
    for p, b in zip((m1.W, m2.W, m2.H), before):
        assert torch.equal(p.detach(), b) and p.grad is None
    assert not torch.equal(m1.H.detach(), before[3]) and m1.H.grad is not None


def test_param_groups_match_jax(jx):
    rs = np.random.RandomState(4)
    W0, H0 = rs.rand(20, 4).astype("f") + 0.1, rs.rand(40, 4).astype("f") + 0.1
    target = rs.rand(40, 20).astype("f")
    port, ref = NMF(W=W0, H=H0, device="cpu"), jx.NMF(W=W0, H=H0)
    tp = BetaMu([{"params": [port.W], "beta": 2}, {"params": [port.H]}],
                beta=1, l1_reg=1e-3)
    tj = jx.trainer.BetaMu([{"params": [ref.W], "beta": 2},
                            {"params": [ref.H]}], beta=1, l1_reg=1e-3,
                           jit_compile=False)
    assert len(tp.param_groups) == 2 and tp.param_groups[1]["beta"] == 1
    for _ in range(3):
        tp.step(lambda: (torch.from_numpy(target), port()))
        tj.step(lambda: (target, ref()))
    _assert_params(port, ref)


def test_invalid_hyperparameters_raise():
    m = NMF((10, 10), 2, device="cpu", generator=torch.Generator())
    for kw in (dict(l1_reg=-1), dict(l2_reg=-1), dict(orthogonal=-1)):
        with pytest.raises(ValueError):
            BetaMu(m.parameters(), 1, **kw)
    for s in (0, 1, 1.5):
        with pytest.raises(ValueError):
            SparsityProj([m.W], s)
    with pytest.raises(ValueError):
        BetaMu([], 1)
    assert isinstance(BetaMu(m.parameters(), jit_compile=False),
                      torch.optim.Optimizer)


def test_run_equals_repeated_step():
    inits = _chain_inits(5)
    target = torch.from_numpy(np.random.RandomState(6).rand(60, 40).astype("f"))
    chains = [torch.nn.Sequential(NMF(W=inits[0], H=inits[1], device="cpu"),
                                  NMF(W=inits[2], device="cpu"),
                                  NMF(W=inits[3], device="cpu"))
              for _ in range(2)]
    t_step, t_run = (BetaMu(c.parameters(), 1) for c in chains)
    for _ in range(4):
        t_step.step(lambda: (target, chains[0](None)))
    assert t_run.run(lambda: (target, chains[1](None)), 4) is None
    for a, b in zip(chains[0].parameters(), chains[1].parameters()):
        assert torch.equal(a, b) and torch.equal(a.grad, b.grad)
    before = [p.detach().clone() for p in chains[1].parameters()]
    assert t_run.run(lambda: (target, chains[1](None)), 0) is None
    for b, p in zip(before, chains[1].parameters()):
        assert torch.equal(b, p.detach())
    with pytest.raises(ValueError):
        t_run.run(lambda: (target, chains[1](None)), -1)


@pytest.mark.parametrize("attr", ["W", "H"])
def test_sparsity_proj_matches_jax(jx, attr):
    rs = np.random.RandomState(7)
    W0, H0 = rs.rand(40, 5).astype("f") + 0.1, rs.rand(80, 5).astype("f") + 0.1
    target = rs.rand(80, 40).astype("f")
    port, ref = NMF(W=W0, H=H0, device="cpu"), jx.NMF(W=W0, H=H0)
    tp = SparsityProj([getattr(port, attr)], 0.3, max_iter=5)
    tj = jx.trainer.SparsityProj([getattr(ref, attr)], 0.3, max_iter=5)
    for _ in range(3):
        lp = tp.step(lambda: beta_div(port(), torch.from_numpy(target)))
        lj = tj.step(lambda: jx.metrics.beta_div(ref(), target))
    assert float(lp) == pytest.approx(float(lj), rel=RTOL)
    assert tp.param_groups[0]["lr"] == pytest.approx(tj.param_groups[0]["lr"],
                                                     rel=1e-6)
    _assert_params(port, ref, grads=False)
    p = getattr(port, attr)
    assert bool((p >= 0).all())
    assert _rel(p.grad.numpy(), getattr(ref, attr).grad) < RTOL


def test_sparsity_proj_all_attempts_fail_matches_the_step():
    """A loss that any projection makes worse: every attempt fails, the last
    one is undone and the step halved once more, as
    :func:`sparsity_proj_step` does (JAX tests/test_functional.py:191)."""
    rs = np.random.RandomState(8)
    W0 = torch.from_numpy(rs.rand(30, 4).astype("f") + 0.1)
    W = torch.nn.Parameter(W0.clone())

    def loss_of(w):
        return torch.sum((w - W0) ** 2) + 1e-3 * torch.sum(w)

    tr = SparsityProj([W], 0.3, max_iter=3)
    loss = tr.step(lambda: loss_of(W))
    new, lr, want_loss = sparsity_proj_step(lambda p: loss_of(p[0]), [W0], 1.0,
                                            0.3, max_iter=3)
    assert tr.param_groups[0]["lr"] == pytest.approx(0.5**3 * 1.2) == lr
    torch.testing.assert_close(W.detach(), new[0], rtol=1e-6, atol=1e-7)
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-6)


def test_sparsity_proj_leaves_disconnected_parameters_and_runs():
    rs = np.random.RandomState(9)
    pa = torch.nn.Parameter(torch.from_numpy(rs.rand(10, 4).astype("f")))
    pb = torch.nn.Parameter(torch.from_numpy(rs.rand(10, 4).astype("f")))
    before = pb.detach().clone()
    sp = SparsityProj([pa, pb], 0.5)
    assert sp.run(lambda: torch.sum(pa**2), 3) is not None
    assert torch.equal(before, pb.detach()) and pb.grad is None
    assert pa.grad is not None
    assert sp.run(lambda: torch.sum(pa**2), 0) is None

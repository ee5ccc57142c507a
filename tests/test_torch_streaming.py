"""``streaming_nmf_fit`` (V in host memory, read in row blocks) against the
JAX package's, and against the port's in-memory ``NMF.fit``, from the same
numpy target and inits.

Tolerances (``max|Δ|/max|ref|``): 1e-5 against JAX's streaming fit after
``ITERS`` iterations and against the in-memory fit (the same ``n_iter``
under ``tol=1e-4``): the blocks change float32 summation order only.
CUDA tests (marked ``cuda``, skipped without a card):
``python -m pytest --noconftest -m cuda tests/test_torch_streaming.py``.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pytorch_nmf_tpu_torch import functional as F
from pytorch_nmf_tpu_torch.nmf import NMF
from pytorch_nmf_tpu_torch.ops import fused_mu
from pytorch_nmf_tpu_torch.ops.streaming import streaming_nmf_fit

ITERS = 12
RTOL = 1e-5
M, K, R, BLOCK = 90, 40, 5, 32  # three blocks, the last one short


@pytest.fixture(scope="module")
def jx():
    """The JAX package's streaming fit."""
    pytest.importorskip("jax")
    from pytorch_nmf_tpu.ops import streaming

    return SimpleNamespace(streaming_nmf_fit=streaming.streaming_nmf_fit)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _problem(seed=31):
    rs = np.random.RandomState(seed)
    V = rs.rand(M, K).astype("f") + 0.01
    W0 = rs.rand(K, R).astype("f") + 0.1
    H0 = rs.rand(M, R).astype("f") + 0.1
    return V, W0, H0


def _memmap(tmp_path, V):
    mm = np.memmap(str(tmp_path / "V.dat"), dtype="float32", mode="w+",
                   shape=V.shape)
    mm[:] = V
    mm.flush()
    return mm


@pytest.mark.parametrize("beta", [2, 1, 0.5, 0])
@pytest.mark.parametrize("memmap", [False, True])
def test_streaming_matches_jax(jx, tmp_path, beta, memmap):
    V, W0, H0 = _problem()
    src = _memmap(tmp_path, V) if memmap else V
    W, H, n = streaming_nmf_fit(src, torch.from_numpy(W0), torch.from_numpy(H0),
                                beta=beta, tol=0, max_iter=ITERS,
                                row_block=BLOCK)
    jW, jH, jn = jx.streaming_nmf_fit(src, W0, H0, beta=beta, tol=0,
                                      max_iter=ITERS, row_block=BLOCK)
    assert n == jn
    assert _rel(W, jW) < RTOL and _rel(H, jH) < RTOL


@pytest.mark.parametrize("kw", [
    dict(beta=1, l1_reg=0.1), dict(beta=0.5, l2_reg=0.2),
    dict(beta=2, l1_reg=0.05, l2_reg=0.05),
    dict(beta=1, update_W=False), dict(beta=0.5, update_H=False),
    dict(beta=2, update_W=False)])
def test_streaming_options_match_jax(jx, kw):
    V, W0, H0 = _problem(seed=3)
    W, H, n = streaming_nmf_fit(V, torch.from_numpy(W0), torch.from_numpy(H0),
                                tol=0, max_iter=ITERS, row_block=BLOCK, **kw)
    jW, jH, jn = jx.streaming_nmf_fit(V, W0, H0, tol=0, max_iter=ITERS,
                                      row_block=BLOCK, **kw)
    assert n == jn
    assert _rel(W, jW) < RTOL and _rel(H, jH) < RTOL
    if kw.get("update_W") is False:
        assert np.array_equal(W.numpy(), W0)
    if kw.get("update_H") is False:
        assert np.array_equal(H.numpy(), H0)


@pytest.mark.parametrize("beta", [2, 1, 0.5, 1.5])
@pytest.mark.parametrize("block", [BLOCK, M, 7])
def test_streaming_equals_in_memory_fit(tmp_path, beta, block):
    """The same ``n_iter`` under ``tol=1e-4`` and the same factors as the
    in-memory fit (``tests/test_functional.py``'s streaming test)."""
    V, W0, H0 = _problem(seed=31)
    W, H, n = F.streaming_nmf_fit(_memmap(tmp_path, V), torch.from_numpy(W0),
                                  torch.from_numpy(H0), beta=beta, tol=1e-4,
                                  max_iter=60, row_block=block)
    m = NMF(W=W0, H=H0, device="cpu")
    n_ref = m.fit(torch.from_numpy(V), beta, 1e-4, 60)
    assert n == n_ref
    assert _rel(W, m.W.detach()) < RTOL and _rel(H, m.H.detach()) < RTOL


def test_streaming_keeps_the_factors_device_and_dtype():
    V, W0, H0 = _problem()
    W, H, _ = streaming_nmf_fit(V.astype("f8"), torch.from_numpy(W0),
                                torch.from_numpy(H0), max_iter=3,
                                row_block=BLOCK)
    assert W.device.type == H.device.type == "cpu"
    assert W.dtype == H.dtype == torch.float32
    W64, H64, _ = streaming_nmf_fit(V, torch.from_numpy(W0.astype("f8")),
                                    torch.from_numpy(H0.astype("f8")),
                                    beta=0.5, tol=0, max_iter=ITERS,
                                    row_block=BLOCK)
    W32, H32, _ = streaming_nmf_fit(V, torch.from_numpy(W0),
                                    torch.from_numpy(H0), beta=0.5, tol=0,
                                    max_iter=ITERS, row_block=BLOCK)
    assert W64.dtype == torch.float64
    assert _rel(W32, W64) < RTOL and _rel(H32, H64) < RTOL


def test_streaming_rejects_mismatched_shapes():
    V, W0, H0 = _problem()
    with pytest.raises(ValueError, match="do not form"):
        streaming_nmf_fit(V, torch.from_numpy(W0[:-1]), torch.from_numpy(H0))


def test_streaming_cpu_fit_never_launches():
    V, W0, H0 = _problem()
    before = (fused_mu.fused_contractions.launches,
              fused_mu.fused_beta_loss.launches)
    streaming_nmf_fit(V, torch.from_numpy(W0), torch.from_numpy(H0),
                      beta=0.5, max_iter=10, row_block=BLOCK)
    assert (fused_mu.fused_contractions.launches,
            fused_mu.fused_beta_loss.launches) == before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("beta", [1, 0.5, 2])
def test_cuda_streaming_runs_b1_per_block(cuda, beta):
    """On the card: 2 B1 launches a block an iteration (none at β=2, the
    Gram products), one B2 a block a loss evaluation at β ∉ {1, 2}; the
    factors equal the in-memory fit's to 1e-5."""
    V, W0, H0 = _problem()
    blocks = -(-M // BLOCK)
    fused_mu.fused_contractions.launches = fused_mu.fused_beta_loss.launches = 0
    W, H, n = streaming_nmf_fit(V, torch.from_numpy(W0).to(cuda),
                                torch.from_numpy(H0).to(cuda), beta=beta,
                                tol=float("-inf"), max_iter=20, row_block=BLOCK)
    assert W.is_cuda and H.is_cuda and n == 20
    assert fused_mu.fused_contractions.launches == (
        0 if beta == 2 else 2 * blocks * 20)
    assert fused_mu.fused_beta_loss.launches == (
        0 if beta in (1, 2) else blocks * 3)
    m = NMF(W=W0, H=H0, device=cuda)
    m.fit(torch.from_numpy(V).to(cuda), beta, float("-inf"), 20)
    assert _rel(W.cpu(), m.W.detach().cpu()) < RTOL
    assert _rel(H.cpu(), m.H.detach().cpu()) < RTOL

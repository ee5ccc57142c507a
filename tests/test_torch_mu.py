"""The port's generic MU engine against the JAX package's, on the same
numpy inputs: ``mu_update`` through ``linear``, ``gamma_from_beta``, the
analytic β=1 denominators, norms and ``renorm``.

Tolerance: rtol 1e-5 — the same float32 GEMMs and elementwise maps; only
the summation order differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_nmf_tpu import utils as jutils
from pytorch_nmf_tpu.ops import mu as jmu
from pytorch_nmf_tpu.ops import recon as jrecon
from pytorch_nmf_tpu_torch import utils as tutils
from pytorch_nmf_tpu_torch.ops import mu as tmu
from pytorch_nmf_tpu_torch.ops import recon as trecon

RTOL = 1e-5
M, K, R = 37, 29, 5


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(0)
    V = rs.rand(M, K).astype("f") + 0.01
    W = rs.rand(K, R).astype("f") + 0.1
    H = rs.rand(M, R).astype("f") + 0.1
    return V, W, H


# analytic_kl: the precomputed β=1 denominator, which exists only at β=1
@pytest.mark.parametrize(
    "beta, analytic_kl",
    [(0, False), (0.5, False), (1, False), (1, True), (1.5, False),
     (2, False), (3, False)],
)
@pytest.mark.parametrize("side", ["W", "H"])
@pytest.mark.parametrize("l1_reg, l2_reg", [(0.0, 0.0), (0.05, 0.1)])
def test_mu_update_matches_jax(data, beta, side, analytic_kl, l1_reg, l2_reg):
    V, W, H = data
    gamma = jmu.gamma_from_beta(beta)

    def run(mu, recon, asarr):
        v, w, h = asarr(V), asarr(W), asarr(H)
        if side == "W":
            pos = mu.kl_pos_W(h) if analytic_kl else None
            return mu.mu_update(lambda x: recon.linear(h, x), v, w, beta,
                                gamma, l1_reg, l2_reg, pos)
        pos = mu.kl_pos_H(w) if analytic_kl else None
        return mu.mu_update(lambda x: recon.linear(x, w), v, h, beta, gamma,
                            l1_reg, l2_reg, pos)

    got = run(tmu, trecon, torch.from_numpy)
    ref = run(jmu, jrecon, jnp.asarray)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL)


@pytest.mark.parametrize("beta", [-1, 0, 0.5, 1, 1.5, 2, 2.5, 4])
def test_gamma_from_beta_matches_jax(beta):
    assert tmu.gamma_from_beta(beta) == jmu.gamma_from_beta(beta)


@pytest.mark.parametrize("kind", ["kl_pos_W", "kl_pos_H", "get_norm"])
def test_rank_reductions_match_jax(data, kind):
    _, W, H = data
    x = H if kind == "kl_pos_W" else W
    got = getattr(tmu, kind)(torch.from_numpy(x))
    ref = getattr(jmu, kind)(jnp.asarray(x))
    assert tuple(got.shape) == tuple(ref.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL)


@pytest.mark.parametrize("unit_norm", ["W", "H"])
def test_renorm_matches_jax(data, unit_norm):
    _, W, H = data
    gw, gh = tmu.renorm(torch.from_numpy(W), torch.from_numpy(H), unit_norm)
    rw, rh = jmu.renorm(jnp.asarray(W), jnp.asarray(H), unit_norm)
    np.testing.assert_allclose(gw.numpy(), np.asarray(rw), rtol=RTOL)
    np.testing.assert_allclose(gh.numpy(), np.asarray(rh), rtol=RTOL)


def test_renorm_rejects_unknown_factor(data):
    _, W, H = data
    with pytest.raises(ValueError):
        tmu.renorm(torch.from_numpy(W), torch.from_numpy(H), "Z")


@pytest.mark.parametrize("fn", ["normalize", "renorm"])
@pytest.mark.parametrize("axis", [None, 0, 1])
def test_utils_match_jax(data, fn, axis):
    _, W, _ = data
    got = getattr(tutils, fn)(torch.from_numpy(W), axis=axis)
    ref = getattr(jutils, fn)(jnp.asarray(W), axis=axis)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL)


def test_linear_keeps_float64():
    rs = np.random.RandomState(1)
    H, W = rs.rand(6, 3), rs.rand(4, 3)
    out = trecon.linear(torch.from_numpy(H), torch.from_numpy(W).float())
    assert out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), H @ W.astype("f").T, rtol=1e-12)

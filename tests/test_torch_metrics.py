"""The port's metrics against the JAX package's, on the same numpy inputs.

Tolerance: rtol 1e-5 — both sum the same float32 terms, in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_nmf_tpu import metrics as jm
from pytorch_nmf_tpu_torch import metrics as tm

RTOL = 1e-5


def _pair(seed, zeros=False):
    rs = np.random.RandomState(seed)
    recon = rs.rand(40, 30).astype("f") + 0.05
    target = rs.rand(40, 30).astype("f")
    if zeros:
        target[rs.rand(40, 30) < 0.1] = 0.0
    return recon, target


def _both(fn_j, fn_t, *arrays, **kw):
    got = float(fn_t(*(torch.from_numpy(a) for a in arrays), **kw))
    ref = float(fn_j(*(jnp.asarray(a) for a in arrays), **kw))
    return got, ref


@pytest.mark.parametrize("beta", [-1, 0, 0.5, 1, 1.5, 2, 3])
def test_beta_div_matches_jax(beta):
    recon, target = _pair(0, zeros=beta > 0)
    got, ref = _both(jm.beta_div, tm.beta_div, recon, target, beta=beta)
    np.testing.assert_allclose(got, ref, rtol=RTOL)


@pytest.mark.parametrize(
    "name, zeros",
    [("kl_div", True), ("euclidean", True), ("is_div", False)],
)
def test_closed_form_divergences_match_jax(name, zeros):
    recon, target = _pair(1, zeros=zeros)
    got, ref = _both(getattr(jm, name), getattr(tm, name), recon, target)
    np.testing.assert_allclose(got, ref, rtol=RTOL)


@pytest.mark.parametrize("shape", [(50,), (12, 7)])
def test_sparseness_matches_jax(shape):
    x = np.random.RandomState(2).rand(*shape).astype("f")
    x[x < 0.3] = 0.0
    got, ref = _both(jm.sparseness, tm.sparseness, x)
    np.testing.assert_allclose(got, ref, rtol=RTOL)

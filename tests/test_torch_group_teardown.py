"""C12: ``torch.distributed.destroy_process_group`` after a compiled sharded
fit, with no ``compiled_cache_clear()`` before it.  A compiled fit's cache
entry (``ops/solver.py``) holds CUDA graphs with the group's captured NCCL
kernels, and NCCL's teardown of the group waited for those graphs: the
call hung.  The port's ``parallel.comm.drop_entries_on_destroy`` makes
the call drop the entries of the groups it destroys first.

The port runs in 2 gloo rank processes on the CPU
(``_torch_parallel_child``, one group for the file, started once by a
module-scoped fixture, with its timeout: a hang fails the group, not the
suite).  A flow per fit kind: a compiled fit (an entry holding the
group), a single-card fit (an entry holding none), a group of every rank
made anew with a compiled fit on it and that group alone destroyed (its
entries go, the first group's stay), then ``destroy_process_group()``
with no clear (every entry holding a group goes, the single-card one
stays), a new group and a fit on it: a cold one, bit for bit the first.

The CUDA test runs the same on one NCCL rank on the card, where the call
hung: it returns within the group's timeout.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from _torch_parallel_child import run_group  # noqa: E402

ITERS = 30  # three chunks: two eager, a third the loop's capture on the card


def _nmf_problem(seed, M=40, K=24, R=4):
    rs = np.random.RandomState(seed)
    return {"V": rs.rand(M, K).astype("f") + 0.01,
            "W": rs.rand(K, R).astype("f") + 0.1,
            "H": rs.rand(M, R).astype("f") + 0.1}


def _plca_problem(seed, M=40, K=24, R=4):
    rs = np.random.RandomState(seed)
    W = rs.rand(K, R).astype("f") + 0.1
    H = rs.rand(M, R).astype("f") + 0.1
    Z = rs.rand(R).astype("f") + 0.1
    return {"V": rs.rand(M, K).astype("f"), "W": W / W.sum(0),
            "H": H / H.sum(0), "Z": Z / Z.sum()}


def _nmfd_problem(seed, C=6, R=2, L=40, T=3):
    rs = np.random.RandomState(seed)
    return {"V": rs.rand(1, C, L).astype("f") + 0.01,
            "W": rs.rand(C, R, T).astype("f") + 0.1,
            "H": rs.rand(1, R, L - T + 1).astype("f") + 0.1}


_STEPS = [dict(do="fit", out="a", inputs="dtensor"),
          dict(do="single"),
          dict(do="subgroup"),
          dict(do="regroup", clear=False),
          dict(do="fit", out="b", inputs="dtensor")]
# fit kind, mesh, keyword arguments, problem
FLOWS = {
    "teardown_nmf": ("nmf", {"data": 2}, dict(beta=1), _nmf_problem(80)),
    "teardown_plca": ("plca", {"data": 2}, {}, _plca_problem(81)),
    "teardown_nmfd": ("nmfd", {"seq": 2}, dict(beta=1), _nmfd_problem(82)),
}


def _cases(device="cpu"):
    cases, arrays = [], {}
    for name, (fit, axes, kw, p) in FLOWS.items():
        cases.append({"name": name, "kind": "compiled", "fit": fit,
                      "axes": axes, "device": device,
                      "kw": dict(kw, tol=0, max_iter=ITERS), "steps": _STEPS})
        arrays.update({f"{name}:{k}": v for k, v in p.items()})
    return cases, arrays


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    cases, arrays = _cases()
    return run_group(tmp_path_factory.mktemp("torch_group_teardown"), 2,
                     cases, arrays, timeout=300)


def _check_flow(out, name):
    assert "error" not in out, bytes(out["error"]).decode()
    # the subgroup's destruction drops its entry alone
    assert (int(out["sub_before"]), int(out["others_before"])) == (1, 1)
    assert (int(out["sub_after"]), int(out["others_after"])) == (0, 1)
    # destroy_process_group() with no clear: every entry that holds a
    # group goes, the single-card fit's stays
    assert bool(out["regrouped"])
    assert int(out["group_entries_before"]) == 1
    assert int(out["group_entries_after"]) == 0
    assert int(out["entries_after"]) == int(out["entries_before"]) - 1 >= 1
    # the group made again: a cold fit, bit for bit the first
    assert int(out["b_cold"]) == 1 and int(out["b_hits"]) == 0
    names = ("W", "H", "Z") if FLOWS[name][0] == "plca" else ("W", "H")
    for k in names + ("n_iter",):
        np.testing.assert_array_equal(out[f"b_{k}"], out[f"a_{k}"], err_msg=k)
    # PLCA's n_iter is the raw loop index (the reference's quirk)
    assert int(out["a_n_iter"]) == ITERS - (FLOWS[name][0] == "plca")


@pytest.mark.parametrize("name", list(FLOWS))
def test_destroy_drops_the_groups_entries(port, name):
    for rank in range(2):
        _check_flow(port[rank][name], name)


@pytest.mark.cuda
def test_cuda_destroy_returns_without_a_cache_clear(tmp_path):
    """One NCCL rank on the card: each flow's compiled fit captures its
    collectives (2 eager chunks, the capture, one replay), and
    ``destroy_process_group`` of the subgroup and of the default group,
    with no cache clear, return within the rank's timeout (a hang fails
    the group)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cases, arrays = _cases("cuda")
    for c in cases:
        c["axes"] = {k: 1 for k in c["axes"]}
    out = run_group(tmp_path, 1, cases, arrays, timeout=300, backend="nccl")
    for name in FLOWS:
        got = out[0][name]
        _check_flow(got, name)
        assert tuple(got["a_graphs"]) == (1, 1)  # the cold fit's loop captured

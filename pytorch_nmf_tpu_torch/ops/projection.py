r"""Hoyer sparseness projection (counterpart of
:mod:`pytorch_nmf_tpu.ops.projection`).

Projects a vector onto ``{v >= 0 : ||v||_1 = k1, ||v||_2^2 = k2}`` (Hoyer'04,
"Non-negative Matrix Factorization with Sparseness Constraints"; reference
``_proj_func``, torchnmf/nmf.py:21-49).  Each round moves ``v`` along the
active coordinates to the L2 sphere and, if a coordinate went negative,
zeroes it and re-centres the rest, so ``N + 2`` rounds always suffice.

The JAX package vmaps a ``lax.while_loop`` over the rank columns.  On a CUDA
tensor every projection here is one launch of the hand-written kernel of
``csrc/hoyer_proj.cu``: it runs every column's rounds on the device, reads
the columns where they lie (any contiguous tensor, so NMFD's strided rank
columns are not copied) and reads nothing back to the host, so a projection
can be captured in a CUDA graph.  :func:`_plan` picks its regime from the
column's length: the column held in one CTA's shared memory, or in a
thread-block cluster's, or (longer still) streamed from HBM every round.
Launches are counted in ``proj_rows.launches``.  A float32 or float64 tensor
is taken; another dtype on the card raises, and so does a failed launch.

On a CPU tensor the plain PyTorch version runs (:func:`plain_proj_rows`):
the columns are the rows of one ``(R, N)`` tensor, each with its own
``done`` flag.  A finished row is frozen by the mask, as batched
``while_loop`` does, and never recomputed: the round is not idempotent in
float32.  With frozen rows an extra round changes nothing, so the host reads
``done.all()`` only every :data:`CHECK_EVERY` rounds and the result is still
exact.  Each read adds one to ``proj_rows.reads``.

Both run in the input's dtype (the JAX package's always in float32) with the
same arithmetic.  The discriminant follows the JAX package's jitted loop
rather than the reference's: ``b*b`` exact before the one rounding, and a
NaN discriminant (``inf - inf`` once a column's scale overflows ``b*b``)
taken as 0, so columns at scales near float32's limit stay finite where the
JAX package's do, and give NaN where it does.
"""

import ctypes
import functools
import math
from typing import NamedTuple

import torch

__all__ = ["hoyer_l1_target", "proj_func", "proj_rows", "plain_proj_rows",
           "proj_columns", "proj_columns_explicit"]

# rounds between two host reads of ``done.all()`` (the plain version)
CHECK_EVERY = 2


def hoyer_l1_target(dim: int, s: float) -> float:
    """L1 norm giving sparseness ``s`` at unit L2 for a ``dim``-vector
    (reference nmf.py:461,470)."""
    return dim**0.5 * (1 - s) + s


def plain_proj_rows(s: torch.Tensor, k1: torch.Tensor, k2: torch.Tensor,
                    return_rounds: bool = False):
    """Plain PyTorch version of the projection: every row of ``s (R, N)`` to
    L1 norm ``k1[r]`` and squared L2 norm ``k2[r]`` (``k1``, ``k2``:
    ``(R,)``).  With ``return_rounds`` also the rounds each row ran, an
    ``(R,)`` integer tensor."""
    R, N = s.shape
    k1 = k1.to(s.dtype)
    k2 = k2.to(s.dtype)
    v = s + ((k1 - s.sum(1)) / N)[:, None]
    zero = torch.zeros_like(s, dtype=torch.bool)
    done = torch.zeros(R, dtype=torch.bool, device=s.device)
    rounds = torch.zeros(R, dtype=torch.int64, device=s.device)
    for it in range(N + 2):
        rounds += ~done
        m = k1 / (N - zero.sum(1))
        w = torch.where(zero, v, v - m[:, None])
        a = (w * w).sum(1)
        b = 2.0 * (w * v).sum(1)
        c = (v * v).sum(1) - k2
        # the discriminant as the JAX package's jitted projection forms it:
        # ``b*b`` exact (XLA's fused multiply-add: the double product,
        # rounded once), NaN taken as 0 (its fused relu)
        d = (b.double() * b.double() - (4.0 * a * c).double()).to(s.dtype)
        alphap = (-b + torch.sqrt(torch.where(d > 0, d, 0.0))) * 0.5 / a
        v_new = v + alphap[:, None] * w
        mask = v_new < 0
        fin = ~mask.any(1)
        zero_fix = zero | mask
        v_fix = torch.relu(v_new)
        v_fix = torch.relu(v_fix + ((k1 - v_fix.sum(1))
                                    / (N - zero_fix.sum(1)))[:, None])
        # rows finished earlier keep their state (batched while_loop)
        upd = (~done)[:, None]
        v = torch.where(upd, torch.where(fin[:, None], v_new, v_fix), v)
        zero = torch.where(upd & ~fin[:, None], zero_fix, zero)
        done = done | fin
        if (it + 1) % CHECK_EVERY == 0 and it + 1 < N + 2:
            proj_rows.reads += 1
            if bool(done.all()):
                break
    return (v, rounds) if return_rounds else v


def _targets(k, x: torch.Tensor, R: int) -> torch.Tensor:
    """``k`` (a scalar, or ``(R,)``) as ``R`` contiguous values of ``x``'s
    dtype on its device; a scalar is filled on the device, not copied."""
    if isinstance(k, torch.Tensor):
        return k.to(device=x.device, dtype=x.dtype).expand(R).contiguous()
    return torch.full((R,), float(k), dtype=x.dtype, device=x.device)


# the kernel's regimes, in the order of their codes in csrc/hoyer_proj.cu:
# (a) the column in one CTA's shared memory, (b) in a thread-block
# cluster's, (c) streamed from HBM every round
REGIMES = ("cta", "cluster", "stream")
# csrc/hoyer_proj.cu: bytes of sums ahead of a CTA's values, the largest
# cluster (16 needs the non-portable size the kernel allows), and the
# streaming kernel's threads
_HEADER = 1024
_MAX_CLUSTER = 16
_STREAM_THREADS = 1024
# a resident CTA's threads: about this many values a thread, 32 to 1024
# (chip_tools/p1_variants.py's ``threads`` sweep)
_VALUES_PER_THREAD = 4


class Plan(NamedTuple):
    """A launch of the projection kernel: its regime (one of
    :data:`REGIMES`), threads a CTA, CTAs a column (``cluster``), values a
    CTA holds (``slice``; 0 when streaming) and the dynamic shared memory a
    CTA asks for, in bytes."""
    regime: str
    threads: int
    cluster: int
    slice: int
    smem: int


def _smem_bytes(slice_: int, itemsize: int) -> int:
    """Shared memory of a resident CTA holding ``slice_`` values: the sums'
    header, then the values, an even count of them, each carrying its
    zeroed flag in its sign bit (``csrc/hoyer_proj.cu::resident_smem``)."""
    return _HEADER + (slice_ + slice_ % 2) * itemsize


@functools.lru_cache(maxsize=None)
def _plan(N: int, itemsize: int, smem_optin: int) -> Plan:
    """The kernel's launch for columns of ``N`` values of ``itemsize`` bytes
    on a card whose blocks may opt in to ``smem_optin`` bytes of shared
    memory: (a) ``cta`` when one CTA holds the column; else (b) ``cluster``,
    the smallest cluster of at most 16 CTAs that holds it, each CTA a
    ``slice`` (a multiple of 32 values, so that every slice starts on a
    16-byte boundary of a run) and the last the rest; else (c) ``stream``.
    A pure function of its arguments: the launch never changes regime on a
    failure."""
    cap = (smem_optin - _HEADER) // (32 * itemsize) * 32  # a CTA's slice
    if _smem_bytes(N, itemsize) <= smem_optin:
        regime, cluster, slice_ = "cta", 1, N
    elif N <= _MAX_CLUSTER * cap:
        cluster = -(-N // cap)
        per_cta = -(-N // cluster)
        regime, slice_ = "cluster", -(-per_cta // 32) * 32
    else:
        return Plan("stream", _STREAM_THREADS, 1, 0, 0)
    threads = min(1024, max(32, -(-slice_ // (32 * _VALUES_PER_THREAD)) * 32))
    return Plan(regime, threads, cluster, slice_, _smem_bytes(slice_, itemsize))


# the card's opt-in shared memory per block, by device index, read when the
# kernels' attributes were set on that device
_SMEM_OPTIN = {}


def _library(device: torch.device):
    """The projection kernel's library, its attributes set on ``device``
    (once per device, outside any graph capture), and the device's opt-in
    shared memory per block."""
    from ._build import load_library

    lib = load_library("hoyer_proj")
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _SMEM_OPTIN:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "the projection kernel's first launch on a device cannot be "
                "inside a CUDA graph capture: project once before capturing")
        optin = ctypes.c_int(0)
        with torch.cuda.device(index):
            err = lib.pnt_hoyer_proj_setup(ctypes.byref(optin))
        if err != 0:
            raise RuntimeError(f"hoyer_proj kernel setup failed: CUDA error {err}")
        _SMEM_OPTIN[index] = optin.value
    return lib, _SMEM_OPTIN[index]


def kernel_plan(x: torch.Tensor, axis: int) -> Plan:
    """The plan of the kernel's launch on the columns of the CUDA tensor
    ``x`` along ``axis``."""
    _, optin = _library(x.device)
    return _plan(x.numel() // x.shape[axis], x.element_size(), optin)


def max_active_clusters(x: torch.Tensor, axis: int) -> int:
    """``cudaOccupancyMaxActiveClusters`` of that launch: how many of its
    clusters (of its CTAs, for one CTA a column) the card runs at once."""
    lib, _ = _library(x.device)
    plan = kernel_plan(x, axis)
    out = ctypes.c_int(0)
    with torch.cuda.device(x.device):
        err = lib.pnt_hoyer_proj_occupancy(
            REGIMES.index(plan.regime), plan.threads, plan.cluster, plan.slice,
            int(x.dtype == torch.float64), ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"hoyer_proj occupancy query failed: CUDA error {err}")
    return out.value


def _kernel(x: torch.Tensor, axis: int, k1: torch.Tensor, k2: torch.Tensor,
            plan: Plan = None):
    """One launch of ``csrc/hoyer_proj.cu`` on the columns of ``x`` along
    ``axis``, read where they lie in the contiguous ``x``, as :func:`_plan`
    lays it out (or as ``plan`` does: a measurement may time one regime
    against another)."""
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the projection kernel takes float32 or float64, "
                        f"not {x.dtype}")
    x = x.contiguous()
    R = x.shape[axis]
    outer, inner = math.prod(x.shape[:axis]), math.prod(x.shape[axis + 1:])
    if x.numel() == 0:
        return x.clone()
    if x.numel() >= 2**31:
        raise ValueError("the projection kernel takes fewer than 2**31 values")
    lib, optin = _library(x.device)
    if plan is None:
        plan = _plan(outer * inner, x.element_size(), optin)
    v = torch.empty_like(x)
    # the streaming regime's zero mask (a byte a value, in HBM); the
    # resident regimes keep each flag in its value's sign bit
    zero = (torch.empty(x.shape, dtype=torch.uint8, device=x.device)
            if plan.regime == "stream" else None)
    err = lib.pnt_hoyer_proj(
        x.data_ptr(), v.data_ptr(), None if zero is None else zero.data_ptr(),
        k1.data_ptr(), k2.data_ptr(), R, outer, inner,
        int(x.dtype == torch.float64), REGIMES.index(plan.regime),
        plan.threads, plan.cluster, plan.slice,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"hoyer_proj kernel launch failed ({plan}): CUDA "
                           f"error {err}")
    proj_rows.launches += 1
    return v


def _project(x: torch.Tensor, axis: int, k1, k2) -> torch.Tensor:
    """Project every column of ``x`` along ``axis`` (the slice ``x[:, j]``,
    flattened) onto ``(k1[j], k2[j])``: the kernel on a CUDA tensor, the
    plain version on a CPU one."""
    R = x.shape[axis]
    k1, k2 = _targets(k1, x, R), _targets(k2, x, R)
    if x.device.type == "cuda":
        return _kernel(x, axis, k1, k2)
    if x.device.type != "cpu":
        raise ValueError(f"no projection kernel for device {x.device}")
    xm = x.movedim(axis, 0)
    proj = plain_proj_rows(xm.reshape(R, -1), k1, k2)
    return proj.reshape(xm.shape).movedim(0, axis)


def proj_rows(s: torch.Tensor, k1: torch.Tensor, k2: torch.Tensor):
    """Project every row of ``s (R, N)`` to L1 norm ``k1[r]`` and squared L2
    norm ``k2[r]`` (``k1``, ``k2``: ``(R,)``)."""
    return _project(s, 0, k1, k2)


proj_rows.reads = 0
proj_rows.launches = 0


def proj_func(s: torch.Tensor, k1, k2) -> torch.Tensor:
    """Project ``s`` (any shape, flattened) to L1 norm ``k1`` and squared L2
    norm ``k2``.  Shape-preserving."""
    return _project(s.reshape(1, -1), 0, k1, k2).reshape(s.shape)


def proj_columns(x: torch.Tensor, L1_scale: float, axis: int = 1,
                 norms: torch.Tensor = None) -> torch.Tensor:
    """Project every rank column of ``x`` (the slice ``x[:, j]`` along
    ``axis``, flattened) onto L1 norm ``L1_scale·norm_j`` and squared L2
    norm ``norm_j²`` (reference nmf.py:516-521, 564-569; trainer.py:170-177).
    ``norms`` defaults to the slices' own L2 norms; the SparsityProj trainer
    passes the norms of the parameter before its step."""
    if norms is None:
        dims = tuple(d for d in range(x.ndim) if d != axis)
        norms = torch.sqrt(torch.sum(x * x, dim=dims))
    return _project(x, axis, L1_scale * norms, norms * norms)


def proj_columns_explicit(x: torch.Tensor, k1s, k2s, axis: int = 1):
    """Project every column of ``x`` along ``axis`` onto explicit targets
    ``(k1s[j], k2s[j])``, scalars or ``(R,)`` (the initial projection to
    unit L2, reference nmf.py:463-464,472-473)."""
    return _project(x, axis, k1s, k2s)

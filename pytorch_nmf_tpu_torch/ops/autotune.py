r"""Per-fit engine selection for the deconvolutional family by timing
(counterpart of :mod:`pytorch_nmf_tpu.ops.autotune`).

Which MU engine is fastest is not a simple function of the shape: the
kernel engine (B3/B4) and the hybrid (B4 with the streamed fold) trade
places with the rank, the kernel extent and the length.  So a fit above a
size threshold times each engine that takes its shape, for its actual
(shape, β), on its own device, and keeps the winner; smaller fits keep the
static choice (:func:`~.fast_nmfd.resolve_nmfd_updater_factory`), where a
wrong choice costs microseconds and tuning would cost seconds.  The SIPLCA
family's EM reconstruction and the deconv models' Hoyer reconstruction are
resolved the same way (:func:`resolve_plca_recon3`,
:func:`resolve_hoyer_recon2`).

Candidates.  On a CUDA float32 or bfloat16 target (the tuner's key
carries a bfloat16 target's dtype) the candidates are the engines of
the hand-written kernels alone: ``fused`` (B3/B4) and ``fused_w`` (B4 and
the streamed fold); the EM and Hoyer reconstructions have one, ``fused``,
which is kept untimed.  The engines over library calls (``unfold``,
``torch.matmul`` GEMMs; ``autocorr``; ``conv``, the generic engine over
PyTorch's convolutions) are reached on the card only by a pin: an env
switch below, or a factory passed to the solver.  ``fft`` is a candidate
wherever ``PNT_NMFD_FFT=auto`` asks for it.  Elsewhere (a CPU target, where
the kernels' plain versions run, or under ``PNT_NMFD_PALLAS=0``) every
engine that takes the shape is a candidate, as in the JAX package.

Timing: each candidate runs the real ``upd_W``/``upd_H`` pair (its
``prepare`` layout done once, outside the timing) once to warm up, then a
pilot of 4 iterations; a candidate whose pilot is more than 3× the best so
far stops there.  The others are timed at two loop lengths (the least of
three runs each), and their per-iteration cost is the difference quotient,
so fixed costs cancel.  On the card the clock is CUDA events after
``torch.cuda.synchronize()``.  The first candidate is the static choice,
and another replaces it only when it is faster by more than
``_MARGIN`` (10%): engines that near tie must not trade places on a noisy
reading.

Only explicit predicates drop a candidate (the unfold budget, the
autocorrelation engine's regime, the FFT engine's β and rank); anything a
candidate raises while it is timed propagates, so a kernel that fails to
build or launch is never skipped unseen.

Environment (the JAX package's names and meanings):

* ``PNT_NMFD_AUTOTUNE=0`` — the static choice only; ``=1`` — tune whatever
  the size.
* ``PNT_AUTOTUNE_MIN_FLOPS`` — the threshold, in MACs of one iteration of
  the convolution form (default 1e9).
* ``PNT_AUTOTUNE_CACHE=/path.json`` — a persistent winner table, opt-in
  (else the table lives in the process).  Its keys carry the card's name
  (``torch.cuda.get_device_name``, or ``cpu``), and a winner that is no
  candidate of the port is ignored, so no other platform's winner is used.
* ``PNT_NMFD_UNFOLD=0`` — the generic engine; ``PNT_NMFD_FFT=1`` — the FFT
  engine at β=2 (``=auto``: a candidate); ``PNT_NMFD_AUTOCORR=1`` — the
  autocorrelation engine at β=2 (``=0``: not a candidate);
  ``PNT_NMFD_PALLAS=1`` — the hand-written kernel engine (B3/B4), ``=0`` —
  neither it nor the hybrid is a candidate, the library engines are, and
  the static choice becomes the unfold engine.
"""

import json
import os
import time

import numpy as np
import torch

from . import fast_nmfd
from . import solver as _solver
from .mu import gamma_from_beta

__all__ = [
    "clear_cache",
    "autotune_winner",
    "resolve_deconv_factory",
    "autotune_plca_recon3",
    "resolve_plca_recon3",
    "autotune_hoyer_recon2",
    "resolve_hoyer_recon2",
    "autotune_halo_mode",
]

# (platform, spatial_ndim | tag, beta, V_shape, H_shape) -> winner name
_WINNERS = {}
# the same keys -> {candidate: seconds per iteration}, as last measured
_MEASURED = {}
_MIN_FLOPS_DEFAULT = 1e9
# the long timing run's target length, seconds
_TARGET_S = 0.3
# how much faster than the static choice (the first candidate) another
# candidate must be to replace it
_MARGIN = 0.1


def clear_cache() -> None:
    _WINNERS.clear()
    _MEASURED.clear()


def _env(name: str) -> str:
    return os.environ.get(name, "")


def _persist_path():
    return _env("PNT_AUTOTUNE_CACHE")


def _key_str(key) -> str:
    platform, nd, beta, vs, hs = key[:5]
    return (f"{platform}|{nd}|{beta:g}|{','.join(map(str, vs))}|"
            f"{','.join(map(str, hs))}" + "".join(f"|{t}" for t in key[5:]))


def _target_tag(V) -> tuple:
    """The key's tail for the target's dtype: empty for float32 (every key
    before bfloat16 targets), ``("bfloat16",)`` for a bfloat16 target, whose
    engines read a half-width V and are timed on it."""
    return () if V.dtype == torch.float32 else (str(V.dtype)[6:],)


def _cached(key, names):
    """The winner of ``key``, in the process's table or the persistent
    file, if it is one of ``names`` (else ``None``: tune)."""
    if _WINNERS.get(key) in names:
        return _WINNERS[key]
    path = _persist_path()
    if not path or not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            hit = json.load(f).get(_key_str(key))
    except (OSError, ValueError):
        return None
    if hit not in names:
        return None
    _WINNERS[key] = hit
    return hit


def _save(key, winner: str, results) -> None:
    _WINNERS[key] = winner
    _MEASURED[key] = dict(results)
    path = _persist_path()
    if not path:
        return
    try:
        data = {}
        if os.path.exists(path):
            with open(path) as f:
                data = json.load(f)
        data[_key_str(key)] = winner
        with open(path, "w") as f:
            json.dump(data, f, indent=0, sort_keys=True)
            f.write("\n")
    except (OSError, ValueError):  # the file is a cache: best effort
        pass


def _platform(device) -> str:
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else device.type


def _conv_macs_per_iter(V_shape, H_shape) -> float:
    """The convolution form's MACs for one MU iteration (its four heavy
    contractions)."""
    N, C, R = int(V_shape[0]), int(V_shape[1]), int(H_shape[1])
    Lp = fast_nmfd._prod(V_shape[2:])
    K = fast_nmfd._prod(fast_nmfd._kernel_dims(V_shape, H_shape))
    return 4.0 * N * Lp * K * R * C


def _tuned(V_shape, H_shape) -> bool:
    """Whether this fit is timed: ``PNT_NMFD_AUTOTUNE`` forces either way,
    else the size threshold decides."""
    mode = _env("PNT_NMFD_AUTOTUNE")
    if mode in ("0", "1"):
        return mode == "1"
    min_flops = float(_env("PNT_AUTOTUNE_MIN_FLOPS") or _MIN_FLOPS_DEFAULT)
    return _conv_macs_per_iter(V_shape, H_shape) >= min_flops


def _kernels_allowed(dtype) -> bool:
    """The hand-written engines are candidates for a float32 or bfloat16
    target (their cotangents are float32 either way) unless
    ``PNT_NMFD_PALLAS=0``."""
    return dtype in (torch.float32, torch.bfloat16) and \
        _env("PNT_NMFD_PALLAS") != "0"


def _kernel_path(V) -> bool:
    """Whether this fit runs the hand-written kernels: a CUDA float32 or
    bfloat16 target, unless ``PNT_NMFD_PALLAS=0``.  There only the kernel
    engines are candidates."""
    return _kernel_device(V.device, V.dtype)


def _kernel_device(device, dtype) -> bool:
    """:func:`_kernel_path` of a fit on ``device`` in ``dtype``."""
    return torch.device(device).type == "cuda" and _kernels_allowed(dtype)


def _unfold_ok(V, H) -> bool:
    kernel = fast_nmfd._kernel_dims(V.shape, H.shape)
    return fast_nmfd.nmfd_unfold_supported(
        tuple(V.shape), (V.shape[1], H.shape[1]) + kernel, V.device)


def _candidates(V, H, beta: float, spatial_ndim: int):
    """``[(name, factory or None)]`` of the engines that take this fit, the
    static choice first, then in timing order (the likely fastest first,
    for the 3× rejection); ``None`` is the generic engine.  On the kernel
    path (:func:`_kernel_path`) the library engines are left out."""
    nd = spatial_ndim
    library = not _kernel_path(V)
    cands = []
    if _kernels_allowed(V.dtype):
        cands += [("fused", fast_nmfd.deconv_updater_factory_fused(nd)),
                  ("fused_w", fast_nmfd.deconv_updater_factory_fused_w(nd))]
    if library and _unfold_ok(V, H):
        cands.append(("unfold", fast_nmfd.deconv_updater_factory_unfold(nd)))
    if nd == 1 and beta == 2:
        if library and _env("PNT_NMFD_AUTOCORR") != "0" and \
                fast_nmfd.autocorr_supported(V.shape, H.shape, V.dtype,
                                             V.device):
            cands.append(("autocorr", fast_nmfd.nmfd_autocorr_updater_factory))
        if _env("PNT_NMFD_FFT") == "auto":
            cands.append(("fft", fast_nmfd.nmfd_fft_updater_factory))
    if library:
        cands.append(("conv", None))
    return cands


def _seconds(run, n: int, device, reps: int) -> float:
    """The least of ``reps`` timings of ``run(n)``: CUDA events on the card,
    the host clock elsewhere."""
    best = float("inf")
    cuda = torch.device(device).type == "cuda"
    for _ in range(reps):
        if cuda:
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run(n)
            end.record()
            end.synchronize()
            t = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            run(n)
            t = time.perf_counter() - t0
        best = min(best, t)
    return best


def _time_candidate(run, device, reps: int = 3, reject_above=None) -> float:
    """Seconds per iteration of ``run(n)`` (``n`` iterations) by the
    two-length difference quotient (each length the least of ``reps``
    runs).  A pilot above ``reject_above`` is returned as it is: no noise
    turns a candidate 3× slower than the best into the winner."""
    _seconds(run, 1, device, 1)  # warm-up: first launches, allocations
    pilot = 4
    per = max(_seconds(run, pilot, device, 1) / pilot, 1e-7)
    if reject_above is not None and per > reject_above:
        return per
    n_long = int(min(max(_TARGET_S / per, 8), 20000))
    n_short = max(n_long // 4, 2)
    d = _seconds(run, n_long, device, reps) - _seconds(run, n_short, device,
                                                       reps)
    if d <= 0:  # noise larger than the difference: the biased-high reading
        return _seconds(run, n_long, device, 1) / n_long
    return d / (n_long - n_short)


def _tune(key, cands, make_run, device) -> str:
    """Time ``cands`` (``[(name, x)]``, ``make_run(x) -> run(n)``; the first
    is the static choice) and keep the winner under ``key``: the fastest if
    it beats the first by more than ``_MARGIN``, else the first.  A lone
    candidate is kept untimed."""
    if not cands:
        raise RuntimeError(f"no engine takes this fit ({key})")
    if len(cands) == 1:
        _save(key, cands[0][0], {})
        return cands[0][0]
    results = {}
    for name, x in cands:
        best = min(results.values()) if results else None
        results[name] = _time_candidate(
            make_run(x), device,
            reject_above=None if best is None else 3.0 * best)
    static = cands[0][0]
    winner = min(results, key=results.get)
    if results[winner] > (1.0 - _MARGIN) * results[static]:
        winner = static
    _save(key, winner, results)
    return winner


def _mu_run(V, W, H, beta, factory, recon2):
    """``run(n)``: ``n`` MU iterations (W, then H against the new W) of the
    engine ``factory`` (``None``: the generic engine over ``recon2``), from
    its ``prepare`` layout."""
    gamma = gamma_from_beta(beta)
    updaters = factory(beta, gamma, 0.0, 0.0) if factory is not None else None
    if updaters is None:
        updaters = _solver._default_updaters(recon2, beta, gamma, 0.0, 0.0)
    upd_W, upd_H, _, prepare, _ = _solver._normalize_updaters(updaters)
    with torch.no_grad():
        state0 = (W, H) if prepare is None else prepare(V, W, H)

    @torch.no_grad()
    def run(n):
        w, h = state0
        for _ in range(n):
            w = upd_W(V, w, h)
            h = upd_H(V, w, h)
        return h

    return run


def autotune_winner(V, W, H, beta: float, spatial_ndim: int, recon2) -> str:
    """The fastest MU engine for this fit's (shape, β) on ``V``'s device,
    timed once and cached (in the process, and in ``PNT_AUTOTUNE_CACHE``
    when set)."""
    cands = _candidates(V, H, float(beta), spatial_ndim)
    key = (_platform(V.device), spatial_ndim, float(beta), tuple(V.shape),
           tuple(H.shape)) + _target_tag(V)
    hit = _cached(key, {n for n, _ in cands})
    if hit is not None:
        return hit
    return _tune(key, cands,
                 lambda f: _mu_run(V, W, H, float(beta), f, recon2), V.device)


def resolve_deconv_factory(V, W, H, beta: float, spatial_ndim: int, recon2):
    """The updater factory of a deconv fit (``None``: the generic engine):
    the env forces first, then float64 and the threshold (the static
    choice), then the measured winner."""
    if _env("PNT_NMFD_UNFOLD") == "0":
        return None
    if spatial_ndim == 1 and _env("PNT_NMFD_FFT") == "1":
        return fast_nmfd.nmfd_fft_updater_factory
    if spatial_ndim == 1 and beta == 2 and _env("PNT_NMFD_AUTOCORR") == "1":
        return fast_nmfd.nmfd_autocorr_updater_factory
    if _env("PNT_NMFD_PALLAS") == "1":
        return fast_nmfd.deconv_updater_factory_fused(spatial_ndim)
    if V.dtype == torch.float64 or not _tuned(V.shape, H.shape):
        return fast_nmfd.resolve_nmfd_updater_factory(V.device, V.dtype,
                                                      spatial_ndim)
    winner = autotune_winner(V, W, H, beta, spatial_ndim, recon2)
    return dict(_candidates(V, H, float(beta), spatial_ndim))[winner]


# --------------------------------------------------------------------------
# The reconstructions that autograd differentiates: the SIPLCA EM E-step
# and the deconv models' Hoyer steps
# --------------------------------------------------------------------------
def _recon_candidates(V, H, fused, unfold, conv):
    """The reconstructions that take this fit, the static choice first; on
    the kernel path (:func:`_kernel_path`) ``fused`` alone."""
    cands = []
    if _kernels_allowed(V.dtype):
        cands.append(("fused", fused))
    if _kernel_path(V):
        return cands
    if _unfold_ok(V, H):
        cands.append(("unfold", unfold))
    cands.append(("conv", conv))
    return cands


def _plca_candidates(cls, V, H):
    nd = cls._spatial_ndim
    return _recon_candidates(V, H, fast_nmfd._RECON3[nd, "fused"],
                             fast_nmfd._RECON3[nd, "unfold"], cls.reconstruct)


def _em_run(V, W, H, Z, recon3):
    """``run(n)``: ``n`` EM iterations (every factor updated, no priors) of
    the reconstruction ``recon3`` from ``(W, H, Z)`` on ``V / V.sum()``."""
    Vn = V / V.sum()

    @torch.no_grad()
    def run(n):
        state = (W, H, Z)
        for _ in range(n):
            state = _solver._plca_em_iter(
                recon3, True, True, True, False, False, False, Vn, state,
                1.0, 1.0, 1.0)
        return state

    return run


def autotune_plca_recon3(V, W, H, Z, cands) -> str:
    """The fastest EM reconstruction among ``cands`` (``[(name, recon3)]``)
    for this fit's shape, timed over whole EM iterations and cached."""
    key = (_platform(V.device), "plca-em", 0.0, tuple(V.shape),
           tuple(H.shape)) + _target_tag(V)
    hit = _cached(key, {n for n, _ in cands})
    if hit is not None:
        return hit
    return _tune(key, cands, lambda r: _em_run(V, W, H, Z, r), V.device)


def resolve_plca_recon3(cls, V, W, H, Z):
    """The EM reconstruction of a SIPLCA-family fit: the env forces first,
    then float64 and the threshold (the static choice,
    :func:`~.fast_nmfd.resolve_plca_recon3`), then the measured winner."""
    nd = cls._spatial_ndim
    if _env("PNT_NMFD_UNFOLD") == "0" or V.dtype == torch.float64:
        return cls.reconstruct
    if _env("PNT_NMFD_PALLAS") == "1":
        return fast_nmfd._RECON3[nd, "fused"]
    if not _tuned(V.shape, H.shape):
        return fast_nmfd.resolve_plca_recon3(cls, V.device, V.dtype)
    cands = _plca_candidates(cls, V, H)
    return dict(cands)[autotune_plca_recon3(V, W, H, Z, cands)]


def _hoyer_run(V, W, H, beta: float, recon2):
    """``run(n)``: ``n`` projected gradient steps of both factors through
    ``recon2`` (the Hoyer solver's dominant cost; its line search
    re-evaluates the loss, not the gradient)."""
    from ..constants import eps
    from ..metrics import beta_div

    def grad(f, x):
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(f(x), x)
        return g

    @torch.no_grad()
    def run(n):
        w, h = W, H
        for _ in range(n):
            gW = grad(lambda x: beta_div(recon2(h, x), V, beta), w)
            w = torch.clamp(w - 1e-3 * gW, min=eps)
            gH = grad(lambda x: beta_div(recon2(x, w), V, beta), h)
            h = torch.clamp(h - 1e-3 * gH, min=eps)
        return h

    return run


def autotune_hoyer_recon2(V, W, H, beta: float, cands) -> str:
    """The fastest reconstruction among ``cands`` (``[(name, recon2)]``) for
    the Hoyer steps, timed over :func:`_hoyer_run` and cached."""
    key = (_platform(V.device), "hoyer-recon2", float(beta), tuple(V.shape),
           tuple(H.shape)) + _target_tag(V)
    hit = _cached(key, {n for n, _ in cands})
    if hit is not None:
        return hit
    return _tune(key, cands, lambda r: _hoyer_run(V, W, H, float(beta), r),
                 V.device)


def resolve_hoyer_recon2(cls, V, W, H, beta: float):
    """The reconstruction a deconv model's Hoyer fit differentiates: the env
    forces first, then float64 and the threshold (the static choice,
    :func:`~.fast_nmfd.resolve_hoyer_recon2`), then the measured winner."""
    if _env("PNT_NMFD_UNFOLD") == "0" or V.dtype == torch.float64:
        return cls.reconstruct
    if _env("PNT_NMFD_PALLAS") == "1":
        return fast_nmfd.kernel_adjoint_deconv
    if not _tuned(V.shape, H.shape):
        return fast_nmfd.resolve_hoyer_recon2(cls, V.device, V.dtype)
    cands = _recon_candidates(V, H, fast_nmfd.kernel_adjoint_deconv,
                              fast_nmfd.unfold_deconv, cls.reconstruct)
    return dict(cands)[autotune_hoyer_recon2(V, W, H, beta, cands)]


# --------------------------------------------------------------------------
# The halo fits' per-shard mode (the sharded deconv and SIPLCA fits of
# :mod:`..parallel.halo`)
# --------------------------------------------------------------------------
def _halo_shapes(n_batch, C, lead_shapes, chunk, kernel, R):
    """``(v_proxy, h_proxy, v_local, h_local)``: the single-card problem
    whose activation is one rank's chunk (the kernel path's threshold and
    key), and the rank's VALID problem (the library path's threshold), as
    the JAX package counts them."""
    lead_out = tuple(s + k - 1 for s, k in zip(lead_shapes, kernel[:-1]))
    T = kernel[-1]
    return ((n_batch, C) + lead_out + (chunk + T - 1,),
            (n_batch, R) + lead_shapes + (chunk,),
            (n_batch, C) + lead_out + (chunk,),
            (n_batch, R) + lead_shapes + (chunk - T + 1,))


def _halo_key(device, n_batch, C, lead_shapes, chunk, kernel, R, beta,
              kernel_path: bool):
    """The cache key of a halo mode decision: the card's name,
    ``halo{nd}``, β and the local shapes (the proxy's on the kernel path,
    ``V`` and ``(R, *kernel)`` on the library path, as the JAX package)."""
    v_proxy, h_proxy, v_local, _ = _halo_shapes(n_batch, C, lead_shapes,
                                                chunk, kernel, R)
    if kernel_path:
        return (_platform(device), f"halo{len(kernel)}", float(beta), v_proxy,
                h_proxy)
    return (_platform(device), f"halo{len(kernel)}", float(beta), v_local,
            (R,) + kernel)


def _halo_tune(key, names, n_batch, C, lead_shapes, chunk, kernel, R, beta,
               device) -> str:
    """Time the per-shard ``names`` (the static choice first) on one
    rank's local problem, with the real per-shard step and no collectives
    (:func:`..parallel.halo._local_run`), and keep the winner (:func:`_tune`)."""
    from ..parallel.halo import _local_run

    hit = _cached(key, set(names))
    if hit is not None:
        return hit
    _, h_chunk, v_local, _ = _halo_shapes(n_batch, C, lead_shapes, chunk,
                                          kernel, R)
    rs = np.random.RandomState(0)

    def arr(shape, lo):
        return torch.from_numpy(rs.rand(*shape).astype("f") + lo).to(device)

    Vl, Wl, Hp = (arr(v_local, 0.01), arr((C, R) + kernel, 0.1),
                  arr(h_chunk, 0.1))
    return _tune(key, [(n, n) for n in names],
                 lambda m: _local_run(m, Vl, Wl, Hp, beta), device)


def _halo_mode(n_batch, C, lead_shapes, chunk, kernel, R, beta,
               heuristic_mode, allow_pallas, device, dtype) -> str:
    """Rank 0's resolution (:func:`autotune_halo_mode`)."""
    if dtype == torch.float64:
        return "conv"
    if _env("PNT_NMFD_PALLAS") == "1":
        return "fused"
    v_proxy, h_proxy, v_local, h_local = _halo_shapes(
        n_batch, C, lead_shapes, chunk, kernel, R)
    args = (n_batch, C, lead_shapes, chunk, kernel, R, beta)
    if _kernel_device(device, dtype):
        if not allow_pallas or not _tuned(v_proxy, h_proxy):
            return "fused"
        return _halo_tune(_halo_key(device, *args, True), ("fused", "fused_w"),
                          *args, device)
    if heuristic_mode != "unrolled" or not _tuned(v_local, h_local):
        return heuristic_mode
    return _halo_tune(_halo_key(device, *args, False), ("unrolled", "conv"),
                      *args, device)


def autotune_halo_mode(n_batch: int, C: int, lead_shapes, chunk: int, kernel,
                       R: int, beta: float, heuristic_mode: str,
                       allow_pallas: bool = True, *, device="cpu",
                       dtype=torch.float32, comm=None) -> str:
    """The per-shard mode of a halo fit (:mod:`..parallel.halo`) whose rank
    holds ``n_batch`` batches of ``chunk`` trailing frames, leading extents
    ``lead_shapes``, ``C`` channels, the kernel extents ``kernel`` and rank
    ``R``, on ``device``; ``heuristic_mode`` is
    :func:`..parallel.halo._halo_unfold_mode`'s.  The rules:

    * float64 → ``"conv"`` (the generic path); ``PNT_NMFD_PALLAS=1`` →
      ``"fused"``;
    * a CUDA float32 fit (the kernel path, unless ``PNT_NMFD_PALLAS=0``):
      ``"fused"``, timed against ``"fused_w"`` above the threshold (the
      proxy's MACs, :func:`_tuned`; ``PNT_NMFD_AUTOTUNE`` forces either
      way).  The library modes are never chosen there.
      ``allow_pallas=False`` (the EM fits, the JAX package's name: its EM
      has no fused mode) keeps ``"fused"`` untimed, the port's EM having no
      ``"fused_w"``;
    * elsewhere (the CPU, or ``PNT_NMFD_PALLAS=0``) the heuristic, and
      where it says ``"unrolled"``, above the threshold, ``"unrolled"``
      timed against ``"conv"``.

    A challenger must beat the static choice (the first) by ``_MARGIN``.
    The candidates are timed on rank 0's local problem (random data from
    seed 0), through the real per-shard step without collectives: those
    are the same in every mode (the JAX package's argument), and two ranks
    sharing a card would disturb each other's CUDA events.  So only rank 0
    of ``comm`` (a :class:`~..parallel.comm.Comm`) resolves and times; the
    others wait for its choice, which ``comm`` broadcasts: a rank running
    another mode would deadlock the group on mismatched collectives.  The
    winner is cached under :func:`_halo_key`.  A candidate that raises
    propagates."""
    mode = None
    if comm is None or comm.rank == 0:
        mode = _halo_mode(n_batch, C, tuple(int(s) for s in lead_shapes),
                          int(chunk), tuple(int(k) for k in kernel), int(R),
                          float(beta), heuristic_mode, allow_pallas, device,
                          dtype)
    return mode if comm is None else comm.broadcast_object(mode)

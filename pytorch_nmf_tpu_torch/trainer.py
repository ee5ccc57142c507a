r"""Optimizers for composed non-negative models (counterpart of
:mod:`pytorch_nmf_tpu.trainer`; reference torchnmf/trainer.py).

* :class:`BetaMu` — the coordinate-wise multiplicative updater minimizing the
  β-divergence of any composed model, for example a ``torch.nn.Sequential``
  of the port's ``NMF`` modules: each module's ``forward(H=None)`` takes the
  previous module's output as its ``H``.
* :class:`SparsityProj` — Hoyer sparseness-constrained projected gradient
  with a backtracking line search over a parameter group.

Both are ``torch.optim.Optimizer``\ s over ``nn.Parameter``\ s with
``step(closure)`` and param groups; the closure is evaluated again for each
parameter (``BetaMu``) or line-search attempt (``SparsityProj``).

With ``jit_compile=True`` (the default) the steps are compiled, as the JAX
package's are.  The first step with a closure builds its sweep once: one
eager probe decides which parameters the closure depends on, then the whole
coordinate-wise ``BetaMu`` sweep, or ``SparsityProj``'s whole step (per
group: the closure and its gradient, the first attempt, attempts
2..``max_iter`` in a device loop, the undo after a full failure and the
step size's growth), becomes a function that updates the parameters in
place.  On a CUDA device each is captured once into a ``torch.cuda.CUDAGraph``
and replayed: ``BetaMu.step`` is one replay, ``BetaMu.run(closure, n)`` is
``n`` replays with no host read until it returns; ``SparsityProj.step`` is
one replay, its line search a CUDA-graph WHILE node, and one host read (the
step sizes, carried on the card as float32 and published in
``group["lr"]``), ``run(closure, n)`` ``n`` replays and one read.  On the
CPU the same functions are called directly.  Entries are cached per closure (its code and
the identity and storage of everything it captures), per parameter set and
per hyper-parameters, at most :data:`_STEP_CACHE_MAX` of them; each owns
its graphs' private memory pools, which eviction releases.
``jit_compile=False``, or a closure that is not a plain function (a
``functools.partial``, a callable object), runs the eager step.  A closure
that reads the card's values on the host cannot be captured and raises.
"""

from collections import OrderedDict
from typing import Callable

import numpy as np
import torch

from .ops.graphs import _device_while, _Graphs
from .ops.mu import gamma_from_beta, get_norm
from .ops.projection import hoyer_l1_target, proj_columns
from .ops.trainer_core import mu_apply, mu_raw_pair, proj_line_search

__all__ = ["BetaMu", "SparsityProj"]

# compiled-step cache: a bounded LRU, so that an optimizer stepped with many
# distinct closures does not pin unbounded captured data and graph pools
_STEP_CACHE_MAX = 8

_NOT_CAPTURABLE = (
    "the closure cannot be captured in a CUDA graph: it reads the card's "
    "values on the host (.item(), float(), bool() of a tensor, a copy from "
    "or to host memory) or does something else a graph cannot hold; "
    "construct the optimizer with jit_compile=False to run it eagerly")


def _run(step: Callable, closure: Callable, steps: int):
    """``steps`` calls of ``step(closure)``; the last one's result, ``None``
    for zero steps."""
    steps = _steps(steps)
    out = None
    for _ in range(steps):
        out = step(closure)
    return out


def _steps(steps) -> int:
    steps = int(steps)
    if steps < 0:
        raise ValueError(f"Invalid steps value: {steps}")
    return steps


def _storage(t: torch.Tensor):
    """Where a graph reads ``t``: its address, shape, strides, dtype and
    device."""
    return (t.data_ptr(), tuple(t.shape), t.stride(), t.dtype, str(t.device))


def _closure_fingerprint(closure, optimized_params=()):
    """Identity key for a user closure: its code object plus the ids of
    everything it captures — cells, referenced globals and default
    arguments; for a bound method its instance and the instance's
    attributes — and the storage (:func:`_storage`) of every captured
    tensor, of every parameter and buffer of a captured module, and of the
    optimized parameters.  A captured graph reads each of those at its
    address, so ``model.W.data = new`` or rebinding the captured target
    misses the cache, as it retraces in the JAX package.

    Two lambdas created on the same source line capturing the same objects
    compare equal, so ``for _ in range(n): trainer.step(lambda: (V,
    model()))`` hits the cache.  Returns ``(key, refs)``, ``refs`` to be
    kept alive with the cache entry (each id stays pinned), or ``None`` when
    the callable is not introspectable (the eager step runs).

    Unlike the JAX package, which bakes captured arrays in as constants
    (its documented limit), a graph reads captured tensors when it is
    replayed: a tensor written in place between steps (``V.copy_(new)``)
    keeps its key, and the next step sees its new values.
    """
    code = getattr(closure, "__code__", None)
    if code is None:
        return None
    refs = []
    for c in closure.__closure__ or ():
        try:
            v = c.cell_contents
        except ValueError:  # empty cell (e.g. self-referential def)
            continue
        if v is not closure:
            refs.append(v)
    refs.extend(getattr(closure, "__defaults__", None) or ())
    globs = getattr(closure, "__globals__", {})
    refs.extend(globs[n] for n in code.co_names if n in globs)
    self_obj = getattr(closure, "__self__", None)
    if self_obj is not None:
        refs.append(self_obj)
        refs.extend(getattr(self_obj, "__dict__", {}).values())
    storage = []
    for r in refs:
        if isinstance(r, torch.Tensor):
            storage.append(_storage(r))
        elif isinstance(r, torch.nn.Module):
            storage.extend(_storage(t) for t in r.parameters())
            storage.extend(_storage(t) for t in r.buffers())
    storage.extend(_storage(p) for p in optimized_params)
    key = (code,) + tuple(id(r) for r in refs) + tuple(storage)
    return key, refs


def _cache_get(cache, key):
    entry = cache.get(key)
    if entry is not None:
        cache.move_to_end(key)
    return entry


def _cache_put(cache, key, entry):
    cache[key] = entry
    cache.move_to_end(key)
    while len(cache) > _STEP_CACHE_MAX:
        cache.popitem(last=False)


def _device_of(params) -> torch.device:
    devices = {p.device for p in params}
    if len(devices) != 1:
        raise ValueError(f"a compiled step takes parameters on one device, "
                         f"got {sorted(map(str, devices))}")
    return devices.pop()


def _dependence_mask(output: Callable, params):
    """``(mask, out)``: whether ``output()`` depends on each parameter that
    requires grad, from one eager evaluation and ``torch.autograd.grad(...,
    allow_unused=True)`` (the JAX package walks the jaxpr,
    pytorch_nmf_tpu/trainer.py:65-92), and the output, detached."""
    live = [p for p in params if p.requires_grad]
    with torch.enable_grad():
        out = output()
        if live and isinstance(out, torch.Tensor) and out.requires_grad:
            grads = torch.autograd.grad(out.sum(), live, allow_unused=True)
        else:
            grads = [None] * len(live)
    connected = {id(p) for p, g in zip(live, grads) if g is not None}
    return [id(p) in connected for p in params], torch.as_tensor(out).detach()


class BetaMu(torch.optim.Optimizer):
    r"""Multiplicative updater minimizing the β-divergence of a composed
    non-negative model (reference trainer.py:7-121).

    Args:
        params: parameters or param-group dicts.
        beta: the β-divergence to minimize. Default 1.
        l1_reg / l2_reg / orthogonal: penalties added to the MU denominator
            (reference trainer.py:100-106).
        jit_compile: compile the sweep (module docstring). Default True.

    ``step(closure)`` takes ``closure() -> (target, predict)``.  It is
    evaluated once per parameter, the others at their current values; a
    parameter the prediction does not depend on is skipped and its ``.grad``
    left alone.  Every updated parameter's ``.grad`` is the true
    β-divergence gradient at its value before the update, a tensor of the
    caller's own.  Parameters are updated in place.
    """

    def __init__(self, params, beta=1, l1_reg=0, l2_reg=0, orthogonal=0,
                 jit_compile=True):
        if not 0.0 <= l1_reg:
            raise ValueError(f"Invalid l1_reg value: {l1_reg}")
        if not 0.0 <= l2_reg:
            raise ValueError(f"Invalid l2_reg value: {l2_reg}")
        if not 0.0 <= orthogonal:
            raise ValueError(f"Invalid orthogonal value: {orthogonal}")
        super().__init__(params, dict(beta=beta, l1_reg=l1_reg, l2_reg=l2_reg,
                                      orthogonal=orthogonal))
        self.jit_compile = bool(jit_compile)
        self._step_cache = OrderedDict()

    # -- compiled path -------------------------------------------------------
    def _params_and_hypers(self):
        params, hypers = [], []
        for group in self.param_groups:
            for p in group["params"]:
                params.append(p)
                hypers.append((group["beta"], group["l1_reg"], group["l2_reg"],
                               group["orthogonal"]))
        return params, hypers

    def _compiled(self, closure):
        """The cache entry for ``closure``, built on a miss; ``None`` when
        the step runs eagerly."""
        params, hypers = self._params_and_hypers()
        fp = _closure_fingerprint(closure, params) if self.jit_compile else None
        if fp is None:
            return None
        key = fp[0] + (tuple(id(p) for p in params),
                       tuple(p.requires_grad for p in params), tuple(hypers))
        entry = _cache_get(self._step_cache, key)
        if entry is None:
            entry = self._build_sweep(closure, params, hypers)
            entry["refs"] = fp[1]  # pins the captured objects' ids
            _cache_put(self._step_cache, key, entry)
        return entry

    @staticmethod
    def _build_sweep(closure, params, hypers):
        """The whole coordinate-wise sweep as one in-place workload: for
        each parameter the prediction depends on, the closure, the
        cotangent pair's gradients (:func:`mu_raw_pair`), the update
        (:func:`mu_apply`) into the parameter and its gradient into a
        static buffer."""
        device = _device_of(params)
        mask, _ = _dependence_mask(lambda: closure()[1], params)
        live = [(p, h) for p, h, m in zip(params, hypers, mask) if m]
        grads = [torch.zeros_like(p) for p, _ in live]

        def sweep():
            for (p, (beta, l1_reg, l2_reg, ortho)), grad in zip(live, grads):
                with torch.enable_grad():
                    V, WH = closure()
                    raw = mu_raw_pair(WH, p, V, beta)
                if raw is None:
                    continue
                with torch.no_grad():
                    new, g = mu_apply(p.detach(), *raw, gamma_from_beta(beta),
                                      l1_reg, l2_reg, ortho)
                    p.copy_(new)
                    grad.copy_(g)

        return {"graphs": _Graphs([sweep], [p for p, _ in live], device,
                                  _NOT_CAPTURABLE),
                "params": [p for p, _ in live], "grads": grads}

    @staticmethod
    def _publish_grads(entry):
        for p, g in zip(entry["params"], entry["grads"]):
            p.grad = g.clone()

    def step(self, closure: Callable):
        """One coordinate-wise MU pass over every parameter."""
        entry = self._compiled(closure)
        if entry is None:
            return self._step_eager(closure)
        entry["graphs"]()
        self._publish_grads(entry)
        return None

    def run(self, closure: Callable, steps: int):
        """``steps`` calls of :meth:`step` (compiled: ``steps`` replays of
        the sweep, ``.grad`` the last sweep's); returns ``None``."""
        steps = _steps(steps)
        entry = self._compiled(closure) if steps else None
        if entry is None:
            _run(self._step_eager, closure, steps)
            return None
        for _ in range(steps):
            entry["graphs"]()
        self._publish_grads(entry)
        return None

    def _step_eager(self, closure: Callable):
        for group in self.param_groups:
            gamma = gamma_from_beta(group["beta"])
            for p in group["params"]:
                if not p.requires_grad:
                    continue
                with torch.enable_grad():
                    V, WH = closure()
                    raw = mu_raw_pair(WH, p, V, group["beta"])
                if raw is None:
                    continue
                with torch.no_grad():
                    new, p.grad = mu_apply(p.detach(), *raw, gamma,
                                           group["l1_reg"], group["l2_reg"],
                                           group["orthogonal"])
                    p.copy_(new)
        return None


def _read_lrs(lrs: torch.Tensor) -> list:
    """The compiled ``SparsityProj``'s one host read a step (or a ``run``):
    every group's step size, counted in ``_read_lrs.reads``."""
    _read_lrs.reads += 1
    return lrs.tolist()


_read_lrs.reads = 0


def _line_search(closure, st):
    """One group's compiled step (:meth:`SparsityProj._build`), in place on
    its parameters, gradient buffers, step size and loss.  Eagerly (the
    CPU, the warm-ups) each test of the loop's flag is a host read,
    counted in ``_line_search.reads``; a replay reads nothing."""
    live, grads, lr = st["live"], st["grads"], st["lr"]
    dim, max_iter = st["dim"], st["max_iter"]
    L1s = [hoyer_l1_target(p.numel() // p.shape[dim], st["sparsity"])
           for p in live]

    def attempt():
        for p, g, L1 in zip(live, grads, L1s):
            p.copy_(proj_columns(p - lr * g, L1, axis=dim,
                                 norms=get_norm(p, dim)))
        st["loss"].copy_(closure())
        torch.gt(st["loss"], init_loss, out=worse)

    def retry():
        for p, g in zip(live, grads):
            p.add_(lr * g)
        lr.mul_(0.5)
        attempt()
        tries.add_(1)
        torch.logical_and(worse, tries < max_iter, out=again)

    with torch.enable_grad():
        init_loss = closure()
        gs = torch.autograd.grad(init_loss, live, allow_unused=True)
    with torch.no_grad():
        for buf, g in zip(grads, gs):
            buf.zero_() if g is None else buf.copy_(g)
        init_loss = init_loss.detach()
        worse = torch.empty((), dtype=torch.bool, device=lr.device)
        attempt()
        tries = torch.ones((), dtype=torch.int32, device=lr.device)
        again = torch.logical_and(worse, tries < max_iter)
        _line_search.reads += _device_while(again, retry)
        # every attempt failed: the last one is undone too
        for p, g in zip(live, grads):
            p.copy_(torch.where(worse, p + lr * g, p))
        lr.copy_(torch.where(worse, lr * 0.5, lr) * 1.2)


_line_search.reads = 0


class SparsityProj(torch.optim.Optimizer):
    r"""Hoyer sparseness-constrained projected gradient (reference
    trainer.py:124-190).

    Args:
        params: parameters to constrain, or param-group dicts.
        sparsity: target Hoyer sparseness in (0, 1).
        dim: the axis indexing the rank columns. Default 1.
        max_iter: closure evaluations per step (the backtracking budget).
        jit_compile: compile the line search (module docstring). Default
            True; its step size is then carried in float32, as the JAX
            package's compiled step carries it.

    ``step(closure)`` takes ``closure() -> loss`` and returns the loss of
    the last attempt.  The step size ``group["lr"]`` (1 at first) carries
    across steps (compiled: on the card, taken from ``group["lr"]`` again
    when the caller has changed it).  A parameter the loss does not depend
    on is left alone.
    """

    def __init__(self, params, sparsity, dim=1, max_iter=10, jit_compile=True,
                 _graph=True):
        if not 0.0 < sparsity < 1.0:
            raise ValueError(f"Invalid sparsity value: {sparsity}")
        super().__init__(params, dict(sparsity=sparsity, lr=1, dim=dim,
                                      max_iter=max_iter))
        self.jit_compile = bool(jit_compile)
        # private: False calls the compiled step's workload directly on the
        # card too, the eager reference of the card's checks
        self._graph = bool(_graph)
        self._step_cache = OrderedDict()

    # -- compiled path -------------------------------------------------------
    def _compiled(self, closure):
        params = [p for g in self.param_groups for p in g["params"]]
        fp = _closure_fingerprint(closure, params) if self.jit_compile else None
        if fp is None:
            return None
        key = fp[0] + (tuple(id(p) for p in params),
                       tuple(p.requires_grad for p in params),
                       tuple((g["sparsity"], g["dim"], g["max_iter"])
                             for g in self.param_groups))
        entry = _cache_get(self._step_cache, key)
        if entry is None:
            entry = self._build(closure, params)
            entry["refs"] = fp[1]
            _cache_put(self._step_cache, key, entry)
        return entry

    def _build(self, closure, params):
        """The whole step as one in-place workload with device loops: for
        each group with a live parameter in turn, the closure and its
        gradients into static buffers, the first attempt, attempts
        2..``max_iter`` in a :func:`~.ops.graphs._device_while` loop on
        "worse, and fewer than ``max_iter`` attempts" (each: undo onto the
        projected value, halve, project at the undone value's norms,
        evaluate), after a full failure the last attempt undone and the
        step halved once more, and the step grown by 1.2 (JAX
        ``ops/trainer_core.py:104-170``).  The step sizes are a float32
        tensor on the device, one entry a group, carried across steps."""
        device = _device_of(params)
        mask, out = _dependence_mask(closure, params)
        live_of = {id(p) for p, m in zip(params, mask) if m}
        lrs = torch.tensor([float(np.float32(g["lr"])) for g in self.param_groups],
                           dtype=torch.float32, device=device)
        groups, state = [], [lrs]
        for i, group in enumerate(self.param_groups):
            live = [p for p in group["params"] if id(p) in live_of]
            if not live:
                groups.append(None)
                continue
            groups.append({
                "live": live, "grads": [torch.zeros_like(p) for p in live],
                "lr": lrs[i], "loss": torch.empty_like(out),
                "sparsity": group["sparsity"], "dim": group["dim"],
                "max_iter": group["max_iter"]})
            state += live
        sts = [st for st in groups if st is not None]

        def sweep():
            for st in sts:
                _line_search(closure, st)

        if self._graph:
            graphs = _Graphs([sweep], state if sts else [], device,
                             _NOT_CAPTURABLE, conditional=True)
        else:
            def graphs():
                sweep()
        return {"graphs": graphs,
                "groups": groups, "lrs": lrs,
                "published": [None] * len(groups)}

    def _replays(self, closure, steps: int):
        """``steps`` replays of the compiled step, the step sizes read once
        after them; ``None`` when the step runs eagerly."""
        entry = self._compiled(closure)
        if entry is None:
            return None
        lrs, published = entry["lrs"], entry["published"]
        for i, (group, st) in enumerate(zip(self.param_groups, entry["groups"])):
            if st is not None and group["lr"] != published[i]:
                lrs[i].fill_(float(np.float32(group["lr"])))
        for _ in range(steps):
            entry["graphs"]()
        loss = None
        if any(st is not None for st in entry["groups"]):
            published[:] = _read_lrs(lrs)
        for i, (group, st) in enumerate(zip(self.param_groups, entry["groups"])):
            if st is None:
                with torch.no_grad():
                    loss = torch.as_tensor(closure()).detach()
                continue
            group["lr"] = published[i]
            for p, g in zip(st["live"], st["grads"]):
                p.grad = g.clone()
            loss = st["loss"].clone()
        return (loss,)

    def step(self, closure: Callable):
        """One projected-gradient step with backtracking line search
        (compiled: one replay, and one host read for the step sizes)."""
        out = self._replays(closure, 1)
        return self._step_eager(closure) if out is None else out[0]

    def run(self, closure: Callable, steps: int):
        """``steps`` calls of :meth:`step` (compiled: ``steps`` replays and
        one host read at the end; ``.grad`` the last step's); returns the
        last step's loss (``None`` for zero steps)."""
        steps = _steps(steps)
        out = self._replays(closure, steps) if steps else (None,)
        return _run(self._step_eager, closure, steps) if out is None else out[0]

    def _step_eager(self, closure: Callable):
        loss = None
        for group in self.param_groups:
            params = [p for p in group["params"] if p.requires_grad]
            with torch.enable_grad():
                init_loss = closure()
                grads = (torch.autograd.grad(init_loss, params,
                                             allow_unused=True)
                         if params and init_loss.requires_grad
                         else [None] * len(params))
            live = [(p, g) for p, g in zip(params, grads) if g is not None]
            if not live:
                loss = init_loss.detach()
                continue
            for p, g in live:
                p.grad = g

            def evaluate(values):
                for (p, _), v in zip(live, values):
                    p.copy_(v)
                return closure()

            with torch.no_grad():
                new, lr, loss = proj_line_search(
                    [p.detach().clone() for p, _ in live],
                    [g for _, g in live], group["lr"], group["sparsity"],
                    group["dim"], group["max_iter"], init_loss.detach(),
                    evaluate)
                for (p, _), v in zip(live, new):
                    p.copy_(v)
            group["lr"] = lr * 1.2
        return loss

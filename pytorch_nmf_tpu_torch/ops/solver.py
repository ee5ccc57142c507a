r"""Training loops (counterpart of :mod:`pytorch_nmf_tpu.ops.solver`): the
dense and sparse-target β-divergence MU fits, the Hoyer sparseness-
constrained fit and the PLCA EM fit, and batched forms of the dense, Hoyer
and EM fits (a leading batch axis of independent problems).

The semantics are those of the reference ``BaseComponent.fit``
(``torchnmf/nmf.py:355-409``) as the JAX package compiles them:

* the loss is checked every 10 iterations, with the stop rule
  ``(prev - loss) / loss_init < tol``;
* ``n_iter = 10·k`` when the check of chunk ``k`` converged, else
  ``max_iter``; the ``max_iter % 10`` remainder iterations are skipped once
  converged;
* W updates against the old H, then H against the new W.

The eager loop (:func:`_converging_loop`) is a Python loop over
10-iteration chunks; the host reads the device once a chunk, for the stop
rule (``_read.reads`` counts the loops' reads).  The single-card dense,
sparse and EM fits (:func:`get_dense_fit`, :func:`get_sparse_fit`,
:func:`get_plca_fit`) run their whole chunk loop as one in-place workload
(:class:`~.graphs._Graphs`), as JAX's ``lax.while_loop``: a device loop
(:func:`~.graphs._device_while`) whose body is the chunk (ten iterations,
the loss, the stop test, the new state copied into static tensors, the
chunk count plus one) and whose flag is ``~stop & (k < limit)``, decided
on the device.  On a CUDA device the first fit of a configuration runs
chunks 1-2 eagerly, the second with synchronizing operations raising,
captures the loop (its body a CUDA-graph WHILE node) and replays it once
for the rest; a later fit is one replay and one host read (``(k, stop)``,
for ``n_iter``).  On the CPU the same workload runs eagerly, reading the
flag before each chunk.  A chunk that cannot be captured raises.  The
batched MU and EM fits (:func:`get_batched_dense_fit`,
:func:`get_batched_plca_fit`) run theirs the same way
(:func:`_graphed_batched_loop`, ``~done & (k < limit)``), every problem's
stop test and chunk of convergence on the device, nothing read on the
host after a replay.  The Hoyer fit (:func:`get_hoyer_fit`,
dense or sparse target) runs its chunk loop the same way
(:func:`_graphed_hoyer_loop`) with a stop flag that never rises, its line
search's attempts 2-10 device loops nested in the chunk's body (on the
card WHILE nodes inside the loop's WHILE node): a warm fit is one replay
and no host read; so does the batched Hoyer fit
(:func:`get_batched_hoyer_fit`), one batched program whose problems' line
searches share one loop.  The sharded NMF, PLCA and sparse fits and the
halo fits of :mod:`..parallel` run :func:`_graphed_loop` on this cache too
(over NCCL the collectives inside the captured body; the ranks agree on
the loop's path first, :func:`_agree_path`).

**The compiled fits are kept** (the JAX package's ``lru_cache``'d
factories and ``jax.jit``'s programs per input signature): the factories
are cached on their arguments (``cache_clear``/``cache_info`` on each), and
one cache keeps, per target and chunk configuration, an entry
(:class:`_Entry`) holding the chunk's graphs, every static tensor the chunk
reads and what the fit derives from the target.  The chunk configuration
is what the chunk reads: the factory's arguments but ``max_iter`` (and
``verbose`` where the chunk does not report), so fits that differ only in
those share one entry (each fit loads its chunk limit into the loop).  A
graph reads fixed addresses, so the key holds the target's identity (a
weak reference, its address and its version counter: a target changed in
place misses) beside the shapes, strides, dtypes and device of every
argument and the ``PNT_*`` environment switches.  A hit copies the inputs into the statics and replays the
loop once; a configuration seen before with a new target captures before
chunk 1 and replays once.  An entry goes when its target is
collected, past :data:`_MAX_ENTRIES` entries or past :data:`_HELD_SHARE`
of a card's memory held (least recently used first), when a process
group whose collectives its chunk runs is destroyed (a sharded fit's,
:meth:`_Cache.drop_groups`), and at :func:`compiled_cache_clear`.  A fit
out of card memory drops every idle
entry and, when one was kept from an earlier fit, runs once more before
the error propagates (:meth:`_Cache.run`).  :func:`compiled_cache_info`
counts hits and misses and the bytes held.
"""

import collections
import contextlib
import functools
import gc
import os
import threading
import types
import weakref
from types import SimpleNamespace
from typing import Callable, Optional

import numpy as np
import torch

from ..constants import eps
from ..metrics import beta_div, kl_div
from . import sparse as _sparse
from .graphs import _Counted, _device_while, _Graphs
from .mu import (gamma_from_beta, kl_pos_H, kl_pos_W, mu_multiplier, mu_update,
                 renorm)
from .projection import (hoyer_l1_target, proj_columns, proj_columns_explicit,
                         proj_problem_columns)
from .recon import matmul

__all__ = ["get_dense_fit", "get_batched_dense_fit", "get_sparse_fit",
           "get_hoyer_fit", "get_batched_hoyer_fit", "get_plca_fit",
           "get_batched_plca_fit", "alpha_is_active", "push_progress_handler",
           "pop_progress_handler", "compiled_cache_info",
           "compiled_cache_clear"]


def _default_updaters(recon2, beta, gamma, l1_reg, l2_reg, pos_W=kl_pos_W,
                      pos_H=kl_pos_H):
    """Per-factor updaters on the generic autograd MU engine; ``pos_W`` and
    ``pos_H`` are the analytic β=1 denominators (batched ones for a batched
    ``recon2``)."""
    def upd_W(V, W, H):
        pos_pre = pos_W(H) if beta == 1 else None
        return mu_update(
            lambda w: recon2(H, w), V, W, beta, gamma, l1_reg, l2_reg, pos_pre
        )

    def upd_H(V, W, H):
        pos_pre = pos_H(W) if beta == 1 else None
        return mu_update(
            lambda h: recon2(h, W), V, H, beta, gamma, l1_reg, l2_reg, pos_pre
        )

    return upd_W, upd_H


def _normalize_updaters(updaters):
    """Factory return values come in three arities:

    * ``(upd_W, upd_H)``
    * ``(upd_W, upd_H, loss_terms)``
    * ``(upd_W, upd_H, loss_terms, prepare, finish)`` — ``prepare(V, W, H)
      -> (w_state, h_state)`` converts the factors into the updaters'
      preferred layout once at fit entry, ``finish(V, w_state, h_state) ->
      (W, H)`` converts back at exit.

    Any other arity is rejected: a prepare without its inverse would leak
    the internal layout to the caller.
    """
    if len(updaters) not in (2, 3, 5):
        raise ValueError(
            f"updater factory returned {len(updaters)} elements; expected "
            "(upd_W, upd_H[, loss_terms[, prepare, finish]])"
        )
    return (tuple(updaters) + (None,) * 5)[:5]


# --------------------------------------------------------------------------
# Progress reporting: a verbose fit reports ``(chunk_index, loss, extra)``
# once per 10-iteration chunk to its own tqdm bar (or a printed line) and to
# every handler on a process-global stack, so a user's recorder
# (``utils.LossHistory``) coexists with the fit's bar.  The stack is guarded
# by a lock: a handler may be pushed or popped from another thread while a
# fit reports.
# --------------------------------------------------------------------------
_PROGRESS_HANDLERS = []
_PROGRESS_LOCK = threading.Lock()


def push_progress_handler(fn) -> None:
    """Register ``fn(chunk_idx, loss, extra)`` for every verbose fit's
    reports until :func:`pop_progress_handler`."""
    with _PROGRESS_LOCK:
        _PROGRESS_HANDLERS.append(fn)


def pop_progress_handler() -> None:
    """Remove the handler pushed last (no-op on an empty stack)."""
    with _PROGRESS_LOCK:
        if _PROGRESS_HANDLERS:
            _PROGRESS_HANDLERS.pop()


def _emit_progress(chunk_idx, loss, extra=None):
    with _PROGRESS_LOCK:  # a snapshot: a handler may pop itself
        handlers = list(_PROGRESS_HANDLERS)
    for handler in handlers:
        handler(int(chunk_idx), float(loss),
                None if extra is None else float(extra))


@contextlib.contextmanager
def _progress(verbose: bool, max_iter: int):
    """Yields ``report(chunk_idx, loss, extra=None)`` (or ``None``): a tqdm
    bar when tqdm is installed, else one printed line per 10-iteration
    chunk, and every registered progress handler.  ``extra`` is PLCA's
    log-probability."""
    if not verbose:
        yield None
        return
    try:
        from tqdm import tqdm
    except ImportError:
        def report(k, loss, extra=None):
            tail = "" if extra is None else f", log_prob={extra:.6g}"
            print(f"iter {k * 10}: loss={loss:.6g}{tail}")
            _emit_progress(k, loss, extra)

        yield report
        return
    with tqdm(total=max_iter) as bar:
        def report(k, loss, extra=None):
            if extra is None:
                bar.set_postfix(loss=loss)
            else:
                bar.set_postfix(loss=loss, log_prob=extra)
            bar.n = min(k * 10, max_iter)
            bar.refresh()
            _emit_progress(k, loss, extra)

        yield report


def _read(x, cast=float):
    """A host read of the device value ``x``, counted in ``_read.reads``:
    the chunked loops' only reads (the stop flag, and when verbose the
    reported values)."""
    _read.reads += 1
    return cast(x)


_read.reads = 0


# --------------------------------------------------------------------------
# The fits' cache: one LRU of entries, keyed by what the chunk reads (the
# fit's configuration) and the target's identity (module docstring)
# --------------------------------------------------------------------------
_MAX_ENTRIES = 8  # the entries kept in all, as the trainers' step cache
_HELD_SHARE = 0.25  # of a card's memory: the most its entries hold
_COUNTS = SimpleNamespace(hits=0, warm_misses=0, cold_misses=0)
_FITTING = threading.local()  # the fits running in this thread


def _held_budget(device: torch.device):
    """The bytes the entries on ``device`` may hold between fits: a share
    of the card's memory (``None`` on the CPU, where only the entries are
    counted)."""
    if device.type != "cuda":
        return None
    return int(_HELD_SHARE
               * torch.cuda.get_device_properties(device).total_memory)


def _gives_back(device: torch.device) -> bool:
    """Whether dropping entries on ``device`` gives back the memory a fit
    there ran out of: a card's (the CPU's entries are host memory)."""
    return device.type == "cuda"


def _device(args) -> torch.device:
    """The device of a fit's arguments (its first tensor's)."""
    return next(a.device for a in args if isinstance(a, torch.Tensor))


def _env_switches():
    """The ``PNT_*`` environment switches: every one a fit reads (the
    sparse tiers', the deconv engines', the fused PLCA E-step's) is in
    the key."""
    return tuple(sorted((k, v) for k, v in os.environ.items()
                        if k.startswith("PNT_")))


def _ell_arrays(ell):
    return (ell.row_idx, ell.row_val, ell.col_idx, ell.col_val) + tuple(
        ell.row_rem) + tuple(ell.col_rem)


def _sig(x):
    """The configuration part of an argument's key: a tensor's shape,
    strides, dtype, device and 16-byte alignment (a sparse one's size,
    non-zeros and coalescing); a SparseELL's arrays'; any other value
    itself."""
    if isinstance(x, _sparse.SparseELL):
        return ("ell", _sig(x.coo)) + tuple(_sig(t) for t in _ell_arrays(x))
    if isinstance(x, torch.Tensor):
        if x.layout == torch.sparse_coo:
            return ("coo", tuple(x.shape), x.dtype, x.device, x._nnz(),
                    x.is_coalesced())
        return (tuple(x.shape), x.stride(), x.dtype, x.device,
                x.data_ptr() % 16)
    return (type(x), x)


def _identity(x):
    """``(objects held weakly, tensors held, key part)`` of a target: a
    tensor by its identity, address and version counter (a sparse one's
    values and indices too); a SparseELL by its target's and the identity
    of its arrays, which the entry holds."""
    if isinstance(x, _sparse.SparseELL):
        weak, held, key = _identity(x.coo)
        arrays = _ell_arrays(x)
        return weak, held + list(arrays), key + tuple(id(t) for t in arrays)
    if x.layout == torch.sparse_coo:
        vals, idx = x._values(), x._indices()
        return [x], [], (id(x), x._version, vals.data_ptr(), vals._version,
                         idx.data_ptr(), idx._version)
    return [x], [], (id(x), x.data_ptr(), x._version)


def _forget(key):
    """A target was collected: its entry goes now, or when the fits
    running in this thread end."""
    with _CACHE.lock:
        _CACHE.dead.append(key)
    if not getattr(_FITTING, "depth", 0):
        _CACHE.purge()


class _Entry:
    """One compiled fit: a chunk configuration on one target.  ``fns``
    (the fit's closures, made once an entry), ``loop`` (the loop's static
    tensors and its :class:`~.graphs._Graphs`) and ``derived`` (what the
    fit computes from the target, kept so the graph's addresses stay
    valid, and recomputed into the same tensors at every fit) live as long
    as the entry; ``V`` is the target only while a fit
    runs (the entry holds it weakly).  ``groups``: the process groups
    whose collectives the chunk runs (a sharded fit's), whose destruction
    drops the entry (:meth:`_Cache.drop_groups`).  ``warm``: the configuration was
    compiled before in this process, so the first fit captures before
    chunk 1.  ``hit``: the entry was kept from an earlier fit.  ``lock`` is
    held by the fit that runs the entry."""

    def __init__(self, key=None, config=None, weak=(), held=(), device=None):
        self.key, self.config, self.device = key, config, device
        self.refs = [weakref.ref(o) for o in weak]
        self.held = list(held)
        self.V = self.fns = self.loop = None
        self.derived = {}
        self.groups = set()
        self.warm = self.hit = False
        self.lock = threading.Lock()
        self.finalizers = [] if key is None else [
            weakref.finalize(o, _forget, key) for o in weak]
        for f in self.finalizers:  # nothing to free at the interpreter's exit
            f.atexit = False

    def matches(self, weak, held) -> bool:
        return (all(r() is o for r, o in zip(self.refs, weak))
                and all(a is b for a, b in zip(self.held, held)))

    def ready(self) -> bool:
        """Whether the chunk has been warmed up (and on the card captured)."""
        graphs = getattr(self.loop, "graphs", None)
        return graphs is not None and graphs.ready()

    def start(self, graphs):
        """A fit of the entry begins its chunks: on a configuration seen
        before, the chunk is captured now."""
        if self.warm and not graphs.ready():
            graphs.capture(seen=True)

    def tensors(self):
        """The tensors the entry keeps: the loop's statics, the derived
        ones and those its closures hold (an updater's padded copy of V),
        each once.  (A loop, not a recursive closure: a closure that refers
        to itself is a reference cycle, which would hold the tensors until
        the next garbage collection.)"""
        out, seen, todo = [], set(), [self.loop, self.derived, self.fns]
        while todo:
            x = todo.pop()
            if id(x) in seen:
                continue
            seen.add(id(x))
            if isinstance(x, torch.Tensor):
                out.append(x)
            elif isinstance(x, (tuple, list)):
                todo.extend(x)
            elif isinstance(x, dict):
                todo.extend(x.values())
            elif isinstance(x, SimpleNamespace):
                todo.extend(vars(x).values())
            elif isinstance(x, functools.partial):
                todo.extend((x.func, x.args, x.keywords))
            elif isinstance(x, types.FunctionType) and x.__closure__:
                for cell in x.__closure__:
                    with contextlib.suppress(ValueError):  # an empty cell
                        todo.append(cell.cell_contents)
        return out

    def nbytes(self) -> int:
        """Card or host bytes the entry holds between fits: its tensors'
        storages (each once; the target's own, which it does not hold, left
        out) and what its graphs' captures reserved."""
        target = {r().untyped_storage().data_ptr() for r in self.refs
                  if r() is not None and r().layout == torch.strided}
        seen, total = set(target), 0
        for t in self.tensors():
            st = t.untyped_storage()
            if st.data_ptr() not in seen:
                seen.add(st.data_ptr())
                total += st.nbytes()
        graphs = getattr(self.loop, "graphs", None)
        return total + (graphs.pool_bytes if graphs is not None else 0)

    def close(self):
        """Frees the graphs and the kept tensors, now (the closures refer
        back to the entry)."""
        for f in self.finalizers:
            f.detach()
        graphs = getattr(self.loop, "graphs", None)
        if graphs is not None:
            graphs.close()
            graphs.fns = []
        self.loop = self.fns = self.V = None
        self.derived, self.held = {}, []


class _Cache:
    """The fits' entries, least recently used first, and the
    configurations compiled (``seen``), guarded by ``lock``.  An entry
    taken out while a fit runs it (cleared, evicted, its target changed)
    is closed when that fit ends."""

    def __init__(self):
        self.entries = collections.OrderedDict()
        self.seen = set()
        self.dead = []
        self.lock = threading.RLock()

    def _take(self, keys):
        """Takes ``keys``' entries out (``lock`` held); returns the idle
        ones, for the caller to close once it lets the lock go."""
        idle = []
        for k in keys:
            e = self.entries.pop(k, None)
            if e is not None and not e.lock.locked():
                idle.append(e)
        return idle

    def purge(self):
        """Drops the entries whose target was collected."""
        with self.lock:
            dead, self.dead = self.dead, []
            idle = self._take(dead)
        for e in idle:
            e.close()

    def clear(self, seen: bool = True) -> list:
        """Drops every entry and, with ``seen``, the configurations
        compiled; returns the entries it closed (not those a fit is
        running)."""
        with self.lock:
            idle = self._take(list(self.entries))
            if seen:
                self.seen = set()
        for e in idle:
            e.close()
        return idle

    def drop_groups(self, groups=None) -> list:
        """Drops the entries whose chunk runs collectives of ``groups``
        (of any group when ``None``: every group is being destroyed) and
        returns those it closed: their graphs hold the groups' captured
        communication kernels, which the groups' teardown would wait for
        (C12).  An entry a fit is running goes when that fit ends."""
        with self.lock:
            idle = self._take([k for k, e in self.entries.items()
                               if e.groups and (groups is None
                                                or e.groups & groups)])
        for e in idle:
            e.close()
        return idle

    def _lookup(self, chunk, targets, args):
        config = (chunk, tuple(_sig(a) for a in args), _env_switches())
        weak, held, ident = [], [], ()
        for t in targets:
            w, h, i = _identity(t)
            weak, held, ident = weak + w, held + h, ident + i
        key = (config, ident)
        device = _device(args)
        with self.lock:
            e = self.entries.get(key)
            if e is not None and e.matches(weak, held):
                if not e.lock.acquire(blocking=False):
                    # busy in another thread: a fit of its own
                    e = _Entry(config=config)
                    e.lock.acquire()
                    return e, False
                e.hit = True
                self.entries.move_to_end(key)
                _COUNTS.hits += 1
                return e, True
            # an entry on this target under another identity (its address
            # or version moved: changed in place) is stale, whatever its
            # configuration; one of another configuration is not
            ids = {id(o) for o in weak}
            idle = self._take([k for k, x in self.entries.items()
                               if k == key or (k[1] != ident and {
                                   id(r()) for r in x.refs} & ids)])
            e = _Entry(key, config, weak, held, device)
            e.lock.acquire()
            e.warm = config in self.seen
            if e.warm:
                _COUNTS.warm_misses += 1
            else:
                _COUNTS.cold_misses += 1
            self.entries[key] = e
            over = len(self.entries) - _MAX_ENTRIES
            if over > 0:
                idle += self._take([k for k, x in self.entries.items()
                                    if not x.lock.locked()][:over])
        for x in idle:
            x.close()
        return e, True

    def _trim(self, device):
        """Past ``device``'s byte budget (:func:`_held_budget`), its least
        recently used idle entries go."""
        budget = _held_budget(device)
        if budget is None:
            return
        with self.lock:
            mine = [(k, e, e.nbytes()) for k, e in self.entries.items()
                    if e.device == device]
            total, out = sum(n for _, _, n in mine), []
            for k, e, n in mine:
                if total <= budget:
                    break
                if not e.lock.locked():
                    total -= n
                    out.append(k)
            idle = self._take(out)
        for e in idle:
            e.close()

    @contextlib.contextmanager
    def use(self, chunk, targets, args, cached: bool = True):
        """Yields the entry of a fit of the chunk configuration ``chunk``
        (the factory's arguments the chunk reads) on ``targets`` (the
        objects whose identity keys it; none for a fit that copies its
        target into the entry at every fit, the halo fits') with ``args``
        (every argument the chunk reads, the targets included), its ``V``
        the first target while the fit runs.  ``cached=False`` (the eager
        reference): a fresh entry, closed after the fit.  A fit that raises
        drops its entry."""
        self.purge()
        if cached:
            e, kept = self._lookup(chunk, targets, args)
        else:
            e, kept = _Entry(), False
            e.lock.acquire()
        e.V = targets[0] if targets else None
        _FITTING.depth = getattr(_FITTING, "depth", 0) + 1
        done = False
        try:
            yield e
            done = True
        finally:
            _FITTING.depth -= 1
            e.V = None
            with self.lock:
                if not done and self.entries.get(e.key) is e:
                    del self.entries[e.key]
                elif done and kept and e.ready():
                    self.seen.add(e.config)
                e.lock.release()
                gone = self.entries.get(e.key) is not e
            if gone:
                e.close()
            elif done:
                self._trim(e.device)
            if not _FITTING.depth:
                self.purge()

    def run(self, chunk, targets, args, cached: bool, body):
        """``body(entry)`` of a fit (:meth:`use`).  Out of card memory,
        every idle entry goes; when one on the fit's card was kept from an
        earlier fit (this fit's own too), the fit runs once more from its
        inputs, with that memory back, before the error propagates."""
        device = _device(args)
        for again in (False, True):
            e = None
            try:
                with self.use(chunk, targets, args, cached) as e:
                    return body(e)
            except torch.cuda.OutOfMemoryError:
                freed = [x for x in self.clear(seen=False)
                         if x.device == device]
                if again or not _gives_back(device) or not (
                        freed or (e is not None and e.hit)):
                    raise
            gc.collect()  # the failed attempt's frames
            torch.cuda.empty_cache()


_CACHE = _Cache()


def compiled_cache_info() -> dict:
    """The fits' cache: ``hits``, ``warm_misses`` (a configuration compiled
    before, a new target: one capture and no eager chunk), ``cold_misses``
    (a configuration's first fit), ``entries`` and ``held_bytes`` (what the
    entries hold between fits: statics, derived tensors, the graphs'
    pools)."""
    _CACHE.purge()
    with _CACHE.lock:
        entries = list(_CACHE.entries.values())
        counts = dict(vars(_COUNTS))
    return dict(counts, entries=len(entries),
                held_bytes=sum(e.nbytes() for e in entries))


def compiled_cache_clear() -> None:
    """Drops every entry (one a fit is running goes when that fit ends),
    the configurations compiled and the factories' caches."""
    _CACHE.clear()
    for f in _FACTORIES:
        f.cache_clear()


def _converging_loop(
    one_iter: Callable,
    loss_of: Callable,
    state0,
    tol: float,
    max_iter: int,
    report: Optional[Callable] = None,
    extra_of: Optional[Callable] = None,
):
    """The chunked convergence loop: ``one_iter(state) -> state``,
    ``loss_of(state) -> 0-d tensor`` (on the reference's
    ``sqrt(2·divergence)`` scale); ``extra_of(state)``, read only when
    reporting, is a second value shown beside the loss.  Returns
    ``(state, n_chunks, converged)``."""
    loss_init = loss_of(state0)
    n_chunks, rem = divmod(max_iter, 10)
    state, prev, k, conv = state0, loss_init, 0, False
    while not conv and k < n_chunks:
        for _ in range(10):
            state = one_iter(state)
        loss = loss_of(state)
        # the one host sync per chunk; NaN compares False, as on the device
        conv = _read((prev - loss) / loss_init < tol, bool)
        prev, k = loss, k + 1
        if report is not None:
            report(k, _read(loss),
                   None if extra_of is None else _read(extra_of(state)))
    if rem and not conv:
        for _ in range(rem):
            state = one_iter(state)
    return state, k, conv


_CHUNK_NOT_CAPTURABLE = (
    "the fit's 10-iteration chunk cannot be captured in a CUDA graph: its "
    "updaters or loss read the card's values on the host (.item(), float(), "
    "bool() of a tensor, a copy from or to host memory) or do something "
    "else a graph cannot hold")


def _load(statics, values):
    """Copies a fit's inputs into the entry's static tensors."""
    for dst, x in zip(statics, values):
        dst.copy_(x)


# What an entry derives from its target is recomputed at every fit on a
# kept entry, into the tensors the entry keeps (a compiled chunk reads them
# where they lie): the key sees V's address and version counter, not its
# values, and a write through ``V.data``, ``V.numpy()`` or a sparse
# target's ``_values()`` moves neither.  One pass over V (or its
# non-zeros) a fit, as the JAX package's jitted fit derives them from V at
# every call.
def _keep(d, name, value):
    """``d[name] = value`` at an entry's first fit, copied into the kept
    tensor at every later one."""
    if name in d:
        d[name].copy_(value)
    else:
        d[name] = value


def _refreshers(*fns):
    """The distinct ``refresh(V)`` hooks that ``fns`` carry: what an updater
    or an E-step engine keeps from the target (the fused updaters' padded
    copy of V), recomputed in place."""
    out = []
    for f in fns:
        r = getattr(f, "refresh", None)
        if r is not None and r not in out:
            out.append(r)
    return out


def _loop_workload(c, stop, chunk, device):
    """Makes ``c.graphs``, the chunk loop of the statics ``c`` as one
    workload with a device loop: ``chunk()`` (one chunk, which advances
    the 0-d count ``c.k`` and sets the 0-d bool ``stop``) is the body of
    :func:`~.graphs._device_while` on ``c.go = ~stop & (c.k < c.limit)``,
    tested before the first chunk and after each.  ``c.reads`` gets the
    flag reads of an eager run (0 under capture)."""
    c.limit = torch.zeros((), dtype=torch.int64, device=device)
    c.go = torch.zeros((), dtype=torch.bool, device=device)
    c.reads = 0

    def go():
        torch.logical_and(~stop, c.k < c.limit, out=c.go)

    def body():
        chunk()
        go()

    def loop():
        go()
        c.reads = _device_while(c.go, body)

    c.graphs = _Graphs([loop], None, device, _CHUNK_NOT_CAPTURABLE,
                       conditional=True)


def _drive(c, n_chunks: int, report=None, status=None):
    """Runs the chunk loop of ``c`` (:func:`_loop_workload`) up to
    ``n_chunks`` chunks, as JAX's ``lax.while_loop`` runs them: each
    call of the workload runs chunks while the stop test passes and the
    chunk count is under ``c.limit``.  A configuration's own warm-ups on
    the card (its first fit's chunks 1-2, eager) and a reporting fit take
    one chunk a call (the limit one past the count); otherwise one call
    runs every chunk (on the card one replay, on the CPU one eager loop).
    The capture comes right after chunk 2 when a third may follow.  With
    ``report``, ``status()`` (where given; a loop with no stop test, the
    Hoyer fits', has none) and the reported values are read after each
    chunk.  Returns the last ``status()`` (``None`` without one)."""
    graphs, done, last = c.graphs, 0, None
    while done < n_chunks:
        warming = graphs.warming()
        step = 1 if warming or report is not None else n_chunks - done
        c.limit.fill_(done + step)
        c.reads = 0
        graphs()
        _read.reads += c.reads
        if report is not None:
            k, conv = done + 1, False
            if status is not None:
                last = k, conv = status()
            report(k, _read(c.prev),
                   None if c.extra is None else _read(c.extra))
            if conv:
                break
        elif warming and c.reads < 2:  # the flag was down: stopped before
            break
        done += step
        if warming and done == 2 < n_chunks:
            graphs.capture()
    if report is None and status is not None:
        last = status()
    return last


def _agree_path(entry, graphs, agree):
    """The ranks of a sharded fit take one path through the chunk loop, so
    that they capture together (and a capture's collectives find their
    peers): each rank's path is a code, 3 (replay from chunk 1: a kept
    entry), 2 (capture before chunk 1: a configuration seen before), or the
    warm-up runs done (0 or 1); ``agree(code)`` is the least code over the
    ranks, and a rank ahead of it falls back to it."""
    mine = 3 if graphs.ready() else 2 if entry.warm else graphs.runs[0]
    code = agree(mine)
    if code < mine:
        graphs.rewind(min(code, 2))
        entry.warm = code == 2


def _graphed_loop(
    one_iter: Callable,
    loss_of: Callable,
    state0,
    tol: float,
    max_iter: int,
    report: Optional[Callable] = None,
    extra_of: Optional[Callable] = None,
    entry: Optional[_Entry] = None,
    agree: Optional[Callable] = None,
):
    """:func:`_converging_loop` as one in-place workload of
    :class:`~.graphs._Graphs` with a device loop, JAX's ``lax.while_loop``:
    the chunk (ten iterations from static state tensors, the loss, the stop
    flag ``(prev - loss) / loss_init < tol`` on the device, NaN comparing
    False, ``prev ← loss``, the new state copied into the static tensors,
    the chunk count ``k`` on the device plus one) is the body of
    :func:`~.graphs._device_while` on ``go = ~stop & (k < limit)``, which a
    replay runs on the card (a CUDA-graph WHILE node) and the CPU runs
    eagerly, reading ``go`` before each chunk.  :func:`_drive` runs it: on
    a configuration's first fit on the card chunks 1-2 eagerly, the capture
    right after chunk 2 when a third may follow, then one replay for the
    rest; a warm fit one replay; a reporting fit one call a chunk.  One
    host read of ``(k, stop)`` a fit (a reporting fit's last) gives the
    chunks run and whether they converged.  ``entry`` (:class:`_Entry`; a
    fresh one if ``None``) keeps the statics and the graph for the next
    fit: the fit's state, ``loss_init`` (computed eagerly each fit), ``k``
    and ``stop`` are loaded, ``limit`` set by the drive.  The ``max_iter %
    10`` remainder runs eagerly, on a copy of the statics.  The same
    operations as :func:`_converging_loop`, so the same results bit for
    bit.  The device loop's kernel launches are handed to their counts at
    the end of each fit (:meth:`~.graphs._Graphs.flush`).  ``agree`` (the
    sharded fits'): the ranks agree on the path before the first chunk
    (:func:`_agree_path`)."""
    loss_init = loss_of(state0)
    n_chunks, rem = divmod(max_iter, 10)
    state, k, conv = state0, 0, False
    if n_chunks:
        own, entry = entry is None, entry or _Entry()
        c = entry.loop
        if c is None:
            dev = loss_init.device
            # (k, stop): the chunks run and the last stop flag, read at once
            status = torch.zeros(2, dtype=torch.int64, device=dev)
            c = entry.loop = SimpleNamespace(
                st=tuple(x.clone() for x in state0),
                loss_init=loss_init.clone(), prev=loss_init.clone(),
                stop=torch.zeros((), dtype=torch.bool, device=dev),
                status=status, k=status[0],
                extra=(torch.empty_like(loss_init)
                       if report is not None and extra_of is not None
                       else None))

            def chunk():
                s = c.st
                for _ in range(10):
                    s = one_iter(s)
                loss = loss_of(s)
                c.stop.copy_((c.prev - loss) / c.loss_init < tol)
                c.prev.copy_(loss)
                if c.extra is not None:
                    c.extra.copy_(extra_of(s))
                _load(c.st, s)
                c.k.add_(1)
                c.status[1].copy_(c.stop)

            _loop_workload(c, c.stop, chunk, dev)
        else:
            _load(c.st + (c.loss_init, c.prev), tuple(state0) + (
                loss_init, loss_init))
        c.status.zero_()
        c.stop.zero_()
        try:
            if agree is not None:
                _agree_path(entry, c.graphs, agree)
            entry.start(c.graphs)
            k, conv = _drive(c, n_chunks, report, lambda: _read(
                c.status, lambda t: tuple(t.tolist())))
        finally:
            c.graphs.flush()
        conv = bool(conv)
        state = tuple(x.clone() for x in c.st)
        if own:
            entry.close()
    if rem and not conv:
        for _ in range(rem):
            state = one_iter(state)
    return state, k, conv


@functools.lru_cache(maxsize=None)
def get_dense_fit(
    recon2: Callable,
    beta: float,
    tol: float,
    max_iter: int,
    update_W: bool,
    update_H: bool,
    l1_reg: float,
    l2_reg: float,
    verbose: bool = False,
    updater_factory: Optional[Callable] = None,
    _graph: bool = True,
):
    """Returns ``fit(V, W, H) -> (W, H, n_iter)`` for the dense β-divergence
    MU fit.  ``updater_factory(beta, gamma, l1_reg, l2_reg)`` supplies the
    updaters (``None``, or a factory returning ``None``, selects the
    generic engine over ``recon2``); each cache entry makes its own (their
    per-target state, such as a padded copy of V, lives with it).  The
    chunks run through :func:`_graphed_loop` on the fits' cache;
    ``_graph=False`` (private: the eager reference of the card's checks)
    runs :func:`_converging_loop` and keeps nothing."""
    gamma = gamma_from_beta(beta)

    def make_updaters():
        updaters = (updater_factory(beta, gamma, l1_reg, l2_reg)
                    if updater_factory else None)
        if updaters is None:
            updaters = _default_updaters(recon2, beta, gamma, l1_reg, l2_reg)
        return _normalize_updaters(updaters)

    make_updaters()  # a malformed factory raises here
    # what the chunk reads: every argument but max_iter and verbose
    chunk = ("dense", recon2, beta, tol, update_W, update_H, l1_reg, l2_reg,
             updater_factory)

    def build(e):
        upd_W, upd_H, loss_terms, prepare, finish = make_updaters()

        def loss_of(state):
            w, h = state
            if loss_terms is not None:
                return torch.sqrt(2.0 * loss_terms(e.V, w, h))
            return torch.sqrt(2.0 * beta_div(recon2(h, w), e.V, beta))

        def one_iter(state):
            w, h = state
            if update_W:
                w = upd_W(e.V, w, h)
            if update_H:
                h = upd_H(e.V, w, h)
            return w, h

        return SimpleNamespace(loss_of=loss_of, one_iter=one_iter,
                               prepare=prepare, finish=finish,
                               refresh=_refreshers(upd_W, upd_H, loss_terms))

    def run(e, V, W, H):
        if e.fns is None:
            e.fns = build(e)
        else:
            for r in e.fns.refresh:
                r(V)
        f = e.fns
        state0 = (W, H) if f.prepare is None else f.prepare(V, W, H)
        loop = (functools.partial(_graphed_loop, entry=e) if _graph
                else _converging_loop)
        with _progress(verbose, max_iter) as report:
            state, k, conv = loop(f.one_iter, f.loss_of, state0, tol,
                                  max_iter, report)
        W, H = state if f.finish is None else f.finish(V, *state)
        return W, H, (k * 10 if conv else max_iter)

    @torch.no_grad()
    def fit(V, W, H):
        return _CACHE.run(chunk, (V,), (V, W, H), _graph,
                          lambda e: run(e, V, W, H))

    return fit


# --------------------------------------------------------------------------
# Batched dense fit: many factorizations at once, each with its own early
# stop (no reference counterpart)
# --------------------------------------------------------------------------
def _lanes(mask, x):
    """The ``(B,)`` tensor ``mask`` with unit axes up to ``x``'s rank, so
    that each problem's entry broadcasts over its slice of ``x``."""
    return mask.reshape((-1,) + (1,) * (x.ndim - 1))


def _masked(conv, old, new):
    """``old`` where the problem has converged, else ``new``."""
    return torch.where(_lanes(conv, old), old, new)


def _batched_chunk(one_iter, loss_of, state, conv, prev, loss_init, k, k_conv,
                   tol):
    """One chunk of the batched loop: ten iterations, converged problems'
    state frozen, each problem's loss and stop test.  ``k`` is the 0-d
    count of chunks run before, a tensor on the device, so that a captured
    chunk records no chunk index of its own.  Returns ``(state, conv,
    loss, k + 1, k_conv)``."""
    new = state
    for _ in range(10):
        new = one_iter(new)
    new = tuple(_masked(conv, o, n) for o, n in zip(state, new))
    loss = torch.where(conv, prev, loss_of(new))
    newly = ~conv & ((prev - loss) / loss_init < tol)
    k = k + 1
    return new, conv | newly, loss, k, torch.where(newly, k, k_conv)


def _batched_rem(one_iter, state, conv, rem):
    """The ``max_iter % 10`` remainder, converged problems frozen."""
    new = state
    for _ in range(rem):
        new = one_iter(new)
    return tuple(_masked(conv, o, n) for o, n in zip(state, new))


def _batched_loop(one_iter, loss_of, state0, tol, max_iter):
    """:func:`_converging_loop` over a leading batch axis: ``loss_of(state)
    -> (B,)``.  The loop runs while any problem is unconverged; a converged
    problem's state is frozen, so each problem's trajectory and stop are
    those it would have alone.  One host read per chunk (counted in
    ``_read.reads``): whether every problem has converged.  Returns
    ``(state, conv, k)``: ``conv (B,)`` whether each problem converged, and
    ``k (B,)`` the chunk it converged at."""
    loss_init = loss_of(state0)
    B, device = loss_init.shape[0], loss_init.device
    conv = torch.zeros(B, dtype=torch.bool, device=device)
    k_conv = torch.zeros(B, dtype=torch.long, device=device)
    k = torch.zeros((), dtype=torch.long, device=device)
    n_chunks, rem = divmod(max_iter, 10)
    state, prev, done, chunks = state0, loss_init, False, 0
    while not done and chunks < n_chunks:
        state, conv, prev, k, k_conv = _batched_chunk(
            one_iter, loss_of, state, conv, prev, loss_init, k, k_conv, tol)
        chunks += 1
        done = _read(conv.all(), bool)
    if rem:
        state = _batched_rem(one_iter, state, conv, rem)
    return state, conv, k_conv


def _graphed_batched_loop(one_iter, loss_of, state0, tol, max_iter,
                          entry=None):
    """:func:`_batched_loop` as one in-place workload of
    :class:`~.graphs._Graphs`, as :func:`_graphed_loop` runs it: the body
    of its device loop is :func:`_batched_chunk` from static tensors (the
    state, ``conv``, ``prev``, ``loss_init``, the chunk count ``k`` and each
    problem's chunk of convergence, which ``entry`` keeps and each fit
    resets), then ``done`` (every problem converged) and ``go = ~done & (k
    < limit)``; :func:`_drive` runs it (a warm fit one replay).  Nothing is
    read on the host but the eager runs' flags: each problem's ``n_iter``
    comes from its chunk of convergence on the device.  The remainder runs
    eagerly.  The same operations as :func:`_batched_loop`, so the same
    results bit for bit."""
    loss_init = loss_of(state0)
    B, device = loss_init.shape[0], loss_init.device
    n_chunks, rem = divmod(max_iter, 10)
    state = state0
    conv = torch.zeros(B, dtype=torch.bool, device=device)
    k_conv = torch.zeros(B, dtype=torch.long, device=device)
    if n_chunks:
        own, entry = entry is None, entry or _Entry()
        c = entry.loop
        if c is None:
            c = entry.loop = SimpleNamespace(
                st=tuple(x.clone() for x in state0), conv=conv,
                k_conv=k_conv, prev=loss_init.clone(),
                loss_init=loss_init.clone(),
                k=torch.zeros((), dtype=torch.long, device=device),
                done=torch.zeros((), dtype=torch.bool, device=device))

            def chunk():
                s, cv, p, kk, kc = _batched_chunk(
                    one_iter, loss_of, c.st, c.conv, c.prev, c.loss_init, c.k,
                    c.k_conv, tol)
                _load(c.st + (c.conv, c.prev, c.k, c.k_conv),
                      s + (cv, p, kk, kc))
                c.done.copy_(c.conv.all())

            _loop_workload(c, c.done, chunk, device)
        else:
            _load(c.st + (c.prev, c.loss_init), tuple(state0) + (
                loss_init, loss_init))
            for t in (c.conv, c.k_conv, c.k, c.done):
                t.zero_()
        try:
            entry.start(c.graphs)
            _drive(c, n_chunks)
        finally:
            c.graphs.flush()
        state = tuple(x.clone() for x in c.st)
        conv, k_conv = c.conv.clone(), c.k_conv.clone()
        if own:
            entry.close()
    if rem:
        state = _batched_rem(one_iter, state, conv, rem)
    return state, conv, k_conv


def _batched_pos(pos):
    """An analytic β=1 denominator over a leading batch axis.  Its result
    gets unit axes after the batch axis up to its operand's rank, so each
    problem broadcasts against its factor as alone (a model's two factors
    have one rank)."""
    from torch.func import vmap

    def batched(x):
        out = vmap(pos)(x)
        return out.reshape(out.shape[:1] + (1,) * (x.ndim - out.ndim)
                           + out.shape[1:])

    return batched


@functools.lru_cache(maxsize=None)
def get_batched_dense_fit(
    recon2: Callable,
    beta: float,
    tol: float,
    max_iter: int,
    update_W: bool,
    update_H: bool,
    l1_reg: float,
    l2_reg: float,
    updater_factory: Optional[Callable] = None,
    _graph: bool = True,
):
    """Returns ``fit(V, W, H) -> (W, H, n_iter)`` over a leading batch axis:
    ``V (B, ...)``, ``W (B, ...)``, ``H (B, ...)``, ``n_iter (B,)`` (the
    JAX package's ``get_batched_dense_fit``).  ``recon2`` is the batched
    reconstruction ``(H (B, ...), W (B, ...)) -> (B, ...)`` (``recon.linear``
    is one batched GEMM; ``torch.func.vmap`` of another model's).  The
    problems share no parameters, so the gradients of the batch's summed
    cotangent products are each problem's own MU numerator and denominator.
    ``updater_factory`` (optional) supplies updaters that take batched
    operands (the Gram updaters at β = 2); it has no layout transform.
    The chunks run through :func:`_graphed_batched_loop` on the fits'
    cache; ``_graph=False`` (private: the eager reference of the
    card's checks) runs :func:`_batched_loop`."""
    from torch.func import vmap

    gamma = gamma_from_beta(beta)

    def make_updaters():
        updaters = (updater_factory(beta, gamma, l1_reg, l2_reg)
                    if updater_factory else None)
        if updaters is None:
            updaters = _default_updaters(recon2, beta, gamma, l1_reg, l2_reg,
                                         _batched_pos(kl_pos_W),
                                         _batched_pos(kl_pos_H))
        upd_W, upd_H, loss_terms, prepare, _ = _normalize_updaters(updaters)
        if prepare is not None or loss_terms is not None:
            raise ValueError("the batched fit takes updaters without a "
                             "layout transform or a loss")
        return upd_W, upd_H

    make_updaters()
    div_b = vmap(lambda wh, v: beta_div(wh, v, beta))
    chunk = ("batched_dense", recon2, beta, tol, update_W, update_H, l1_reg,
             l2_reg, updater_factory)

    def build(e):
        upd_W, upd_H = make_updaters()

        def one_iter(state):
            w, h = state
            if update_W:
                w = upd_W(e.V, w, h)
            if update_H:
                h = upd_H(e.V, w, h)
            return w, h

        def loss_of(state):
            w, h = state
            return torch.sqrt(2.0 * div_b(recon2(h, w), e.V))

        return SimpleNamespace(one_iter=one_iter, loss_of=loss_of)

    def run(e, W, H):
        f = e.fns = e.fns or build(e)
        loop = (functools.partial(_graphed_batched_loop, entry=e) if _graph
                else _batched_loop)
        (W, H), conv, k = loop(f.one_iter, f.loss_of, (W, H), tol, max_iter)
        return W, H, torch.where(conv, k * 10, max_iter)

    @torch.no_grad()
    def fit(V, W, H):
        return _CACHE.run(chunk, (V,), (V, W, H), _graph,
                          lambda e: run(e, W, H))

    return fit


# --------------------------------------------------------------------------
# Sparse-target β-divergence MU fit (reference fit, sparse path;
# nmf.py:351-353, 371-374, 383-387, 396-398 + _sp_double_backward_update)
# --------------------------------------------------------------------------
def _sp_factor_update(pos_neg_p, p, gamma, l1_reg, l2_reg, pos_pre=None):
    """MU step from the scalar pair ``pos_neg_p(p) -> (pos, neg)`` of one
    factor: numerator and denominator are the two scalars' gradients
    (reference ``_sp_double_backward_update``, nmf.py:95-119)."""
    with torch.enable_grad():
        x = p.detach().requires_grad_(True)
        pos, neg = pos_neg_p(x)
        (g,) = torch.autograd.grad(neg, x, retain_graph=pos_pre is None)
        neg = torch.relu(g) + eps
        if pos_pre is None:
            (g,) = torch.autograd.grad(pos, x)
            pos = torch.relu(g) + eps
        else:
            pos = pos_pre
    return p * mu_multiplier(neg, pos, p, gamma, l1_reg, l2_reg)


@functools.lru_cache(maxsize=None)
def get_sparse_fit(
    pos_neg: Callable,
    beta: float,
    tol: float,
    max_iter: int,
    update_W: bool,
    update_H: bool,
    l1_reg: float,
    l2_reg: float,
    verbose: bool = False,
    tier: str = "gather",
    recon2: Optional[Callable] = None,
    updater_factory: Optional[Callable] = None,
    _graph: bool = True,
):
    """Returns ``fit(V, W, H) -> (W, H, n_iter)`` for a sparse target:
    ``V`` a coalesced ``torch.sparse_coo_tensor`` (``tier="ell"``: its
    :class:`~.sparse.SparseELL` layout).  ``pos_neg(V, H, W, beta) -> (pos,
    neg)`` is the model's split scalar pair (for NMF,
    :func:`~.sparse.nmf_sp_pos_neg`).  Three tiers:

    * ``"densify"``: the target is densified once at fit entry and the
      updates run through the dense updaters of ``updater_factory`` (the
      model's resolver: B1 on a CUDA float32 target at β ≠ 2) or the
      generic engine over ``recon2``; zero entries contribute nothing to
      any β cotangent, so the updates are the sparse ones;
    * ``"ell"``: the dual-ELL layout; each numerator is a dense reduction
      over one side's padded non-zeros (:func:`~.sparse.ell_neg_grad`),
      each denominator a closed form.  Fixed-order sums: deterministic;
    * ``"gather"``: ``torch.autograd.grad`` of the scalar pair, whose
      gathers' gradients are scatter-adds into the factors (advanced
      indexing's backward); held to the other tiers by tolerance.

    The every-10-iterations loss is the exact split form ``V_norm + pos -
    neg`` over the non-zeros in every tier (reference nmf.py:358,398).
    The chunks run through :func:`_graphed_loop` on the fits' cache,
    whose entry keeps ``V_norm``, the densified target (both recomputed
    from V's values at every fit) and the blocks' stage size
    (:func:`~.sparse.fixed_stage`); the ELL layout's values are refreshed
    from its target's at every fit (:func:`~.sparse.refresh_ell`).
    ``_graph=False`` (private: the eager reference of the card's checks)
    runs :func:`_converging_loop`."""
    if tier not in ("densify", "ell", "gather"):
        raise ValueError(f"unknown sparse tier {tier!r}")
    gamma = gamma_from_beta(beta)

    def make_updaters():
        updaters = (updater_factory(beta, gamma, l1_reg, l2_reg)
                    if updater_factory else None)
        if updaters is None:
            updaters = _default_updaters(recon2, beta, gamma, l1_reg, l2_reg)
        upd_W_d, upd_H_d, _, prepare, _ = _normalize_updaters(updaters)
        if prepare is not None:
            raise ValueError("the sparse densify tier takes no layout-"
                             "transforming updater factory")
        return upd_W_d, upd_H_d

    if tier == "densify":
        make_updaters()
    chunk = ("sparse", pos_neg, beta, tol, update_W, update_H, l1_reg, l2_reg,
             tier, recon2, updater_factory)

    def ell_update(p, neg_raw, pos_pre, pos_raw):
        neg = torch.relu(neg_raw) + eps
        pos = pos_pre if pos_pre is not None else torch.relu(pos_raw) + eps
        return p * mu_multiplier(neg, pos, p, gamma, l1_reg, l2_reg)

    def ell_neg(side_idx, side_val, rem, self_f, other_f):
        g = _sparse.ell_neg_grad(side_idx, side_val, self_f, other_f, beta)
        if rem[2].numel():  # the hybrid's over-cap spill (a shape)
            g = g + _sparse.coo_rem_neg_grad(rem, self_f, other_f, beta)
        return g

    def derive(e, V):
        """``V_norm`` and the densified target from V's values, into the
        entry's tensors (made at its first fit)."""
        coo = V.coo if tier == "ell" else V
        d = e.derived
        _keep(d, "V_norm", _sparse.get_V_norm(coo, beta))
        if tier == "densify":
            if "Vd" in d:
                _sparse.densify(coo, out=d["Vd"])
            else:
                d["Vd"] = _sparse.densify(coo)

    def build(e, V):
        coo = V.coo if tier == "ell" else V
        d = e.derived
        derive(e, V)
        d["stage"] = _sparse.stage_bytes(coo.device)
        refresh = []
        if tier == "densify":
            upd_W, upd_H = make_updaters()
            refresh = _refreshers(upd_W, upd_H)

        def loss_of(state):
            w, h = state
            V = e.V
            if tier == "ell":
                pos = _sparse.nmf_ell_pos_scalar(w, h, beta)
                neg = _sparse.ell_neg_scalar(V.row_idx, V.row_val, h, w, beta)
                if V.row_rem[2].numel():
                    neg = neg + _sparse.coo_rem_neg_scalar(V.row_rem, h, w, beta)
            else:
                pos, neg = pos_neg(V, h, w, beta)
            return torch.sqrt(2.0 * (d["V_norm"] + pos - neg))

        def one_iter(state):
            w, h = state
            V = e.V
            if tier == "densify":
                if update_W:
                    w = upd_W(d["Vd"], w, h)
                if update_H:
                    h = upd_H(d["Vd"], w, h)
            elif tier == "ell":
                if update_W:
                    w = ell_update(
                        w, ell_neg(V.col_idx, V.col_val, V.col_rem, w, h),
                        kl_pos_W(h) if beta == 1 else None,
                        None if beta == 1
                        else _sparse.nmf_ell_pos_grad(w, h, beta, want_H=False))
                if update_H:
                    h = ell_update(
                        h, ell_neg(V.row_idx, V.row_val, V.row_rem, h, w),
                        kl_pos_H(w) if beta == 1 else None,
                        None if beta == 1
                        else _sparse.nmf_ell_pos_grad(w, h, beta, want_H=True))
            else:
                if update_W:
                    w = _sp_factor_update(
                        lambda x: pos_neg(V, h, x, beta), w, gamma, l1_reg,
                        l2_reg, kl_pos_W(h) if beta == 1 else None)
                if update_H:
                    h = _sp_factor_update(
                        lambda x: pos_neg(V, x, w, beta), h, gamma, l1_reg,
                        l2_reg, kl_pos_H(w) if beta == 1 else None)
            return w, h

        return SimpleNamespace(loss_of=loss_of, one_iter=one_iter,
                               refresh=refresh)

    def run(e, V, W, H):
        if tier == "ell":  # the layout's values from its target's, each fit
            _sparse.refresh_ell(V)
        if e.fns is None:
            e.fns = build(e, V)
        else:
            derive(e, V)
            for r in e.fns.refresh:  # the updaters' padded copy of Vd
                r(e.derived["Vd"])
        f = e.fns
        loop = (functools.partial(_graphed_loop, entry=e) if _graph
                else _converging_loop)
        with _progress(verbose, max_iter) as report, \
                _sparse.fixed_stage(e.derived["stage"]):
            (W, H), k, conv = loop(f.one_iter, f.loss_of, (W, H), tol,
                                   max_iter, report)
        return W, H, (k * 10 if conv else max_iter)

    @torch.no_grad()
    def fit(V, W, H):
        return _CACHE.run(chunk, (V,), (V, W, H), _graph,
                          lambda e: run(e, V, W, H))

    return fit


# --------------------------------------------------------------------------
# Hoyer sparseness-constrained fit (reference sparse_fit; nmf.py:411-599)
# --------------------------------------------------------------------------
def _f32(x: float) -> float:
    """``x`` rounded to float32, the dtype the JAX package carries its step
    sizes in (float64 fits too)."""
    return float(np.float32(x))


def _backtrack_project(loss_baseline, loss_of_new, p, grad, stepsize,
                       L1_scale):
    """Backtracking line search with per-column Hoyer projection (reference
    nmf.py:515-535): try ``p - ss·grad`` projected column-wise onto
    ``(L1_scale·norm_j, norm_j²)``; halve the step until the new loss is no
    worse, at most 10 attempts; keep the last candidate even if it failed,
    halve the step once more when the 10th attempt failed, then grow it by
    1.2.  ``stepsize`` is a 0-d float32 tensor on ``p``'s device, as the
    JAX package carries it, and so is the returned step: every product is
    a float32 one.  Returns ``(p_new, step)``.

    Attempt 1 always runs; attempts 2-10 run in a
    :func:`~.graphs._device_while` loop on the flag "the last attempt was
    worse, and fewer than 10 were made", each updating the first attempt's
    candidate, the flags, the attempt count and the step in place (JAX's
    ``lax.while_loop``).  Eagerly each test of the flag is one host read,
    counted in ``_backtrack_project.reads`` (one an attempt); in a captured
    chunk the card decides and the host reads nothing.
    ``_backtrack_project.attempts`` counts the attempts run (those of a
    replayed chunk's loop bodies on the card)."""
    ss = stepsize.clone()
    cand = proj_columns(p - ss * grad, L1_scale)
    _backtrack_project.add("attempts")
    worse = loss_of_new(cand) > loss_baseline
    tries = torch.ones((), dtype=torch.int32, device=worse.device)
    again = worse.clone()

    def retry():
        ss.mul_(0.5)
        pnew = proj_columns(p - ss * grad, L1_scale)
        _backtrack_project.add("attempts")
        cand.copy_(pnew)
        worse.copy_(loss_of_new(pnew) > loss_baseline)
        tries.add_(1)
        torch.logical_and(worse, tries < 10, out=again)

    _backtrack_project.reads += _device_while(again, retry)
    return cand, torch.where(worse, ss * 0.5, ss) * 1.2


_backtrack_project = _Counted(_backtrack_project, on_card=("attempts",),
                              reads=0, attempts=0)


def _value_and_grad(f, x):
    """``(f(x), ∂f/∂x)`` of a scalar ``f``, on a fresh leaf."""
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        val = f(x)
        (g,) = torch.autograd.grad(val, x)
    return val.detach(), g


def _hoyer_loop(one_iter, loss_of, state, max_iter, report):
    """The Hoyer fit's eager loop: ``max_iter`` calls of ``one_iter(*state)
    -> state``; when reporting, ``loss_of(state)`` read after every 10th."""
    for i in range(1, max_iter + 1):
        state = one_iter(*state)
        if report is not None and i % 10 == 0:
            report(i // 10, _read(loss_of(state)))
    return state


def _graphed_hoyer_loop(one_iter, loss_of, state0, max_iter, report,
                        entry=None):
    """:func:`_hoyer_loop` as one in-place workload of
    :class:`~.graphs._Graphs`, JAX's jitted ``lax.fori_loop``: the
    10-iteration chunk (ten iterations from static state tensors, the
    factors and the step sizes, which ``entry`` keeps and each fit loads;
    when reporting, the loss into a static 0-d tensor; the chunk count
    ``k`` on the device plus one) is the body of
    :func:`~.graphs._device_while` on ``go = ~stop & (k < limit)`` with a
    stop flag that never rises (JAX's Hoyer fit has no stop test), so every
    chunk runs.  Each iteration's line searches are device loops of their
    own, nested in the chunk's body (on the card WHILE nodes inside the
    chunk loop's WHILE node).  :func:`_drive` runs it: on a
    configuration's first fit on the card chunks 1-2 eagerly, the capture
    right after chunk 2 when a third follows, then one replay for the
    rest; a warm fit (or one on a new V, after its capture) one replay,
    which reads nothing on the host; a reporting fit one call a chunk, its
    loss read after each.  The ``max_iter % 10`` remainder runs eagerly,
    on a copy of the statics, as :func:`_graphed_loop` runs it.  The same
    operations as :func:`_hoyer_loop`, so the same results bit for bit.
    The device loops' executions are handed to their counts at the end of
    each fit (:meth:`~.graphs._Graphs.flush`)."""
    n_chunks, rem = divmod(max_iter, 10)
    state = state0
    if n_chunks:
        own, entry = entry is None, entry or _Entry()
        c = entry.loop
        if c is None:
            dev = state0[0].device
            c = entry.loop = SimpleNamespace(
                st=tuple(x.clone() for x in state0),
                k=torch.zeros((), dtype=torch.int64, device=dev),
                stop=torch.zeros((), dtype=torch.bool, device=dev),
                prev=(torch.empty((), dtype=state0[0].dtype, device=dev)
                      if report is not None else None), extra=None)

            def chunk():
                s = c.st
                for _ in range(10):
                    s = one_iter(*s)
                if c.prev is not None:
                    c.prev.copy_(loss_of(s))
                _load(c.st, s)
                c.k.add_(1)

            _loop_workload(c, c.stop, chunk, dev)
        else:
            _load(c.st, state0)
        c.k.zero_()
        try:
            entry.start(c.graphs)
            _drive(c, n_chunks, report)
        finally:
            c.graphs.flush()
        state = tuple(x.clone() for x in c.st)
        if own:
            entry.close()
    for _ in range(rem):
        state = one_iter(*state)
    return state


@functools.lru_cache(maxsize=None)
def get_hoyer_fit(
    recon2: Optional[Callable],
    pos_neg: Optional[Callable],
    beta: float,
    max_iter: int,
    update_W: bool,
    update_H: bool,
    sW: Optional[float],
    sH: Optional[float],
    W_col_dim: int,
    H_col_dim: int,
    verbose: bool = False,
    _graph: bool = True,
):
    """Returns ``fit(V, W, H) -> (W, H, n_iter)``: Hoyer'04 sparseness-
    constrained fitting, exactly ``max_iter`` iterations (no tolerance
    stop).  Exactly one of ``recon2`` (dense target) and ``pos_neg`` (sparse
    COO target, the model's split scalar pair) is given.  ``W_col_dim`` and
    ``H_col_dim`` are the flattened sizes of one rank column, for the L1
    targets (reference nmf.py:460-461, 469-470).

    A constrained factor is first projected to unit L2 norm per column,
    then takes, each iteration, a gradient step of the loss with the
    backtracking projection (:func:`_backtrack_project`); an unconstrained
    one takes the generic MU step (``_default_updaters`` on a dense target,
    ``_sp_factor_update`` on a sparse one).  Whenever H is trainable the
    pair is renormed onto unit-norm H (reference nmf.py:585).  The step
    sizes start at 1 as 0-d float32 tensors on V's device.

    Either target's fit runs its chunks through :func:`_graphed_hoyer_loop`
    on the fits' cache (a sparse target's ``V_norm`` kept with its entry,
    recomputed at every fit); ``_graph=False`` (private: the eager
    reference of the card's checks) runs :func:`_hoyer_loop`."""
    gamma = gamma_from_beta(beta)
    sparse = pos_neg is not None
    L1a = hoyer_l1_target(W_col_dim, sW) if sW is not None else None
    L1s = hoyer_l1_target(H_col_dim, sH) if sH is not None else None
    if not sparse:
        upd_W, upd_H = _default_updaters(recon2, beta, gamma, 0.0, 0.0)
    # a reporting chunk also computes the loss
    chunk = ("hoyer", recon2, pos_neg, beta, update_W, update_H, sW, sH,
             W_col_dim, H_col_dim, bool(verbose))

    def build(e, V):
        if sparse:
            V_norm = e.derived["V_norm"]

            def loss(w, h):
                pos, neg = pos_neg(e.V, h, w, beta)
                return V_norm + pos - neg

            def mu_W(w, h):
                return _sp_factor_update(
                    lambda x: pos_neg(e.V, h, x, beta), w, gamma, 0.0, 0.0,
                    kl_pos_W(h) if beta == 1 else None)

            def mu_H(w, h):
                return _sp_factor_update(
                    lambda x: pos_neg(e.V, x, w, beta), h, gamma, 0.0, 0.0,
                    kl_pos_H(w) if beta == 1 else None)
        else:
            def loss(w, h):
                return beta_div(recon2(h, w), e.V, beta)

            def mu_W(w, h):
                return upd_W(e.V, w, h)

            def mu_H(w, h):
                return upd_H(e.V, w, h)

        def one_iter(w, h, ssW, ssH):
            if update_W:
                if sW is None:
                    w = mu_W(w, h)
                else:
                    base, grad = _value_and_grad(lambda x: loss(x, h), w)
                    w, ssW = _backtrack_project(
                        base, lambda x: loss(x, h), w, grad, ssW, L1a)
            if update_H:
                if sH is None:
                    h = mu_H(w, h)
                else:
                    base, grad = _value_and_grad(lambda x: loss(w, x), h)
                    h, ssH = _backtrack_project(
                        base, lambda x: loss(w, x), h, grad, ssH, L1s)
                w, h = renorm(w, h, "H")
            return w, h, ssW, ssH

        def loss_of(state):
            return torch.sqrt(2.0 * loss(*state[:2]))

        return SimpleNamespace(one_iter=one_iter, loss_of=loss_of)

    def run(e, V, W, H):
        if sparse:  # from V's values at every fit
            _keep(e.derived, "V_norm", _sparse.get_V_norm(V, beta))
        f = e.fns = e.fns or build(e, V)
        # the constrained factors start at unit L2 per column
        # (nmf.py:459-475)
        if sW is not None and update_W:
            W = proj_columns_explicit(W, L1a, 1.0)
        if sH is not None and update_H:
            H = proj_columns_explicit(H, L1s, 1.0)
        one = torch.ones((), dtype=torch.float32, device=V.device)
        loop = (functools.partial(_graphed_hoyer_loop, entry=e) if _graph
                else _hoyer_loop)
        with _progress(verbose, max_iter) as report:
            state = loop(f.one_iter, f.loss_of, (W, H, one, one.clone()),
                         max_iter, report)
        return state[0], state[1], max_iter

    @torch.no_grad()
    def fit(V, W, H):
        return _CACHE.run(chunk, (V,), (V, W, H), _graph,
                          lambda e: run(e, V, W, H))

    return fit


def _batched_backtrack_project(loss_baseline, loss_of_new, p, grad, stepsize,
                               L1_scale):
    """:func:`_backtrack_project` for every problem of a batch at once, as
    JAX's ``vmap`` of its ``lax.while_loop`` runs it: ``p (B, ...)`` with
    its rank columns on axis 2, ``loss_baseline``, ``loss_of_new(x)`` and
    ``stepsize`` per problem, ``(B,)`` (the step a float32 tensor on
    ``p``'s device).  Each round projects every problem's candidate (one
    :func:`~.projection.proj_problem_columns`, one P1 launch on the card);
    a problem is active while its last attempt was worse and it made fewer
    than 10, and only the active problems take the round's step, candidate,
    flag and count, so each problem's search is the one it has alone.
    Rounds 2-10 run in a :func:`~.graphs._device_while` loop on "any
    problem is active" (eagerly one host read a round, counted in
    ``_batched_backtrack_project.reads``; ``.rounds`` counts the rounds,
    those of a replayed chunk on the card).  Returns ``(p_new, step,
    tries)``: ``tries (B,)`` each problem's attempts."""
    ss = stepsize.clone()
    cand = _proj_problems(p - _lanes(ss, p) * grad, L1_scale)
    _batched_backtrack_project.add("rounds")
    worse = loss_of_new(cand) > loss_baseline
    tries = torch.ones(worse.shape, dtype=torch.int32, device=worse.device)
    again = worse.any()

    def retry():
        active = worse & (tries < 10)
        ss.copy_(torch.where(active, ss * 0.5, ss))
        pnew = _proj_problems(p - _lanes(ss, p) * grad, L1_scale)
        _batched_backtrack_project.add("rounds")
        cand.copy_(torch.where(_lanes(active, p), pnew, cand))
        worse.copy_(torch.where(active, loss_of_new(pnew) > loss_baseline,
                                worse))
        tries.add_(active.to(tries.dtype))
        torch.any(worse & (tries < 10), out=again)

    _batched_backtrack_project.reads += _device_while(again, retry)
    return cand, torch.where(worse, ss * 0.5, ss) * 1.2, tries


_batched_backtrack_project = _Counted(_batched_backtrack_project,
                                      on_card=("rounds",), reads=0, rounds=0)


def _proj_problems(x, L1_scale):
    """Every problem's rank columns (axis 2) projected at their own norms
    (:func:`~.projection.proj_columns` problem by problem)."""
    norms = torch.sqrt(torch.sum(x * x, dim=(1,) + tuple(range(3, x.ndim))))
    return proj_problem_columns(x, L1_scale * norms, norms * norms)


@contextlib.contextmanager
def _without_cudnn():
    """cuDNN off inside: the grouped convolutions that ``vmap`` makes of a
    batched deconvolution crash the capture of a graph that holds WHILE
    nodes (cuDNN's kernels, with PyTorch 2.11 and CUDA 12.9 on the H100);
    PyTorch's own convolution kernels capture."""
    enabled = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = enabled


def _values_and_grad(f, x):
    """``(f(x), ∂Σf/∂x)`` of a per-problem ``f -> (B,)``: the problems
    share no parameters, so each problem's slice of the gradient is its
    own loss's."""
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        vals = f(x)
        (g,) = torch.autograd.grad(vals, x, torch.ones_like(vals))
    return vals.detach(), g


@functools.lru_cache(maxsize=None)
def get_batched_hoyer_fit(
    recon2: Callable,
    beta: float,
    max_iter: int,
    update_W: bool,
    update_H: bool,
    sW: Optional[float],
    sH: Optional[float],
    W_col_dim: int,
    H_col_dim: int,
    _graph: bool = True,
):
    """Batched Hoyer fit for dense targets: ``fit(V (B, ...), W (B, ...),
    H (B, ...)) -> (W, H, n_iter (B,))``, the JAX package's ``vmap`` of the
    single-problem fit as one batched program.  ``recon2`` is the batched
    reconstruction (as for :func:`get_batched_dense_fit`); the rank columns
    lie on axis 2.  Each problem's loss is its own β-divergence, ``(B,)``;
    every projection of the batch is one :func:`~.projection.
    proj_problem_columns`; each problem's line search is its own
    (:func:`_batched_backtrack_project`), its step ``(B,)`` float32; the
    pair is renormed problem by problem.  The chunks run through
    :func:`_graphed_hoyer_loop` on the fits' cache;
    ``_graph=False`` (private: the eager reference of the card's checks)
    runs :func:`_hoyer_loop`.  ``fit(..., _attempts=True)`` also returns
    each problem's line-search attempts, ``(B,)``.  The loop runs with
    cuDNN off (:func:`_without_cudnn`)."""
    from torch.func import vmap

    gamma = gamma_from_beta(beta)
    L1a = hoyer_l1_target(W_col_dim, sW) if sW is not None else None
    L1s = hoyer_l1_target(H_col_dim, sH) if sH is not None else None
    upd_W, upd_H = _default_updaters(recon2, beta, gamma, 0.0, 0.0,
                                     _batched_pos(kl_pos_W),
                                     _batched_pos(kl_pos_H))
    div_b = vmap(lambda wh, v: beta_div(wh, v, beta))
    renorm_b = vmap(lambda w, h: renorm(w, h, "H"))
    chunk = ("batched_hoyer", recon2, beta, update_W, update_H, sW, sH,
             W_col_dim, H_col_dim)

    def build(e):
        def loss(w, h):
            return div_b(recon2(h, w), e.V)

        def one_iter(w, h, ssW, ssH, att):
            if update_W:
                if sW is None:
                    w = upd_W(e.V, w, h)
                else:
                    base, grad = _values_and_grad(lambda x: loss(x, h), w)
                    w, ssW, tries = _batched_backtrack_project(
                        base, lambda x: loss(x, h), w, grad, ssW, L1a)
                    att = att + tries
            if update_H:
                if sH is None:
                    h = upd_H(e.V, w, h)
                else:
                    base, grad = _values_and_grad(lambda x: loss(w, x), h)
                    h, ssH, tries = _batched_backtrack_project(
                        base, lambda x: loss(w, x), h, grad, ssH, L1s)
                    att = att + tries
                w, h = renorm_b(w, h)
            return w, h, ssW, ssH, att

        return SimpleNamespace(one_iter=one_iter)

    def run(e, V, W, H):
        f = e.fns = e.fns or build(e)
        # the constrained factors start at unit L2 per column
        # (nmf.py:459-475)
        if sW is not None and update_W:
            W = proj_problem_columns(W, L1a, 1.0)
        if sH is not None and update_H:
            H = proj_problem_columns(H, L1s, 1.0)
        B = V.shape[0]
        one = torch.ones(B, dtype=torch.float32, device=V.device)
        att = torch.zeros(B, dtype=torch.int32, device=V.device)
        loop = (functools.partial(_graphed_hoyer_loop, entry=e) if _graph
                else _hoyer_loop)
        with _without_cudnn():
            W, H, _, _, att = loop(f.one_iter, None,
                                   (W, H, one, one.clone(), att), max_iter,
                                   None)
        return W, H, att

    @torch.no_grad()
    def fit(V, W, H, _attempts=False):
        W, H, att = _CACHE.run(chunk, (V,), (V, W, H), _graph,
                               lambda e: run(e, V, W, H))
        n_iter = torch.full((V.shape[0],), max_iter, dtype=torch.long,
                            device=V.device)
        return (W, H, n_iter, att) if _attempts else (W, H, n_iter)

    return fit


# --------------------------------------------------------------------------
# PLCA EM fit (reference plca.py:193-304)
# --------------------------------------------------------------------------
def _plca_marginal_sum(x):
    """Sum over all axes but the rank axis, kept for broadcasting — the
    probability normalizer (reference plca.py:23-31 ``get_norm``)."""
    if x.ndim > 1:
        axes = tuple(d for d in range(x.ndim) if d != 1)
        return torch.sum(x, dim=axes, keepdim=True)
    return torch.sum(x)


def _threshold_eps(x):
    """``F.threshold(x, eps, eps)``: values ``<= eps`` become ``eps``."""
    return torch.where(x > eps, x, torch.full_like(x, eps))


def alpha_is_active(alpha) -> bool:
    """Whether a Dirichlet prior hyperparameter differs from the neutral 1
    (array-valued alphas always count as active)."""
    return not (isinstance(alpha, (int, float)) and alpha == 1)


def _plca_e_step(recon3, Vn, w, h, z):
    """The E-step: one backward pass of the reconstruction with cotangent
    ``Vn / (WZH + eps)`` (reference plca.py:252-253), on fresh leaves so no
    graph outlives it.  Every factor gets its gradient, a frozen one too:
    Z's M-step reads them.  Returns ``(gH, gW, gZ)``."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(True) for x in (h, w, z)]
        WZH = recon3(*leaves)
        return torch.autograd.grad(WZH, leaves, Vn / (WZH.detach() + eps))


def _plca_em_iter(recon3, update_W, update_H, update_Z, W_alpha_active,
                  H_alpha_active, Z_alpha_active, Vn, state, W_alpha, H_alpha,
                  Z_alpha, cotangents=None):
    """One EM iteration: the E-step (:func:`_plca_e_step`, or
    ``cotangents(Vn, w, h, z) -> (gH, gW, gZ)`` of :mod:`.fast_plca`), then
    :func:`_plca_m_step`."""
    w, h, z = state
    if cotangents is not None:
        gH, gW, gZ = cotangents(Vn, w, h, z)
    else:
        gH, gW, gZ = _plca_e_step(recon3, Vn, w, h, z)
    return _plca_m_step(update_W, update_H, update_Z, W_alpha_active,
                        H_alpha_active, Z_alpha_active, w, h, z, gH, gW, gZ,
                        W_alpha, H_alpha, Z_alpha)


def _plca_m_step(update_W, update_H, update_Z, W_alpha_active, H_alpha_active,
                 Z_alpha_active, w, h, z, gH, gW, gZ, W_alpha, H_alpha,
                 Z_alpha, h_marginal=None, h_mask=None):
    """The M-step: closed-form renormalizations of the unnormalized
    posterior marginals with optional Dirichlet MAP (reference
    plca.py:255-289).  Returns ``(w, h, z)``.

    The sharded fits pass ``h_marginal`` (the H marginal summed over the
    ranks) and ``h_mask`` (zero at H's padded positions, which the prior's
    ``h + (alpha - 1)`` would otherwise fill)."""
    if h_marginal is None:
        h_marginal = _plca_marginal_sum
    Z_prior = None
    if update_Z:
        z = z * torch.relu(gZ)
        Z_prior = z
        if Z_alpha_active:
            z = _threshold_eps(z + (Z_alpha - 1.0))
        z = z / torch.sum(z)

    if update_W:
        w = w * torch.relu(gW)
        if Z_prior is None:
            W_divider = _plca_marginal_sum(w)
            Z_prior = W_divider.reshape(-1)
        else:
            W_divider = Z_prior.reshape((-1,) + (1,) * (w.ndim - 2))
        w = w / W_divider
        if W_alpha_active:
            w = _threshold_eps(w + (W_alpha - 1.0))
            w = w / _plca_marginal_sum(w)

    if update_H:
        h = h * torch.relu(gH)
        if Z_prior is None:
            H_divider = h_marginal(h)
        else:
            H_divider = Z_prior.reshape((-1,) + (1,) * (h.ndim - 2))
        h = h / H_divider
        if H_alpha_active:
            h = _threshold_eps(h + (H_alpha - 1.0))
            if h_mask is not None:
                h = h * h_mask
            h = h / h_marginal(h)

    return w, h, z


@functools.lru_cache(maxsize=None)
def get_plca_fit(
    recon3: Callable,
    tol: float,
    max_iter: int,
    update_W: bool,
    update_H: bool,
    update_Z: bool,
    W_alpha_active: bool,
    H_alpha_active: bool,
    Z_alpha_active: bool,
    verbose: bool = False,
    em_engine: Optional[Callable] = None,
    _graph: bool = True,
):
    """Returns ``fit(V, W, H, Z, W_alpha, H_alpha, Z_alpha) -> (W, H, Z,
    n_iter, norm)``: EM maximizing the posterior log-probability
    (reference plca.py:193-304).  ``V`` arrives unnormalized and is divided
    by ``norm = V.sum()`` inside.  ``em_engine()`` (optional) supplies the
    E-step cotangents, one engine a cache entry.  ``n_iter`` is the
    reference's raw loop index: ``10·k - 1`` when chunk ``k`` converged,
    else ``max_iter - 1``.  The chunks run as :func:`get_dense_fit`'s do
    (``_graph`` likewise); an entry keeps ``norm``, ``Vn`` (recomputed
    from V at every fit) and the priors (copied in each fit)."""
    # a reporting chunk also computes the log-probability
    chunk = ("plca", recon3, tol, update_W, update_H, update_Z, W_alpha_active,
             H_alpha_active, Z_alpha_active, bool(verbose), em_engine)

    def derive(e, V):
        """``norm = V.sum()`` and ``Vn = V / norm`` into the entry's
        tensors (made at its first fit)."""
        d = e.derived
        _keep(d, "norm", V.sum())
        if "Vn" in d:
            torch.div(V, d["norm"], out=d["Vn"])
        else:
            d["Vn"] = V / d["norm"]

    def build(e, V, alphas):
        cotangents = em_engine() if em_engine is not None else None
        d = e.derived
        derive(e, V)
        d["alphas"] = tuple(a.clone() for a in alphas)
        norm, Vn, (W_alpha, H_alpha, Z_alpha) = d["norm"], d["Vn"], \
            d["alphas"]

        def log_probability(state):
            # shown beside the loss when verbose (reference plca.py:18-20)
            w, h, z = state
            WZH = recon3(h, w, z)
            lp = matmul(Vn.reshape(-1), torch.log(WZH + eps).reshape(-1))
            lp = lp + torch.sum(torch.log(w + eps) * (W_alpha - 1.0))
            lp = lp + torch.sum(torch.log(h + eps) * (H_alpha - 1.0))
            return lp + torch.sum(torch.log(z + eps) * (Z_alpha - 1.0))

        def loss_of(state):
            w, h, z = state
            return torch.sqrt(2.0 * kl_div(recon3(h, w, z) * norm, Vn * norm))

        def one_iter(state):
            return _plca_em_iter(
                recon3, update_W, update_H, update_Z, W_alpha_active,
                H_alpha_active, Z_alpha_active, Vn, state, W_alpha, H_alpha,
                Z_alpha, cotangents)

        return SimpleNamespace(loss_of=loss_of, one_iter=one_iter,
                               extra_of=log_probability,
                               refresh=_refreshers(cotangents))

    def run(e, V, W, H, Z, alphas):
        if e.fns is None:
            e.fns = build(e, V, alphas)
        else:
            derive(e, V)
            for r in e.fns.refresh:  # the E-step's padded copy of Vn
                r(e.derived["Vn"])
            _load(e.derived["alphas"], alphas)
        f = e.fns
        loop = (functools.partial(_graphed_loop, entry=e) if _graph
                else _converging_loop)
        with _progress(verbose, max_iter) as report:
            (W, H, Z), k, conv = loop(f.one_iter, f.loss_of, (W, H, Z), tol,
                                      max_iter, report, extra_of=f.extra_of)
        norm = e.derived["norm"].clone()
        return W, H, Z, (k * 10 - 1 if conv else max_iter - 1), norm

    @torch.no_grad()
    def fit(V, W, H, Z, W_alpha, H_alpha, Z_alpha):
        alphas = (W_alpha, H_alpha, Z_alpha)
        return _CACHE.run(chunk, (V,), (V, W, H, Z) + alphas, _graph,
                          lambda e: run(e, V, W, H, Z, alphas))

    return fit


@functools.lru_cache(maxsize=None)
def get_batched_plca_fit(
    recon3: Callable,
    tol: float,
    max_iter: int,
    update_W: bool,
    update_H: bool,
    update_Z: bool,
    W_alpha_active: bool,
    H_alpha_active: bool,
    Z_alpha_active: bool,
    _graph: bool = True,
):
    """Batched EM: ``fit(V (B, ...), W (B, ...), H (B, ...), Z (B, R),
    W_alpha, H_alpha, Z_alpha) -> (W, H, Z, n_iter (B,), norm (B,))``, each
    problem with its own early stop and the raw-index ``n_iter``.  ``recon3``
    is one problem's reconstruction; the E-step differentiates
    ``torch.func.vmap(recon3)`` over the whole batch (the problems share no
    parameters), the M-step is ``vmap``-ed, the priors are shared.  The
    chunks run as :func:`get_batched_dense_fit`'s do (``_graph``
    likewise); an entry keeps ``norm``, ``Vn`` (recomputed from V at every
    fit) and the priors."""
    from torch.func import vmap

    recon3_b = vmap(recon3)
    m_step = vmap(
        lambda w, h, z, gH, gW, gZ, Wa, Ha, Za: _plca_m_step(
            update_W, update_H, update_Z, W_alpha_active, H_alpha_active,
            Z_alpha_active, w, h, z, gH, gW, gZ, Wa, Ha, Za),
        in_dims=(0,) * 6 + (None,) * 3)
    loss_b = vmap(lambda vn, w, h, z, nrm: torch.sqrt(
        2.0 * kl_div(recon3(h, w, z) * nrm, vn * nrm)))
    chunk = ("batched_plca", recon3, tol, update_W, update_H, update_Z,
             W_alpha_active, H_alpha_active, Z_alpha_active)

    def derive(e, V):
        """Each problem's ``norm`` and ``Vn`` into the entry's tensors."""
        d = e.derived
        _keep(d, "norm", V.reshape(V.shape[0], -1).sum(1))
        lanes = d["norm"].reshape((-1,) + (1,) * (V.ndim - 1))
        if "Vn" in d:
            torch.div(V, lanes, out=d["Vn"])
        else:
            d["Vn"] = V / lanes

    def build(e, V, alphas):
        d = e.derived
        derive(e, V)
        d["alphas"] = tuple(a.clone() for a in alphas)
        norm, Vn, (W_alpha, H_alpha, Z_alpha) = d["norm"], d["Vn"], \
            d["alphas"]

        def one_iter(state):
            w, h, z = state
            gH, gW, gZ = _plca_e_step(recon3_b, Vn, w, h, z)
            return m_step(w, h, z, gH, gW, gZ, W_alpha, H_alpha, Z_alpha)

        return SimpleNamespace(one_iter=one_iter,
                               loss_of=lambda s: loss_b(Vn, *s, norm))

    def run(e, V, W, H, Z, alphas):
        if e.fns is None:
            e.fns = build(e, V, alphas)
        else:
            derive(e, V)
            _load(e.derived["alphas"], alphas)
        f = e.fns
        loop = (functools.partial(_graphed_batched_loop, entry=e) if _graph
                else _batched_loop)
        (W, H, Z), conv, k = loop(f.one_iter, f.loss_of, (W, H, Z), tol,
                                  max_iter)
        norm = e.derived["norm"].clone()
        return W, H, Z, torch.where(conv, k * 10 - 1, max_iter - 1), norm

    @torch.no_grad()
    def fit(V, W, H, Z, W_alpha, H_alpha, Z_alpha):
        alphas = (W_alpha, H_alpha, Z_alpha)
        return _CACHE.run(chunk, (V,), (V, W, H, Z) + alphas, _graph,
                          lambda e: run(e, V, W, H, Z, alphas))

    return fit


_FACTORIES = (get_dense_fit, get_batched_dense_fit, get_sparse_fit,
              get_hoyer_fit, get_batched_hoyer_fit, get_plca_fit,
              get_batched_plca_fit)

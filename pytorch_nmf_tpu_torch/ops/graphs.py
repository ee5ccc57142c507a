r"""In-place workloads as CUDA graphs on the card, called directly on the CPU
(the trainers' compiled steps, :mod:`..trainer`, and the fits' chunk loop
and 10-iteration chunk, :mod:`.solver`).

A workload ``fn()`` reads and writes tensors at fixed addresses, so a graph
of it, replayed, does what calling it again would.  :class:`_Graphs` holds
one graph per workload, each in its own private memory pool, which goes
with the instance.  Two ways to warm up and capture on the card:

* **scratch warm-ups** (``state`` given; the trainers): at construction
  every workload runs eagerly on a side stream (the one-time host work:
  kernel builds, the deconv tuner's timings, lazy imports) and again with
  synchronizing operations raising, ``state`` (the tensors they update) is
  restored after each run, and each is captured.  The kernels' launch
  counters tick at warm-up and capture, not at replay (a device loop's
  body too).
* **own warm-ups** (``state=None``; the fits): the workload's own first two
  calls are the warm-ups, real work that is kept: the first runs it eagerly
  on the current stream, the second again with synchronizing operations
  raising; then :meth:`_Graphs.capture` (or else the third call) captures
  it on the side stream, and the third and every later call replays it
  (:meth:`_Graphs.warming` tells whether the next call is a warm-up; on
  the CPU the same calls count).  ``capture(k, seen=True)`` captures
  before any warm-up (a configuration the process has warmed up and
  checked already).  The instance may be kept and called again by later
  fits (the fits' cache, :mod:`.solver`): its graphs replay from their
  first call.  The kernels'
  launch counters count executions: each counter's delta over the capture
  is taken back and added again at every replay.

A workload that reads the card's values on the host (``.item()``,
``float()``, ``bool()`` of a tensor, a copy from or to host memory), or
does something else a graph cannot hold, raises a ``RuntimeError`` with
the caller's message.  Capture uses ``CUDAGraph.capture_begin`` on the
side stream directly: it neither synchronizes the card nor empties the
allocator's cache, as ``torch.cuda.graph`` would.  A capture that runs out
of card memory ends the stream capture, frees the half-made graph, its
pool and the device loops' pool, and raises ``torch.cuda.OutOfMemoryError``
(the sparse fit's retry on another tier, :mod:`..models.nmf`, then finds
the memory back).  ``pool_bytes`` is what the captures added to the card's
reserved memory: the graphs' private pools.

**Device loops** (``conditional=True``; the fits' chunk loop, the Hoyer
fits' and ``SparsityProj``'s line searches):
:func:`_device_while` runs a body while a 0-d bool tensor, which the body
updates, is true.  Eagerly it reads the flag on the host before each run
(the only reads it makes, allowed under the strict warm-up).  Under
capture the body becomes a CUDA-graph WHILE node (``csrc/graph_cond.cu``)
that the card runs as often as the flag says at each replay: it is
captured once, on a stream of the instance's own for its nesting depth,
its allocations in a memory pool of the instance's own (a backward inside
it runs on the capturing thread, whose allocations the pool takes), and
it adds one to its depth's count on the card each run.  A body may hold
device loops of its own (the Hoyer fits' chunk loop holds the line
searches' WHILE nodes), up to :data:`_MAX_DEPTH` deep; the bodies at one
depth launch the same kernels.  A launch inside a body ticks its counter
once, at capture; :meth:`_Graphs.capture` takes that back with the rest,
and each depth's launches an execution (its own, less those of the
bodies nested in it) are added from its count on the card when a counter
that allows it (an attribute of a :class:`_Counted`) is next read, one
host read a finished fit (:func:`_settle`, after :meth:`_Graphs.flush`),
never on the fit's path.
"""

import contextlib
import ctypes
import functools
import threading
import time
import warnings

import torch

__all__ = []


class _Counted:
    """``fn`` with counts kept as attributes (``counts``: their names and
    starting values).  Those named in ``on_card`` may also be counted on
    the card, by the conditional bodies of replayed graphs: reading or
    setting one first adds in what finished fits counted there
    (:func:`_settle`).  The wrapped code adds to a count with
    :meth:`add`, which reads nothing on the card."""

    def __init__(self, fn, on_card=(), **counts):
        object.__setattr__(self, "_on_card", frozenset(on_card))
        vars(self).update(counts)
        functools.update_wrapper(self, fn)

    def __call__(self, *args, **kwargs):
        return self.__wrapped__(*args, **kwargs)

    def __getattribute__(self, name):
        if name in object.__getattribute__(self, "_on_card"):
            _settle()
        return object.__getattribute__(self, name)

    def __setattr__(self, name, value):
        if name in self._on_card:
            _settle()
        object.__setattr__(self, name, value)

    def add(self, name: str, n: int = 1):
        vars(self)[name] += n


# counts kept in a dict that a device loop's body may move, counted on the
# card as the wrappers' on-card counts are: ``(dict, key)``, registered by
# their module (the collectives' calls and bytes, ``parallel.comm``)
_REGISTERED = []


def _count_on_card(owner: dict, key: str):
    """Registers ``owner[key]`` as a count that counts executions."""
    if not any(o is owner and k == key for o, k in _REGISTERED):
        _REGISTERED.append((owner, key))


def _kernel_counters():
    """``(owner, attribute)`` of every count that counts executions: each
    kernel wrapper's launches, the line searches' attempts and rounds, the
    sparse ELL tier's reductions, then the registered ``(dict, key)``
    counts (:func:`_count_on_card`)."""
    from . import fused_deconv, fused_mu, projection, solver, sparse

    return ((fused_mu.fused_contractions, "launches"),
            (fused_mu.fused_contractions, "launches_bf16"),
            (fused_mu.fused_beta_loss, "launches"),
            (fused_mu.fused_beta_loss, "launches_bf16"),
            (fused_deconv.hgrad, "launches"),
            (fused_deconv.hgrad, "launches_gemm"),
            (fused_deconv.hgrad, "launches_windowed"),
            (fused_deconv.wgrad, "launches"),
            (projection.proj_rows, "launches"),
            (solver._backtrack_project, "attempts"),
            (solver._batched_backtrack_project, "rounds"),
            (sparse.ell_neg_grad, "reductions")) + tuple(_REGISTERED)


def _slots(owner):
    return owner if isinstance(owner, dict) else vars(owner)


def _read_counters():
    """The counts as they stand on the host (nothing settled)."""
    return [_slots(fn)[attr] for fn, attr in _kernel_counters()]


def _add_counters(delta):
    for (fn, attr), d in zip(_kernel_counters(), delta):
        _slots(fn)[attr] += d


# what the conditional bodies of finished fits' replays counted on the
# card: (pinned host copy of one depth's count, its event, the counts'
# increase an execution at that depth), added in by the next read of a
# count that allows it; past
# _PENDING_MAX, a fit's end adds in those whose copies are done
_PENDING = []
_PENDING_LOCK = threading.Lock()
_PENDING_MAX = 64


def _settle(done_only: bool = False):
    """Adds every finished fit's bodies' executions into the counts: one
    host read of each fit's count, waiting for its copy (``done_only``:
    only the copies done already, waiting for none)."""
    with _PENDING_LOCK:
        if done_only:
            ready = [p[1].query() for p in _PENDING]
            pending = [p for p, r in zip(_PENDING, ready) if r]
            _PENDING[:] = [p for p, r in zip(_PENDING, ready) if not r]
        else:
            pending = list(_PENDING)
            _PENDING.clear()
    for count, done, delta in pending:
        done.synchronize()
        _add_counters([int(count) * d for d in delta])


def _host_read(flag: torch.Tensor) -> bool:
    """``bool(flag)``, allowed where the sync debug mode raises."""
    if not flag.is_cuda or torch.cuda.get_sync_debug_mode() == 0:
        return bool(flag)
    mode = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():  # "a prototype feature"
        warnings.simplefilter("ignore", UserWarning)
        torch.cuda.set_sync_debug_mode(0)
        try:
            return bool(flag)
        finally:
            torch.cuda.set_sync_debug_mode(mode)


# the instance whose workload is being captured
_CAPTURING = threading.local()


def _device_while(flag: torch.Tensor, body) -> int:
    """Runs ``body()`` while the 0-d bool tensor ``flag`` is true; ``body``
    updates ``flag`` in place.  Eagerly (on the CPU, or a CUDA workload not
    being captured) it reads ``flag`` on the host before each run and
    returns the number of reads.  Inside the capture of a :class:`_Graphs`
    made with ``conditional=True``, ``body``'s work becomes a WHILE node
    that the card runs from ``flag`` at each replay, and it returns 0.
    ``body`` updates tensors made before it in place; what it allocates
    lives in the instance's bodies' pool.  ``body`` may run device loops
    of its own (nested WHILE nodes, up to :data:`_MAX_DEPTH` deep).  Every
    body at one nesting depth of a workload must launch the same kernels,
    and only kernels whose counts allow counting on the card."""
    if not (flag.is_cuda and torch.cuda.is_current_stream_capturing()):
        reads = 1
        while _host_read(flag):
            body()
            reads += 1
        return reads
    g = getattr(_CAPTURING, "graphs", None)
    if g is None or g.cond is None:
        raise RuntimeError(
            "a device loop is captured only in a workload of a _Graphs made "
            "with conditional=True")
    g._capture_while(flag, body)
    return 0


class _strict_sync:
    """Synchronizing operations raise ``RuntimeError`` inside (the CUDA
    sync debug mode ``"error"``)."""

    def __enter__(self):
        self.mode = torch.cuda.get_sync_debug_mode()
        with warnings.catch_warnings():  # "a prototype feature"
            warnings.simplefilter("ignore", UserWarning)
            torch.cuda.set_sync_debug_mode("error")

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(self.mode)


# the deepest nesting of device loops a workload may capture (the Hoyer
# fits: the chunk loop and its line searches)
_MAX_DEPTH = 2


class _Bodies:
    """What one instance's device loops share on ``device``: the library
    of ``csrc/graph_cond.cu``, a stream of their own for each nesting depth
    (a body being captured on one opens the next depth's WHILE nodes on
    the next), a memory pool for what they allocate, the count of body
    executions on the card for each depth and the counts' increase an
    execution at each depth (``deltas``, from the first body captured
    there; a body's own launches, less its nested bodies')."""

    def __init__(self, device: torch.device):
        from ._build import load_library

        for name in ("MemPool", "use_mem_pool", "ExternalStream"):
            if not hasattr(torch.cuda, name):
                raise RuntimeError(f"device loops need torch.cuda."
                                   f"{name}, which this PyTorch lacks")
        self.lib = load_library("graph_cond")
        self.raws = []
        with torch.cuda.device(device):
            for _ in range(_MAX_DEPTH):
                raw = ctypes.c_void_p()
                _check(self.lib.pnt_stream_create(ctypes.byref(raw)),
                       "creating the bodies' stream")
                self.raws.append(raw.value)
        self.streams = [torch.cuda.ExternalStream(r, device=device)
                        for r in self.raws]
        self.pool = torch.cuda.MemPool()
        self.count = torch.zeros(_MAX_DEPTH, dtype=torch.int64, device=device)
        self.deltas = [None] * _MAX_DEPTH
        self.depth = 0

    def take(self, depth: int, delta):
        """Checks the increase an execution of a body captured at
        ``depth``: the first body's there, and only counts that allow
        counting on the card."""
        if self.deltas[depth] is None:
            for (fn, attr), d in zip(_kernel_counters(), delta):
                if d and not isinstance(fn, dict) and \
                        attr not in getattr(fn, "_on_card", ()):
                    raise RuntimeError(
                        f"a device loop's body moved {attr} of "
                        f"{getattr(fn, '__name__', fn)}, which counts only on "
                        f"the host")
            self.deltas[depth] = delta
        elif delta != self.deltas[depth]:
            raise RuntimeError("the device loops' bodies at one depth of a "
                               "workload launch different kernels")

    def flush(self):
        """Hands the bodies' executions so far to :func:`_settle` (a copy to
        pinned host memory, no wait) and sets the counts on the card back
        to 0, in stream order."""
        used = [d for d, x in enumerate(self.deltas) if x is not None]
        if used:
            host = torch.empty(_MAX_DEPTH, dtype=torch.int64, pin_memory=True)
            host.copy_(self.count, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            self.count.zero_()
            with _PENDING_LOCK:
                _PENDING.extend((host[d], done, self.deltas[d]) for d in used)
                full = len(_PENDING) > _PENDING_MAX
            if full:  # many fits and no read of a count: keep the list short
                _settle(done_only=True)

    def close(self):
        """:meth:`flush`, then frees the streams; call it once the graphs
        are gone."""
        self.flush()
        self.streams = self.pool = self.count = None
        for raw in self.raws:
            _check(self.lib.pnt_stream_destroy(raw),
                   "freeing the bodies' stream")
        self.raws = []


def _check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"device loop: {what} failed: CUDA error {err}")


class _Graphs:
    """Workloads that update tensors in place, ``fns[k]()``, as CUDA graphs
    on a CUDA device and called directly on the CPU (module docstring).
    ``replays`` counts the graph replays of every instance, ``captures``
    their captures and ``capture_s`` the host seconds those took.  With
    ``conditional`` a workload may hold :func:`_device_while`;
    :meth:`close` (or dropping the instance) then frees its graphs and the
    loops' bodies."""

    replays = 0
    captures = 0
    capture_s = 0.0

    def __init__(self, fns, state, device: torch.device, message: str,
                 conditional: bool = False):
        self.fns = fns
        self.message = message
        self.graphs = self.deltas = self.cond = None
        self.conditional = conditional
        # the launches captured in device loops' bodies: at depth 0
        # (``_top``), and inside each body being captured (``_nested``)
        self._top, self._nested = [], []
        self.pool_bytes = 0
        self.runs = [0] * len(fns)
        if device.type not in ("cuda", "cpu"):
            raise ValueError(f"no compiled step for device {device}")
        if device.type != "cuda":
            return
        self.device = device
        # from the high-priority pool: ProcessGroupNCCL takes its streams
        # from the default-priority one, and a capture on a communicator's
        # own stream crashes at capture_end
        self.stream = torch.cuda.Stream(device, priority=-1)
        if state is None:  # own warm-ups: the first calls run the work
            self.graphs = [None] * len(fns)
            self.deltas = [None] * len(fns)
        elif state:  # no state: nothing to run
            self._warm_up_on_scratch(state)
            if conditional:
                self.cond = _Bodies(device)
            self.graphs = [self._capture(fn) for fn in fns]

    def _run(self, fn, strict: bool):
        """``fn()``; with ``strict``, synchronizing operations raise."""
        if not strict:
            fn()
            return
        try:
            with _strict_sync():
                fn()
        except RuntimeError as e:
            raise RuntimeError(self.message) from e

    def _on_side_stream(self, fn, strict: bool):
        """:meth:`_run` on the side stream, ordered after and before the
        current stream's work."""
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        try:
            with torch.cuda.stream(self.stream):
                self._run(fn, strict)
        finally:
            current.wait_stream(self.stream)

    def _warm_up_on_scratch(self, state):
        saved = [t.detach().clone() for t in state]

        @torch.no_grad()
        def restore():
            for t, v in zip(state, saved):
                t.copy_(v)

        def all_fns():
            for fn in self.fns:
                fn()

        try:
            self._on_side_stream(all_fns, strict=False)
            restore()
            self._on_side_stream(all_fns, strict=True)
        finally:
            self._on_side_stream(restore, strict=False)

    def _capture(self, fn):
        """A graph of ``fn()`` in a private pool; runs nothing.  cuBLAS
        keeps a workspace per handle and stream: the workspaces are dropped
        before the capture, so the graph's GEMMs take one in its own pool
        and share none with eager work, and after it, so the workspace
        map does not hold that pool (and its memory) past the graph.  Out
        of card memory, the capture ends, the half-made graph and the
        loops' pool go, and ``torch.cuda.OutOfMemoryError`` is raised
        afresh (the frames that held the capture's tensors are gone)."""
        t0 = time.perf_counter()
        self._top, self._nested = [0] * len(_read_counters()), []
        reserved = torch.cuda.memory_reserved(self.device)
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        g = torch.cuda.CUDAGraph()
        torch._C._cuda_clearCublasWorkspaces()
        _CAPTURING.graphs = self
        oom = None
        try:
            with torch.cuda.stream(self.stream):
                g.capture_begin()
                try:
                    fn()
                except BaseException:
                    with contextlib.suppress(RuntimeError):
                        g.capture_end()
                    raise
                g.capture_end()
        except torch.cuda.OutOfMemoryError as e:
            oom = str(e)
        except RuntimeError as e:
            raise RuntimeError(self.message) from e
        finally:
            _CAPTURING.graphs = None
            torch._C._cuda_clearCublasWorkspaces()
        if oom is not None:
            g.reset()
            del g
            self.close()
            raise torch.cuda.OutOfMemoryError(oom)
        self.pool_bytes += max(
            torch.cuda.memory_reserved(self.device) - reserved, 0)
        _Graphs.captures += 1
        _Graphs.capture_s += time.perf_counter() - t0
        return g

    def _capture_while(self, flag, body):
        """:func:`_device_while` under this instance's capture: ``body`` as
        a WHILE node on ``flag``, captured on its depth's stream into the
        bodies' pool, adding one to its depth's count each run.  The
        launches it captured go to its enclosing body's nested total (or
        the capture's, at depth 0)."""
        if flag.dtype != torch.bool or flag.dim() != 0:
            raise ValueError("a device loop takes a 0-d bool tensor")
        c = self.cond
        depth = c.depth
        if depth == _MAX_DEPTH:
            raise RuntimeError(f"device loops nest at most {_MAX_DEPTH} deep")
        stream = torch.cuda.current_stream(self.device)
        before = _read_counters()
        handle = ctypes.c_ulonglong()
        _check(c.lib.pnt_while_begin(stream.cuda_stream, flag.data_ptr(),
                                     c.raws[depth], ctypes.byref(handle)),
               "opening a WHILE node")
        c.depth += 1
        self._nested.append([0] * len(before))
        try:
            with contextlib.ExitStack() as inside:
                inside.enter_context(torch.cuda.stream(c.streams[depth]))
                if depth == 0:
                    # a backward inside the body runs on this thread, whose
                    # allocations the bodies' pool takes (not autograd's
                    # device threads', which it would not); nested bodies
                    # are inside both already
                    inside.enter_context(torch.cuda.use_mem_pool(c.pool))
                    inside.enter_context(
                        torch.autograd.set_multithreading_enabled(False))
                body()
                c.count[depth].add_(1)
        finally:
            nested = self._nested.pop()
            c.depth -= 1
            _check(c.lib.pnt_while_end(c.raws[depth], handle, flag.data_ptr()),
                   "closing a WHILE node")
        total = [a - b for a, b in zip(_read_counters(), before)]
        c.take(depth, [t - n for t, n in zip(total, nested)])
        outer = self._nested[-1] if self._nested else self._top
        for i, t in enumerate(total):
            outer[i] += t

    def capture(self, k: int = 0, seen: bool = False):
        """Own warm-ups: captures ``fns[k]`` after its two warm-up runs, if
        not yet done (on the CPU it only counts the warm-ups as done).
        Called right after the second run is enqueued, the capture's host
        time overlaps that run on the card.  ``seen``: the process has
        warmed up and checked this workload's configuration already (an
        earlier instance), so the capture comes before any run."""
        if seen:
            self.runs[k] = max(self.runs[k], 2)
        if self.deltas is None or self.graphs[k] is not None:
            return
        if self.runs[k] < 2:
            raise RuntimeError("a workload is captured after two warm-ups")
        if self.conditional and self.cond is None:
            self.cond = _Bodies(self.device)
        before = _read_counters()
        self.graphs[k] = self._capture(self.fns[k])
        captured = [a - b for a, b in zip(_read_counters(), before)]
        # the bodies' launches are counted on the card, the rest at replay
        self.deltas[k] = [d - t for d, t in zip(captured, self._top)]
        _add_counters([-d for d in captured])

    def rewind(self, runs: int, k: int = 0):
        """Own warm-ups: drops the graphs (and the loops' bodies) and sets
        ``fns[k]``'s warm-up runs to ``runs``: with 0 or 1 the next calls
        warm up, with 2 the next call captures.  The ranks of a sharded fit
        take one path so (:func:`.solver._agree_path`)."""
        self.close()
        self.runs[k] = runs

    def warming(self, k: int = 0) -> bool:
        """Own warm-ups: the next call of ``fns[k]`` is one of its two
        warm-up runs (on the CPU, where every call runs directly, the same
        calls count)."""
        if self.graphs is None:
            return self.runs[k] < 2
        return self.deltas is not None and self.graphs[k] is None \
            and self.runs[k] < 2

    def ready(self, k: int = 0) -> bool:
        """Whether ``fns[k]`` has had its warm-ups (and on the card its
        capture): the next call replays it."""
        if self.graphs is not None and self.deltas is not None:
            return self.graphs[k] is not None
        return self.runs[k] >= 2

    def __call__(self, k: int = 0):
        if self.graphs is None:
            self.runs[k] += 1
            self.fns[k]()
            return
        if self.deltas is not None and self.runs[k] < 2:  # own warm-ups
            self.runs[k] += 1
            self._run(self.fns[k], strict=self.runs[k] == 2)
            return
        self.capture(k)
        self.graphs[k].replay()
        _Graphs.replays += 1
        if self.deltas is not None:
            _add_counters(self.deltas[k])

    def flush(self):
        """Hands the device loops' executions so far to the counts (a
        kept instance's fit ends)."""
        if self.cond is not None:
            self.cond.flush()

    def close(self):
        """Frees the graphs, then the loops' pool and stream.  Scratch
        warm-ups count launches at capture, so their bodies' runs on the
        card are not added."""
        if self.deltas is None:
            self.graphs = None
        else:  # own warm-ups: a later call captures again
            self.graphs = [None] * len(self.graphs)
        c, self.cond = self.cond, None
        if c is not None:
            if self.deltas is None:
                c.deltas = [None] * _MAX_DEPTH
            c.close()

    def __del__(self):
        if self.cond is not None:  # a dropped instance frees its loops too
            self.close()

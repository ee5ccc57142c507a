r"""In-place workloads as CUDA graphs on the card, called directly on the CPU
(the trainers' compiled steps, :mod:`..trainer`, and the fits' 10-iteration
chunk, :mod:`.solver`).

A workload ``fn()`` reads and writes tensors at fixed addresses, so a graph
of it, replayed, does what calling it again would.  :class:`_Graphs` holds
one graph per workload, each in its own private memory pool, which goes
with the instance.  Two ways to warm up and capture on the card:

* **scratch warm-ups** (``state`` given; the trainers): at construction
  every workload runs eagerly on a side stream (the one-time host work:
  kernel builds, the deconv tuner's timings, lazy imports) and again with
  synchronizing operations raising, ``state`` (the tensors they update) is
  restored after each run, and each is captured.  The kernels' launch
  counters tick at warm-up and capture, not at replay.
* **own warm-ups** (``state=None``; the fits): the workload's own first two
  calls are the warm-ups, real work that is kept: the first runs it eagerly
  on the current stream, the second again with synchronizing operations
  raising; then :meth:`_Graphs.capture` (or else the third call) captures
  it on the side stream, and the third and every later call replays it.
  The kernels' launch counters count executions: each counter's delta over
  the capture is taken back and added again at every replay.

A workload that reads the card's values on the host (``.item()``,
``float()``, ``bool()`` of a tensor, a copy from or to host memory), or
does something else a graph cannot hold, raises a ``RuntimeError`` with
the caller's message.  Capture uses ``CUDAGraph.capture_begin`` on the
side stream directly: it neither synchronizes the card nor empties the
allocator's cache, as ``torch.cuda.graph`` would.
"""

import time
import warnings

import torch

__all__ = []


def _kernel_counters():
    """``(function, attribute)`` of every kernel wrapper's launch counter."""
    from . import fused_deconv, fused_mu, projection

    return ((fused_mu.fused_contractions, "launches"),
            (fused_mu.fused_contractions, "launches_bf16"),
            (fused_mu.fused_beta_loss, "launches"),
            (fused_mu.fused_beta_loss, "launches_bf16"),
            (fused_deconv.hgrad, "launches"),
            (fused_deconv.hgrad, "launches_gemm"),
            (fused_deconv.wgrad, "launches"),
            (projection.proj_rows, "launches"))


def _read_counters():
    return [getattr(fn, attr) for fn, attr in _kernel_counters()]


def _add_counters(delta):
    for (fn, attr), d in zip(_kernel_counters(), delta):
        setattr(fn, attr, getattr(fn, attr) + d)


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


class _Graphs:
    """Workloads that update tensors in place, ``fns[k]()``, as CUDA graphs
    on a CUDA device and called directly on the CPU (module docstring).
    ``replays`` counts the graph replays of every instance and
    ``capture_s`` the host seconds their captures took."""

    replays = 0
    capture_s = 0.0

    def __init__(self, fns, state, device: torch.device, message: str):
        self.fns = fns
        self.message = message
        self.graphs = self.deltas = None
        if device.type not in ("cuda", "cpu"):
            raise ValueError(f"no compiled step for device {device}")
        if device.type != "cuda":
            return
        self.device = device
        self.stream = torch.cuda.Stream(device)
        if state is None:  # own warm-ups: the first calls run the work
            self.graphs = [None] * len(fns)
            self.runs = [0] * len(fns)
            self.deltas = [None] * len(fns)
        elif state:  # no state: nothing to run
            self._warm_up_on_scratch(state)
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
        map does not hold that pool (and its memory) past the graph."""
        t0 = time.perf_counter()
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        g = torch.cuda.CUDAGraph()
        torch._C._cuda_clearCublasWorkspaces()
        try:
            with torch.cuda.stream(self.stream):
                g.capture_begin()
                try:
                    fn()
                finally:
                    g.capture_end()
        except RuntimeError as e:
            raise RuntimeError(self.message) from e
        finally:
            torch._C._cuda_clearCublasWorkspaces()
        _Graphs.capture_s += time.perf_counter() - t0
        return g

    def capture(self, k: int = 0):
        """Own warm-ups: captures ``fns[k]`` after its two warm-up runs, if
        not yet done (a no-op on the CPU).  Called right after the second
        run is enqueued, the capture's host time overlaps that run on the
        card."""
        if self.deltas is None or self.graphs[k] is not None:
            return
        if self.runs[k] < 2:
            raise RuntimeError("a workload is captured after two warm-ups")
        before = _read_counters()
        self.graphs[k] = self._capture(self.fns[k])
        after = _read_counters()
        self.deltas[k] = [a - b for a, b in zip(after, before)]
        _add_counters([-d for d in self.deltas[k]])

    def __call__(self, k: int = 0):
        if self.graphs is None:
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

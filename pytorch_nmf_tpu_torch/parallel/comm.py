"""The collectives of the sharded fits: the port's lowering of JAX's
``lax.psum`` and ``lax.ppermute`` onto ``torch.distributed``.

* :meth:`Comm.all_reduce` sums tensors in place over one mesh dimension
  (``psum``); the fits call it on the raw numerators, before any clamp.
* :meth:`Comm.shift_right` / :meth:`Comm.shift_left` move a block one rank
  along the dimension, as one ``batch_isend_irecv`` (the halo ring's
  ``ppermute``): a rank with no neighbour on the sending side receives
  zeros.
* :meth:`Comm.all_gather` collects every rank's block, once at a fit's
  end, where the halo fits re-split H as DTensor splits it.
* :meth:`Comm.broadcast_object` gives every rank rank 0's Python object
  (the halo fits' per-shard mode, which rank 0 alone resolves).

The transport is the process group's backend, named by
:attr:`Comm.transport`:

* ``"nccl"``: card tensors go to NCCL as they are;
* ``"gloo"``: CPU tensors go to gloo as they are;
* ``"gloo-staged"``: gloo on card tensors (several ranks sharing one card,
  where NCCL refuses them).  gloo's ``all_reduce`` and ``all_gather`` take
  card tensors (gloo copies them to the host itself); its send and receive
  do not (the TCP transport writes from the device pointer and fails with
  "Bad address": ``chip_tools/gloo_cuda_probe.py`` on an H100, torch
  2.11).  So the shifts copy the block into a pinned host buffer, send and
  receive host copies, and copy the received block back.  Nor does gloo
  take card tensors in ``all_gather_into_tensor``, which
  ``DTensor.full_tensor`` runs: gather a card DTensor of such a mesh
  through a ``"cpu"`` mesh (``DTensor.from_local`` of its local block
  moved to the host).

:data:`stats` counts the collectives, their bytes and (while
``stats.timed`` is set) their milliseconds, per kind: ``all_reduce``,
``halo`` (the shifts) and ``gather``.  ``chip_smoke.py`` reads and resets it.
"""

import functools
import time

import torch
import torch.distributed as dist

__all__ = ["Comm", "CommStats", "stats", "comm_for"]


class CommStats:
    """Per kind (``all_reduce``, ``halo``, ``gather``): calls, bytes sent or
    reduced by this rank, and milliseconds when :attr:`timed` (card collectives by
    CUDA events, read at :meth:`summary`; host ones by the host clock)."""

    KINDS = ("all_reduce", "halo", "gather")

    def __init__(self):
        self.timed = False
        self.reset()

    def reset(self):
        self.calls = dict.fromkeys(self.KINDS, 0)
        self.bytes = dict.fromkeys(self.KINDS, 0)
        self._ms = dict.fromkeys(self.KINDS, 0.0)
        self._events = {k: [] for k in self.KINDS}

    def summary(self) -> dict:
        """``{kind: {"calls", "bytes", "ms"}}``; ``ms`` is ``None`` unless
        timed.  Synchronizes the card when events were recorded."""
        out = {}
        for kind in self.KINDS:
            ms = self._ms[kind]
            if self._events[kind]:
                torch.cuda.synchronize()
                ms += sum(a.elapsed_time(b) for a, b in self._events[kind])
            out[kind] = {"calls": self.calls[kind], "bytes": self.bytes[kind],
                         "ms": ms if self.timed else None}
        return out


stats = CommStats()


class _Timer:
    """Times one collective into :data:`stats` when it is timed."""

    def __init__(self, kind: str, on_card: bool):
        self.kind, self.on_card = kind, on_card and stats.timed

    def __enter__(self):
        if self.on_card:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()
        elif stats.timed:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.on_card:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            stats._events[self.kind].append((self.start, end))
        elif stats.timed:
            stats._ms[self.kind] += 1e3 * (time.perf_counter() - self.t0)
        return False


class Comm:
    """One mesh dimension's process group, its rank and size along the
    dimension, and its transport (see the module docstring)."""

    def __init__(self, mesh, axis: str):
        if mesh.get_coordinate() is None:
            raise ValueError("this rank is not part of the mesh")
        self.group = mesh.get_group(axis)
        self.size = mesh.size(mesh.mesh_dim_names.index(axis))
        self.rank = mesh.get_local_rank(axis)
        self.peers = dist.get_process_group_ranks(self.group)
        backend = str(dist.get_backend(self.group))
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if mesh.device_type == "cuda" else torch.device("cpu"))
        if backend == "gloo" and self.device.type == "cuda":
            self.transport = "gloo-staged"
        else:
            self.transport = backend
        self._pinned = {}

    def _host(self, x, slot: int):
        """A pinned host buffer shaped like ``x``, kept for the next call
        (pinned allocations are slow)."""
        buf = self._pinned.get(slot)
        if buf is None or buf.numel() < x.numel():
            buf = torch.empty(x.numel(), dtype=x.dtype, pin_memory=True)
            self._pinned[slot] = buf
        return buf[:x.numel()].view_as(x)

    def all_reduce(self, *tensors) -> None:
        """Sum each tensor (``None`` skipped) over the dimension, in place,
        in one round.  A dimension of one rank still calls the backend, so
        a one-rank NCCL group runs NCCL."""
        tensors = [t for t in tensors if t is not None]
        if not tensors:
            return
        stats.calls["all_reduce"] += 1
        stats.bytes["all_reduce"] += sum(t.numel() * t.element_size()
                                         for t in tensors)
        with _Timer("all_reduce", self.device.type == "cuda"):
            works = [dist.all_reduce(t, group=self.group, async_op=True)
                     for t in tensors]
            for w in works:
                w.wait()

    def broadcast_object(self, obj):
        """Rank 0's ``obj`` (picklable) on every rank of the dimension."""
        if self.size == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(
            box, src=self.peers[0], group=self.group,
            device=self.device if self.transport == "nccl" else None)
        return box[0]

    def all_gather(self, x) -> list:
        """Every rank's ``x`` (one shape on all ranks), in rank order."""
        x = x.contiguous()
        stats.calls["gather"] += 1
        stats.bytes["gather"] += x.numel() * x.element_size()
        with _Timer("gather", self.device.type == "cuda"):
            parts = [torch.empty_like(x) for _ in range(self.size)]
            dist.all_gather(parts, x, group=self.group)
            return parts

    def _shift(self, x, step: int):
        """Send ``x`` to the rank ``step`` along and return what the rank
        ``-step`` along sent (zeros where there is none)."""
        x = x.contiguous()
        recv = torch.zeros_like(x)
        if self.size == 1:
            return recv
        dst, src = self.rank + step, self.rank - step
        has_dst, has_src = 0 <= dst < self.size, 0 <= src < self.size
        stats.calls["halo"] += 1
        stats.bytes["halo"] += has_dst * x.numel() * x.element_size()
        staged = self.transport == "gloo-staged"
        with _Timer("halo", self.device.type == "cuda" and not staged):
            if staged:
                send_h, recv_h = self._host(x, 0), self._host(x, 1)
                if has_dst:
                    send_h.copy_(x, non_blocking=True)
                # also orders the host's writes into recv_h after the last
                # call's copy out of it
                torch.cuda.current_stream(self.device).synchronize()
                s, r = send_h, recv_h
            else:
                s, r = x, recv
            ops = []
            if has_dst:
                ops.append(dist.P2POp(dist.isend, s, self.peers[dst],
                                      self.group))
            if has_src:
                ops.append(dist.P2POp(dist.irecv, r, self.peers[src],
                                      self.group))
            if ops:
                for w in dist.batch_isend_irecv(ops):
                    w.wait()
            if staged and has_src:
                recv.copy_(recv_h, non_blocking=True)
        return recv

    def shift_right(self, x):
        """``x`` to the next rank; the previous rank's block back (zeros on
        rank 0)."""
        return self._shift(x, 1)

    def shift_left(self, x):
        """``x`` to the previous rank; the next rank's block back (zeros on
        the last rank)."""
        return self._shift(x, -1)


@functools.lru_cache(maxsize=None)
def comm_for(mesh, axis: str) -> Comm:
    """The :class:`Comm` of ``mesh``'s dimension ``axis`` (one per pair, so
    its pinned buffers serve every call)."""
    return Comm(mesh, axis)

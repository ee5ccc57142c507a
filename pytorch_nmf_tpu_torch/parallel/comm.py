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

A collective or a shift inside a CUDA-graph capture (the sharded and halo
fits' chunk loop, ``ops/solver.py``) is recorded, not run: over NCCL the
capture holds its kernels (a shift's send and receive too: one
``batch_isend_irecv`` in a WHILE node's body replays bit for bit across
four H100s, ``chip_tools/while_capture_probe.py body_nccl_shift_cards``,
after an eager exchange on the group), and it runs at every replay; a
one-rank dimension's shift calls nothing.  Its calls and bytes are counts
of :mod:`..ops.graphs`, counted on the card where a replayed loop's body
runs them (read after the fit, as the kernels' launches are); it is not
timed.  A compiled fit's cache entry holds its groups' captured kernels:
:func:`drop_entries_on_destroy` makes
``torch.distributed.destroy_process_group`` drop those entries first, so
the groups' teardown returns without the caller emptying the cache
(C12).  :func:`agree_min` gives every rank of a mesh the least
of their integers, on the host (the
ranks of a sharded fit agree on the path of its chunk loop so, reading
nothing on the card), through the default group's store.
"""

import functools
import time

import torch
import torch.distributed as dist

from ..ops import graphs

__all__ = ["Comm", "CommStats", "stats", "comm_for", "agree_min",
           "drop_entries_on_destroy"]


class CommStats:
    """Per kind (``all_reduce``, ``halo``, ``gather``): calls, bytes sent or
    reduced by this rank (a replayed loop's body's counted on the card, and
    added in when :attr:`calls`, :attr:`bytes` or :meth:`summary` is
    read), and milliseconds when :attr:`timed` (card collectives by CUDA
    events, read at :meth:`summary`; host ones by the host clock; never
    those a graph replays)."""

    KINDS = ("all_reduce", "halo", "gather")

    def __init__(self):
        self.timed = False
        self._calls = dict.fromkeys(self.KINDS, 0)
        self._bytes = dict.fromkeys(self.KINDS, 0)
        for kind in self.KINDS:
            graphs._count_on_card(self._calls, kind)
            graphs._count_on_card(self._bytes, kind)
        self.reset()

    @property
    def calls(self) -> dict:
        graphs._settle()
        return self._calls

    @property
    def bytes(self) -> dict:
        graphs._settle()
        return self._bytes

    def reset(self):
        graphs._settle()  # what finished fits counted on the card, first
        for counts in (self._calls, self._bytes):
            counts.update(dict.fromkeys(self.KINDS, 0))
        self._ms = dict.fromkeys(self.KINDS, 0.0)
        self._timed_calls = dict.fromkeys(self.KINDS, 0)
        self._events = {k: [] for k in self.KINDS}

    def summary(self) -> dict:
        """``{kind: {"calls", "bytes", "ms", "timed_calls"}}``; ``ms`` (of
        the ``timed_calls`` calls timed: none a graph replayed) is ``None``
        unless timed.  Synchronizes the card when events were recorded."""
        graphs._settle()
        out = {}
        for kind in self.KINDS:
            ms = self._ms[kind]
            if self._events[kind]:
                torch.cuda.synchronize()
                ms += sum(a.elapsed_time(b) for a, b in self._events[kind])
            out[kind] = {"calls": self._calls[kind], "bytes": self._bytes[kind],
                         "ms": ms if self.timed else None,
                         "timed_calls": self._timed_calls[kind]}
        return out


stats = CommStats()


class _Timer:
    """Times one collective into :data:`stats` when it is timed and not
    being captured, and counts it (``nbytes``)."""

    def __init__(self, kind: str, on_card: bool, nbytes: int):
        stats._calls[kind] += 1
        stats._bytes[kind] += nbytes
        self.timed = stats.timed and not (
            on_card and torch.cuda.is_current_stream_capturing())
        self.kind, self.on_card = kind, on_card and self.timed

    def __enter__(self):
        stats._timed_calls[self.kind] += self.timed
        if self.on_card:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()
        elif self.timed:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.on_card:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            stats._events[self.kind].append((self.start, end))
        elif self.timed:
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
        a one-rank NCCL group runs NCCL.  A tensor that is not contiguous
        (a cuDNN weight gradient, the halo ``conv`` mode's) is reduced in a
        contiguous copy, copied back: NCCL refuses it (C11)."""
        tensors = [t for t in tensors if t is not None]
        if not tensors:
            return
        dense = [t.contiguous() for t in tensors]
        with _Timer("all_reduce", self.device.type == "cuda",
                    sum(t.numel() * t.element_size() for t in tensors)):
            works = [dist.all_reduce(t, group=self.group, async_op=True)
                     for t in dense]
            for w in works:
                w.wait()
        for t, d in zip(tensors, dense):
            if d is not t:
                t.copy_(d)

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
        with _Timer("gather", self.device.type == "cuda",
                    x.numel() * x.element_size()):
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
        staged = self.transport == "gloo-staged"
        with _Timer("halo", self.device.type == "cuda" and not staged,
                    has_dst * x.numel() * x.element_size()):
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


def comm_for(mesh, axis: str) -> Comm:
    """The :class:`Comm` of ``mesh``'s dimension ``axis`` (one per pair and
    process group, so its pinned buffers serve every call; a mesh made
    again on a new default group equals the old one, but its group is
    new: C10)."""
    return _comm_for(mesh, axis, mesh.get_group(axis))


@functools.lru_cache(maxsize=None)
def _comm_for(mesh, axis: str, group) -> Comm:
    return Comm(mesh, axis)


def drop_entries_on_destroy() -> None:
    """Makes ``torch.distributed.destroy_process_group`` drop the fits'
    cache entries (``ops/solver.py``) whose chunk runs collectives of the
    groups it destroys (every group when it destroys the default one)
    before it tears them down: an entry's CUDA graphs hold captured NCCL
    kernels of its groups, and NCCL's teardown of a communicator waits for
    the graphs that captured its kernels to go, which a kept entry never
    lets them do (C12: the call hung).  PyTorch offers no hook on a
    group's destruction, so this wraps the function, once, under both its
    names (``torch.distributed`` and ``torch.distributed.distributed_c10d``);
    the wrapper calls the function it replaced.  The sharded fits call it
    the first time an entry holds a group; a caller holding the function
    from before that (``from torch.distributed import
    destroy_process_group``) calls it unwrapped."""
    c10d = dist.distributed_c10d
    for owner in (c10d, dist):
        original = owner.destroy_process_group
        if getattr(original, "_pnt_drops_entries", False):
            continue

        def destroy_process_group(group=None, _original=original):
            from ..ops import solver

            every = group is None or group == dist.GroupMember.WORLD
            solver._CACHE.drop_groups(None if every else {group})
            return _original(group)

        functools.update_wrapper(destroy_process_group, original)
        destroy_process_group._pnt_drops_entries = True
        owner.destroy_process_group = destroy_process_group


_AGREED = {}  # mesh ranks -> the agreements made, the same on each rank


def agree_min(mesh, value: int) -> int:
    """The least of the ranks' ``value`` over every rank of ``mesh``, on
    the host: each rank sets its value under a key of the agreement's own
    in the default group's store and reads the others' (no collective, no
    new process group; nothing on a mesh of one rank).  Every rank of the
    mesh calls it, as often as the others."""
    ranks = sorted(int(r) for r in mesh.mesh.flatten().tolist())
    if len(ranks) == 1:
        return int(value)
    store = dist.distributed_c10d._get_default_store()
    group = "_".join(map(str, ranks))
    seq = _AGREED[group] = _AGREED.get(group, -1) + 1
    keys = [f"pnt_agree/{group}/{seq}/{r}" for r in ranks]
    me = dist.get_rank()
    store.set(keys[ranks.index(me)], str(int(value)))
    store.wait(keys)
    out = min(int(store.get(k)) for k in keys)
    if seq:  # every rank has read the last agreement's keys: drop its own
        store.delete_key(f"pnt_agree/{group}/{seq - 1}/{me}")
    return out

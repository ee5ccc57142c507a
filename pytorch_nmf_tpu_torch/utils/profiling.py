"""Profiling hooks (counterpart of :mod:`pytorch_nmf_tpu.utils.profiling`),
on ``torch.profiler``: a trace of a fit for TensorBoard or Perfetto, named
regions in it, and the card's memory statistics."""

import contextlib

import torch

__all__ = ["trace", "annotate", "device_memory_stats"]


@contextlib.contextmanager
def trace(logdir: str, host_tracer_level: int = 2):
    """Profile the enclosed block and write its trace into ``logdir`` (a
    ``*.pt.trace.json`` file, ``torch.profiler.tensorboard_trace_handler``).
    The card's kernels are recorded where CUDA is available, and the host's
    operators unless ``host_tracer_level == 0`` (a trace must record
    something, so a machine without CUDA records the host at every level).
    Yields the ``torch.profiler.profile`` object, whose ``key_averages()``
    sums the run by operator and kernel.

    Example::

        with trace("/tmp/nmf_trace"):
            model.fit(V, beta=1, max_iter=100)
    """
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = []
    if host_tracer_level != 0 or not torch.cuda.is_available():
        activities.append(ProfilerActivity.CPU)
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


def annotate(name: str):
    """A named region that shows up in the trace's timeline
    (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)


def device_memory_stats(device=None):
    """The CUDA caching allocator's statistics for ``device`` (the current
    card when ``None``): ``torch.cuda.memory_stats``, with the live and peak
    bytes under ``"allocated_bytes.all.current"`` and
    ``"allocated_bytes.all.peak"``.  ``{}`` for a CPU device, or where there
    is no CUDA."""
    if device is not None and torch.device(device).type != "cuda":
        return {}
    if not torch.cuda.is_available():
        return {}
    return dict(torch.cuda.memory_stats(device))

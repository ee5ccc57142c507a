"""Multi-process start-up (counterpart of
:mod:`pytorch_nmf_tpu.parallel.distributed`).

* :func:`initialize` starts ``torch.distributed`` from explicit arguments
  or from ``torchrun``'s environment (``MASTER_ADDR``/``MASTER_PORT``,
  ``WORLD_SIZE``, ``RANK``): NCCL across cards, gloo on the CPU, or
  ``backend=`` as given.  A rank ``r`` with cards uses
  ``cuda:{r % torch.cuda.device_count()}``.
* :func:`global_mesh` builds a mesh over every rank of the world.

Typical use, one process per card (``torchrun --nproc-per-node 4``)::

    from pytorch_nmf_tpu_torch.parallel import distributed, sharded_nmf_fit
    distributed.initialize()
    mesh = distributed.global_mesh({"data": 4})
    W, H, n_iter = sharded_nmf_fit(V, W0, H0, mesh, beta=1)
"""

import os
import warnings
from typing import Dict, Optional

import torch
import torch.distributed as dist

from .mesh import make_mesh

__all__ = ["initialize", "global_mesh"]

_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               timeout_s: float = 600.0) -> None:
    """Start the default process group; a no-op when it is up already.

    ``coordinator_address`` is an ``init_method`` URL (``tcp://host:port``
    or ``file://path``) or a bare ``host:port``; ``num_processes`` and
    ``process_id`` are the world size and this process's rank.  Without
    arguments the environment that ``torchrun`` sets is read.  The backend
    is NCCL where the card is available and gloo otherwise, unless
    ``backend`` names one.  An explicit request, or a ``torchrun``
    environment, that fails raises; a call with neither warns and stays
    single-process, as the JAX package's auto-discovery does.  Every
    collective of the group times out after ``timeout_s`` seconds."""
    if dist.is_initialized():
        return
    explicit = (coordinator_address is not None or num_processes is not None
                or process_id is not None)
    from_env = all(k in os.environ for k in _ENV)
    if not explicit and not from_env:
        warnings.warn("no coordinator address and no torchrun environment: "
                      "continuing single-process", stacklevel=2)
        return
    if explicit and None in (coordinator_address, num_processes, process_id):
        raise ValueError("give coordinator_address, num_processes and "
                         "process_id together")
    rank = int(process_id if explicit else os.environ["RANK"])
    world = int(num_processes if explicit else os.environ["WORLD_SIZE"])
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if not dist.is_backend_available(backend):
        raise ValueError(f"backend {backend!r} is not available here")
    if torch.cuda.is_available():
        torch.cuda.set_device(rank % torch.cuda.device_count())
    kwargs = {}
    if backend == "nccl":  # binds the rank's card: no guessing at barriers
        kwargs["device_id"] = torch.device("cuda", torch.cuda.current_device())
    if explicit:
        url = str(coordinator_address)
        kwargs["init_method"] = url if "://" in url else f"tcp://{url}"
    from datetime import timedelta

    dist.init_process_group(backend, rank=rank, world_size=world,
                            timeout=timedelta(seconds=timeout_s), **kwargs)


def global_mesh(axes: Dict[str, int], device_type: str = "cuda"):
    """A mesh over every rank of the world: the ranks' cards, or the CPU
    when ``device_type="cpu"``."""
    return make_mesh(axes, device_type)

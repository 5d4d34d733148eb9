"""Process-group initialisation: port of ``devt_tpu/parallel/distributed.py``.

JAX runs one process per host and drives that host's devices from it.
Here one process runs each rank, each on one device, and
:func:`initialize` joins the ranks in a ``torch.distributed`` process
group.  Call it once at program start in every process: in a single
process it is a no-op, so one entry point serves one card and several.

  python -m torch.distributed.run --nproc_per_node 2 \\
      -m devt_tpu_torch.main --dp 2 ...

starts two ranks with the environment ``torchrun`` sets (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``).  The backend is NCCL where each rank of the host
has a card of its own, and Gloo where ranks share a card (more ranks on
the host than cards: NCCL refuses two ranks on one device) or there is no
card.  Gloo reduces CUDA tensors too, so the ranks still compute on the
card; nothing here moves work to the CPU.  Rank ``LOCAL_RANK`` computes on
``cuda:{LOCAL_RANK % device_count}`` (``LOCAL_RANK`` defaults to the
rank), which becomes the current device, so that ``device=None`` (the
card) means it.
"""

from __future__ import annotations

import os
import sys

import torch
import torch.distributed as dist


def _env_int(name: str) -> int | None:
    value = os.environ.get(name)
    return int(value) if value else None


def _backend_for(local_world: int) -> tuple[str, str]:
    """The backend for ``local_world`` ranks on this host, and why."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards == 0:
        return "gloo", "no CUDA device: Gloo on the CPU"
    if local_world > cards:
        return "gloo", (f"{local_world} ranks share {cards} card(s): NCCL "
                        f"cannot put two ranks on one device, Gloo reduces "
                        f"the CUDA tensors")
    return "nccl", f"{local_world} ranks on {cards} card(s), one each"


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> bool:
    """Join the process group when a world of more than one process is
    configured.

    Resolution order: explicit arguments, then ``torchrun``'s environment
    (``MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).
    ``coordinator_address`` is ``host:port``, or an ``init_method`` URL
    (``tcp://…``, ``file://…``).  Returns True when it started (or found)
    a world of more than one process; with one process it does nothing
    and returns False.  Sets this rank's CUDA device and prints the
    backend it chose and why (on stderr)."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK") or 0
    if not (coordinator_address and num_processes and num_processes > 1):
        return False
    if "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    local_world = _env_int("LOCAL_WORLD_SIZE") or num_processes
    local_rank = _env_int("LOCAL_RANK")
    local_rank = process_id if local_rank is None else local_rank
    backend, why = _backend_for(local_world)
    device = torch.device("cpu")
    if torch.cuda.is_available():
        device = torch.device("cuda",
                              local_rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    print(f"devt_tpu_torch: rank {process_id} of {num_processes} on "
          f"{device}, backend {backend} ({why})", file=sys.stderr,
          flush=True)
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=num_processes, rank=process_id)
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def runtime_info() -> dict:
    """The keys of the JAX package's: this process' rank and the world's
    size, the devices this process computes on (one) and the world's,
    and the process group's backend (None without one)."""
    return {
        "process_index": process_index(),
        "process_count": process_count(),
        "local_devices": 1,
        "global_devices": process_count(),
        "backend": dist.get_backend() if dist.is_initialized() else None,
    }

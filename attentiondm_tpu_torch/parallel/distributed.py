"""Process bootstrap (port of `attentiondm_tpu/parallel/distributed.py`).

JAX has one process driving every device of a host, and
`jax.distributed.initialize` joins the hosts.  PyTorch runs one process per
device: `initialize_distributed` joins the ranks into the default process
group, with the address, world size and rank given as arguments or in
torchrun's environment (`MASTER_ADDR` / `MASTER_PORT`, `WORLD_SIZE`,
`RANK`, `LOCAL_RANK`, `LOCAL_WORLD_SIZE`).

The backend is NCCL, one card a rank (`cuda:LOCAL_RANK`).  A host that
starts more ranks than it has cards is refused, unless the caller names the
card the ranks share (`device="cuda:0"`): NCCL refuses two ranks on one
card, so those ranks join over gloo (which takes the collectives of
`collectives.py` on CUDA tensors).  gloo is also the backend when the caller
asks for the CPU (`device="cpu"`, as the tests do).
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

# the rank's device once `initialize_distributed` has run (None before)
_RANK_DEVICE: list = [None]


def _init_method(address: str) -> str:
    """A `tcp://` or `file://` URL as given; a bare `host:port` becomes `tcp://host:port`."""
    return address if "://" in address else f"tcp://{address}"


def _pick_device(device, world_size: int):
    """(the rank's device, backend): the CPU over gloo where asked for; else
    cuda:LOCAL_RANK over NCCL.  A card the caller names is the rank's, over
    gloo where the host's ranks outnumber its cards (they share it).  No
    card, or more ranks than cards and no card named, raises."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu"), "gloo"
    if not torch.cuda.is_available():
        raise RuntimeError("initialize_distributed: no CUDA device; pass device=\"cpu\" to join the ranks over gloo "
                           "on the CPU")
    local_rank = int(os.environ.get("LOCAL_RANK", 0))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    shared = local_world > torch.cuda.device_count()
    if device is not None:
        dev = torch.device(device)
        return torch.device("cuda", dev.index or 0), "gloo" if shared else "nccl"
    if shared:
        raise RuntimeError(f"initialize_distributed: {local_world} ranks on this host and "
                           f"{torch.cuda.device_count()} visible card(s); NCCL takes one card a rank.  Start at most "
                           "one rank a card, or pass device=\"cuda:0\" to share that card over gloo")
    return torch.device("cuda", local_rank), "nccl"


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    initialization_timeout: int | None = None,
    *,
    device=None,
) -> bool:
    """Join this process to the default process group if the arguments or
    the environment call for it.

    Returns False, doing nothing, when no coordinator is given and torchrun's
    variables are not set (so the CLI is always safe to call); True once
    joined to a world of more than one rank.  A second call returns whether
    the world has more than one rank: re-initialisation is the only benign
    failure, and every other one is raised, a connect deadline included (no
    single-process fallback hides a misconfigured cluster).  The rank's
    device becomes the current CUDA device (`rank_device()`)."""
    explicit = coordinator_address is not None
    auto = os.environ.get("MASTER_ADDR") and os.environ.get("WORLD_SIZE") and os.environ.get("RANK")
    if not explicit and not auto:
        return False
    if dist.is_initialized():
        return dist.get_world_size() > 1
    world_size = int(num_processes if num_processes is not None else os.environ.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None else os.environ.get("RANK", 0))
    if explicit:
        init_method = _init_method(coordinator_address)
    else:
        init_method = f"tcp://{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    dev, backend = _pick_device(device, world_size)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kwargs = {}
    if initialization_timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=initialization_timeout)
    try:
        dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank, **kwargs)
    except (RuntimeError, ValueError) as e:
        msg = str(e).lower()
        if "twice" in msg or "already initialized" in msg:
            return dist.is_initialized() and dist.get_world_size() > 1
        raise
    _RANK_DEVICE[0] = dev
    return world_size > 1


def rank_device() -> torch.device | None:
    """The device `initialize_distributed` gave this rank (None before it ran)."""
    return _RANK_DEVICE[0]


def world() -> tuple[int, int]:
    """(rank, world size); (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1

"""Multi-process initialization (port of
`gaussianavatars_tpu/parallel/distributed.py`).

The JAX package initializes `jax.distributed` from JAX_COORDINATOR_ADDRESS /
JAX_NUM_PROCESSES / JAX_PROCESS_ID; the port starts `torch.distributed`
from the variables torchrun sets (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR / MASTER_PORT) or from explicit arguments, one process per
card:

    torchrun --nproc_per_node=P -m gaussianavatars_torch.train ... \\
        --distributed --render_parallel P
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

TIMEOUT_S = 600      # a collective that waits longer than this raises


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           backend: Optional[str] = None,
                           device: str | torch.device = "cuda",
                           timeout_s: float = TIMEOUT_S) -> torch.device:
    """`torch.distributed.init_process_group` with torchrun's variables as
    the defaults; returns this rank's device.

    init_method: default "env://" (MASTER_ADDR / MASTER_PORT); a
      "file://" or "tcp://host:port" address works too.
    world_size / rank: default WORLD_SIZE / RANK.
    backend: default "nccl" on cuda, "gloo" on cpu. NCCL puts no two ranks
      on one card; ranks that share a card must ask for gloo, which takes
      CUDA tensors.
    device: "cuda" pins the rank to cuda:{LOCAL_RANK % device_count}
      (LOCAL_RANK defaults to the rank).
    timeout_s: the process group's timeout: a rank left waiting in a
      collective raises after it instead of hanging.

    A backend that fails to start raises; nothing falls back to another.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA was requested but "
                           "torch.cuda.is_available() is False")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if rank is None or world_size is None:
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            raise RuntimeError("RANK and WORLD_SIZE are not set: start the "
                               "processes with torchrun, or pass them")
        rank = int(os.environ["RANK"]) if rank is None else rank
        world_size = (int(os.environ["WORLD_SIZE"]) if world_size is None
                      else world_size)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(
        backend, init_method=init_method or "env://", world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    # NCCL connects lazily: one all-reduce here makes a backend that cannot
    # start fail now, not at the first step
    probe = torch.ones(1, device=dev)
    dist.all_reduce(probe)
    if int(probe.item()) != world_size:
        raise RuntimeError(f"{backend} all-reduce over {world_size} ranks "
                           f"gave {probe.item()}")
    return dev


def global_mesh(n_data: int = 1):
    """The ('data', 'prim') mesh over every rank: n_prim = world // n_data."""
    from gaussianavatars_torch.parallel.mesh import make_mesh

    return make_mesh(n_data=n_data)

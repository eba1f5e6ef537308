"""Shards and processes (counterpart of galah_tpu/parallel/mesh.py).

The JAX package lays its devices out as a jax.sharding.Mesh with one
"rows" axis. The port keeps a plain shard list instead: one entry per
(process rank, local device) in a fixed global order, rank by rank and
within a rank in the order of its local devices. A local device may
repeat (two shards on one card, or several CPU shards); shards are
told apart by their index in the list, never by their device.

Processes are joined by torch.distributed over gloo. Every collective
of the port moves host tensors, as the JAX package's
multihost_utils.process_allgather moves numpy arrays, so one layout
serves CPU shards, several cards and several ranks on one card (which
NCCL cannot hold). The JAX package's 2-D ("rows", "buckets") mesh,
which only library callers passing a mesh reach, has no counterpart,
nor has its pad_to_multiple, which nothing calls.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# Seconds a collective waits for its peers before the process group
# gives up: a rank that failed leaves the others in a collective, and
# they stop instead of waiting for ever.
DEFAULT_TIMEOUT_S = 1800.0


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> None:
    """Join this process to a gloo process group (the JAX package's
    jax.distributed.initialize signature). coordinator_address is
    "host:port" of rank 0's rendezvous; with it, num_processes and
    process_id are required. Without it, torch.distributed's own
    environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK) is read.
    Call once per process before the port's entry points."""
    if coordinator_address is None:
        init, kwargs = "env://", {}
    else:
        if num_processes is None or process_id is None:
            raise ValueError(
                "initialize_distributed with a coordinator_address needs "
                "num_processes and process_id")
        init = f"tcp://{coordinator_address}"
        kwargs = {"world_size": num_processes, "rank": process_id}
    dist.init_process_group(
        "gloo", init_method=init,
        timeout=datetime.timedelta(seconds=timeout_s), **kwargs)


def process_count() -> int:
    """Processes in the group; 1 when no group exists."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank; 0 when no group exists."""
    return dist.get_rank() if dist.is_initialized() else 0


@dataclass(frozen=True)
class Shard:
    """One shard of the global list: the rank that holds it, its index
    among that rank's shards and (on that rank only) its device."""

    rank: int
    local: int
    device: Optional[torch.device]


def shard_list(devices: Sequence[torch.device]) -> List[Shard]:
    """The global shard list for this rank's local `devices`. With
    several processes the local counts are all-gathered, so every rank
    must call it at the same point (lockstep). Other ranks' shards carry
    no device."""
    devices = list(devices)
    if not devices:
        raise ValueError("no shard devices")
    counts = [len(devices)]
    if process_count() > 1:
        from galah_tpu_torch.parallel.mp import all_gather_equal

        counts = [int(c[0]) for c in all_gather_equal(
            np.asarray([len(devices)], np.int64))]
    me = process_index()
    return [Shard(r, i, devices[i] if r == me else None)
            for r, c in enumerate(counts) for i in range(c)]


"""Joining a multi-process run (counterpart of
``neuraltexttospeech_tpu/parallel/distributed.py``, :22-55).

JAX connects its processes with ``jax.distributed.initialize``; here it is
``torch.distributed.init_process_group``, NCCL between cards and gloo on
the CPU. One process drives one card, ``cuda:LOCAL_RANK``.

:func:`launch` is what every trainer CLI calls: under ``torchrun`` (or with
``COORDINATOR_ADDRESS``, ``NUM_PROCESSES`` and ``PROCESS_ID``) it joins the
run and returns the data-parallel mesh of JAX's rule ``n_data = gcd(batch,
world)`` (``train/harness.py:157``, ``hifigan/train.py:118``), or no mesh
when ``n_data`` is 1; without them it returns the one device and no mesh,
and the CLI runs as on one card.
"""

from __future__ import annotations

import math
import os
import sys
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from .mesh import Mesh, make_mesh

__all__ = ["initialize_distributed", "local_device", "launch", "writes_files"]


def writes_files() -> bool:
    """Whether this process writes a run's files (its model config and
    checkpoints): True unless it is a rank other than 0 of a process group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def local_device(device=None, process_id: Optional[int] = None) -> torch.device:
    """This process's device: ``device`` if it names one, else
    ``cuda:LOCAL_RANK`` (``LOCAL_RANK`` from ``torchrun``; without it the
    process id modulo the cards visible). Raises without a card, as every
    entry point does."""
    if device is not None and torch.device(device) != torch.device("cuda"):
        return resolve_device(device)
    if "LOCAL_RANK" in os.environ:
        index = int(os.environ["LOCAL_RANK"])
    else:
        index = (process_id or 0) % max(torch.cuda.device_count(), 1)
    return resolve_device(f"cuda:{index}")


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *, device=None,
                           backend: Optional[str] = None) -> bool:
    """Join a multi-process run when one is configured; a no-op otherwise.

    Resolution order: the arguments, then ``COORDINATOR_ADDRESS``
    (``host:port``), ``NUM_PROCESSES`` and ``PROCESS_ID``, then
    ``torchrun``'s ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE`` and
    ``RANK``. Returns True when a process group was initialised. The backend
    is NCCL for a CUDA ``device`` (default ``cuda:LOCAL_RANK``) and gloo for
    the CPU; ``backend="gloo"`` runs gloo on the card's tensors (several
    ranks on one card). A failed initialisation raises."""
    env = os.environ
    coordinator_address = coordinator_address or env.get("COORDINATOR_ADDRESS")
    if num_processes is None and "NUM_PROCESSES" in env:
        num_processes = int(env["NUM_PROCESSES"])
    if process_id is None and "PROCESS_ID" in env:
        process_id = int(env["PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        if not {"MASTER_ADDR", "WORLD_SIZE", "RANK"} <= env.keys():
            return False
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
        num_processes, process_id = int(env["WORLD_SIZE"]), int(env["RANK"])
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a multi-process run needs the coordinator address, the number of "
                         "processes and this process's id")
    device = local_device(device, process_id)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend or ("nccl" if device.type == "cuda" else "gloo"),
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return True


def launch(device=None, batch_size: int = 1) -> Tuple[torch.device, Optional[Mesh]]:
    """A trainer CLI's device and data-parallel mesh. Without a multi-process
    run: ``resolve_device(device)`` and no mesh. Within one: this process's
    device, and the ``gcd(batch_size, world) × 1`` mesh, or no mesh when
    that is one rank (the one-card step, with no collective); ranks other
    than 0 print nothing from here on. A rank past the data axis holds no
    rows of any batch (JAX's devices past ``n_data``): it runs no step, and
    exits here."""
    if not initialize_distributed(device=device):
        return resolve_device(device), None
    rank, n_data = dist.get_rank(), math.gcd(batch_size, dist.get_world_size())
    mesh = make_mesh(n_data=n_data) if n_data > 1 else None  # a collective of every rank
    if rank >= n_data:
        print(f"rank {rank}: past the {n_data}-rank data axis of batch {batch_size}; "
              "no step to run", file=sys.stderr)
        dist.destroy_process_group()
        sys.exit(0)
    if rank != 0:
        sys.stdout = open(os.devnull, "w")
    return local_device(device, rank), mesh

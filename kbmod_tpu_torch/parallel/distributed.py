"""Multi-process group setup and patch-level orchestration, on
``torch.distributed``.

Port of the JAX package's parallel/distributed.py. The reference scales out
by hand: each patch of a region runs as its own single-card job and the
result files are merged. This module gives the two forms of that here:

* one **process per host (or card)** joined with
  :func:`initialize_distributed`, so that one sharded search spans the
  processes' devices (``parallel.sharded`` gathers across the group with
  ``torch.distributed`` collectives), and
* **patch-parallel** runs, each process taking the patches that
  :func:`assign_patches_to_hosts` gives it, with no communication.

Nothing on a machine tells a program of its cluster: the coordinator's
``host:port``, the process count and this process's rank come from the
arguments or from ``KB_COORDINATOR``, ``KB_NUM_PROCESSES`` and
``KB_PROCESS_ID``.
"""

import logging
import os

import torch
import torch.distributed as dist

from kbmod_tpu_torch.device import resolve_device

logger = logging.getLogger(__name__)

__all__ = ["initialize_distributed", "is_distributed", "assign_patches_to_hosts"]


def initialize_distributed(coordinator_address=None, num_processes=None, process_id=None, device=None):
    """Join (or create) a process group of ``num_processes`` processes whose
    rank-0 process listens at ``coordinator_address`` (``host:port``).

    ``device`` is the search's device: None means CUDA (raising without a
    card), which joins with the NCCL backend and binds this process to the
    card that ``LOCAL_RANK`` names, else to its rank modulo the visible
    card count; ``"cpu"`` joins with ``gloo``. Arguments left None come
    from ``KB_COORDINATOR``, ``KB_NUM_PROCESSES`` and ``KB_PROCESS_ID``.
    Safe to call more than once: only the first call joins.
    """
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    coordinator_address = coordinator_address or os.environ.get("KB_COORDINATOR")
    if num_processes is None and "KB_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["KB_NUM_PROCESSES"])
    if process_id is None and "KB_PROCESS_ID" in os.environ:
        process_id = int(os.environ["KB_PROCESS_ID"])
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "initialize_distributed needs the coordinator's host:port, the process count and this "
            "process's rank (arguments or KB_COORDINATOR, KB_NUM_PROCESSES, KB_PROCESS_ID)"
        )
    backend = "gloo"
    if dev.type == "cuda":
        backend = "nccl"
        local = int(os.environ.get("LOCAL_RANK", int(process_id) % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
    )
    logger.info(f"Joined process group ({backend}): process {dist.get_rank()} / {dist.get_world_size()}.")


def is_distributed():
    """True when more than one process shares the search."""
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def process_rank_and_count():
    """(this process's rank, the process count): (0, 1) outside a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def collective_device():
    """The device a collective's tensors live on: the CPU under ``gloo``,
    this process's card under NCCL (which takes only card tensors)."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def assign_patches_to_hosts(num_patches, num_hosts=None, host_id=None):
    """Deterministic round-robin patch assignment for patch-parallel runs:
    every process computes the same split with no communication and takes
    ``assign_patches_to_hosts(N)`` (its own share; ``host_id`` and
    ``num_hosts`` default to this process's rank and the group's size).
    Returns the list of patch indices owned by ``host_id``."""
    rank, count = process_rank_and_count()
    if num_hosts is None:
        num_hosts = count
    if host_id is None:
        host_id = rank
    if not 0 <= host_id < num_hosts:
        raise ValueError(f"host_id {host_id} out of range for {num_hosts} hosts")
    return list(range(host_id, int(num_patches), int(num_hosts)))

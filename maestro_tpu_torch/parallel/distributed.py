"""Multi-process initialization and cross-process utilities.

The reference trains under Lightning's env-rendezvous DDP over NCCL
(conf/trainer.py:12-14); the JAX package runs one program per host under
``jax.distributed.initialize()``.  Here each process drives one device and
joins the default ``torch.distributed`` group from the variables a launcher
such as ``torchrun`` sets (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``, ``LOCAL_RANK``).  The backend follows the device: NCCL for
``cuda``, gloo for ``cpu``.  Logging and checkpoint writing are process-0
only (``is_primary``).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def initialize_distributed(
    device="cuda",
    *,
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    backend: str | None = None,
) -> bool:
    """Join the default process group; returns whether this call created it.

    Nothing happens when a group already exists, or when the run is one
    process (``WORLD_SIZE`` unset or 1) that no launcher started and no
    ``init_method`` is given.  A launcher's run of one process (``torchrun
    --nproc_per_node=1`` sets ``TORCHELASTIC_RUN_ID``; any launcher sets
    ``WORLD_SIZE`` with ``MASTER_ADDR``) joins a group of one, so that the
    mesh and its wrappers (``trainer.fsdp``) are built as for several.
    Otherwise the rendezvous is ``init_method`` (``tcp://`` or ``file://``)
    or the launcher's ``env://``, which needs ``MASTER_ADDR``; the backend
    is NCCL for a CUDA ``device`` and gloo otherwise.  On CUDA the process
    takes device ``LOCAL_RANK`` modulo the visible count, so several ranks
    may share one card.
    """
    if dist.is_initialized():
        return False
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1 and init_method is None and not launched():
        return False
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if init_method is None:
        missing = [v for v in ("MASTER_ADDR", "MASTER_PORT") if v not in os.environ]
        if missing:
            msg = (
                f"WORLD_SIZE={world_size} but no rendezvous: {', '.join(missing)} unset "
                "(start the processes with torchrun, or pass init_method=)"
            )
            raise RuntimeError(msg)
        init_method = "env://"
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)) % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
    return True


def launched() -> bool:
    """Whether a launcher started this process: torchrun's
    ``TORCHELASTIC_RUN_ID``, or ``WORLD_SIZE`` beside ``MASTER_ADDR``."""
    env = os.environ
    return "TORCHELASTIC_RUN_ID" in env or ("WORLD_SIZE" in env and "MASTER_ADDR" in env)


def process_index() -> int:
    """This process's rank in the default group (0 without one)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    """Processes in the run: the default group's size, else the launcher's
    ``WORLD_SIZE`` (1 without either)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def is_primary() -> bool:
    """True on the logging / checkpointing process (reference @rank_zero_only)."""
    return process_index() == 0


def local_batch_slice(global_batch: int) -> int:
    """Per-process batch size for a process-sharded data pipeline."""
    n = process_count()
    if global_batch % n:
        msg = f"global batch {global_batch} not divisible by {n} processes."
        raise ValueError(msg)
    return global_batch // n


def broadcast_object(obj, src: int = 0):
    """``obj`` as process ``src`` has it, on every process (itself without a
    group)."""
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]

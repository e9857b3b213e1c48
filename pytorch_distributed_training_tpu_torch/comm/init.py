"""Multi-process runtime initialization: the counterpart of the JAX
package's ``comm/init.py``.

The reference's distributed block (``src/main.py:35-42``) is
``dist.init_process_group(backend='nccl' if cuda else 'gloo')`` over
torchrun's env contract; this module is that block with the JAX twin's
names (``initialize``, ``is_initialized``, ``process_count``,
``process_index``, ``shutdown``, plus ``local_rank``).  Rendezvous reads
``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``; the group
is ``torch.distributed``'s default (world) group.

One deliberate difference from JAX: with the env present at
``WORLD_SIZE == 1`` the port creates the group (a one-rank NCCL group on
the card), where JAX returns early, so a one-card run goes through the
same collectives as a many-card one.  With no env at all it is a no-op,
as in JAX.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

# Bounds every collective and the rendezvous, so a rank that dies does
# not leave the others blocked for good.
TIMEOUT = datetime.timedelta(seconds=300)


def initialize(device: torch.device | str | None = None, *,
               backend: str | None = None):
    """Join the process group the env describes (idempotent); returns
    the group, or ``None`` when the env describes none.

    ``backend`` defaults to the reference's rule: ``"nccl"`` for a CUDA
    ``device``, ``"gloo"`` otherwise (the CLI exposes no choice; a caller
    that runs several ranks on one card passes ``"gloo"``).  NCCL groups
    are bound to ``device`` (``device_id``).
    """
    if is_initialized():
        return dist.group.WORLD
    if "WORLD_SIZE" not in os.environ:
        return None
    world = int(os.environ["WORLD_SIZE"])
    addr = os.environ.get("MASTER_ADDR")
    port = os.environ.get("MASTER_PORT")
    if not (addr and port):
        if world > 1:
            raise ValueError(
                f"WORLD_SIZE={world} > 1 but no coordinator address: set "
                "MASTER_ADDR and MASTER_PORT (torchrun contract)."
            )
        return None
    device = torch.device(device if device is not None else "cpu")
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    kwargs = {}
    if backend == "nccl":
        kwargs["device_id"] = device
    dist.init_process_group(
        backend, init_method=f"tcp://{addr}:{port}", world_size=world,
        rank=int(os.environ.get("RANK", "0")), timeout=TIMEOUT, **kwargs,
    )
    return dist.group.WORLD


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """World size (``dist.get_world_size()``); 1 outside a group."""
    return dist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    """Global rank (``dist.get_rank()``); 0 outside a group."""
    return dist.get_rank() if is_initialized() else 0


def local_rank() -> int:
    """This process's rank on its host (torchrun's ``LOCAL_RANK``)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def shutdown() -> None:
    if is_initialized():
        dist.destroy_process_group()

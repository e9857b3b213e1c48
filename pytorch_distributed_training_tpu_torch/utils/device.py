"""Device selection shared by every entry point of the port."""

from __future__ import annotations

import os

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means CUDA: the port's kernels are written for the card, so
    an entry point never drops to the CPU on its own.  Without a CUDA
    device it raises; pass ``device="cpu"`` (the CLI's ``--use-cpu``) to
    run the plain PyTorch versions of the kernels on the host.

    Under torchrun (``LOCAL_RANK`` set) ``None`` is card ``LOCAL_RANK %
    device_count()``, made the current device: one process per card, the
    reference's intent (its ``device_count() % global_rank`` has the
    operands the other way round).  More ranks than cards on a host share
    cards round robin.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' (CLI: --use-cpu) to run "
                "on the host"
            )
        local_rank = os.environ.get("LOCAL_RANK")
        if local_rank is not None:
            index = int(local_rank) % torch.cuda.device_count()
            torch.cuda.set_device(index)
            return torch.device("cuda", index)
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is unavailable")
    return device

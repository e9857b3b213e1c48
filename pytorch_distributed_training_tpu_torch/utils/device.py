"""Device selection shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means CUDA: the port's kernels are written for the card, so
    an entry point never drops to the CPU on its own.  Without a CUDA
    device it raises; pass ``device="cpu"`` (the CLI's ``--use-cpu``) to
    run the plain PyTorch versions of the kernels on the host.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' (CLI: --use-cpu) to run "
                "on the host"
            )
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is unavailable")
    return device

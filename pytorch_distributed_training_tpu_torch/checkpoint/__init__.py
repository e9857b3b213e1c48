"""Checkpoint save and verified restore in the port's own format
(``checkpoint/manager.py``): rank 0 writes the replicated state, async,
with a crc32 manifest beside each step."""

from .manager import CheckpointCorrupted, CheckpointManager, checksum_manifest

__all__ = ["CheckpointCorrupted", "CheckpointManager", "checksum_manifest"]

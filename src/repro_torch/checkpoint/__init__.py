"""Checkpoint substrate: atomic step snapshots (``CheckpointStore``)."""
from .store import CheckpointStore

__all__ = ["CheckpointStore"]

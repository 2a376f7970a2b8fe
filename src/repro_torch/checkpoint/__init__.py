"""LSM-backed checkpointing (checkpoint workload = KV separation)."""

from .store import CheckpointConfig, CheckpointStore, named_leaves

__all__ = ["CheckpointConfig", "CheckpointStore", "named_leaves"]

"""LSM-backed checkpointing (checkpoint workload = KV separation)."""

from .store import (CheckpointConfig, CheckpointStore, named_leaves,
                    restore_sharded, save_sharded)

__all__ = ["CheckpointConfig", "CheckpointStore", "named_leaves",
           "restore_sharded", "save_sharded"]

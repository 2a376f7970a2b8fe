"""Workload generators and benchmark harness (paper Section IV setup)."""

from .harness import (Oracle, PhaseResult, make_db, run_phase,
                      space_amplification, wal_sync_count)
from .workloads import (ScaleConfig, ValueModel, WorkloadSpec, gen_load,
                        gen_multi_client, gen_read, gen_scan, gen_update,
                        gen_ycsb, interleave_round_robin, make_key,
                        tenant_key)

__all__ = ["Oracle", "PhaseResult", "make_db", "run_phase",
           "space_amplification", "wal_sync_count", "ScaleConfig",
           "ValueModel", "WorkloadSpec",
           "gen_load", "gen_multi_client", "gen_read", "gen_scan",
           "gen_update", "gen_ycsb", "interleave_round_robin", "make_key",
           "tenant_key"]

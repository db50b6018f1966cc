"""Multi-host initialisation + process-level helpers.

The reference has no distributed backend at all (SURVEY.md §2c). For
multi-host runs this wraps ``jax.distributed.initialize`` and exposes the
process topology; raster work shards over the devices of a host via
:mod:`obia_tpu.parallel.sharded`, while the network between hosts carries
only tile manifests and merged label-equivalence tables (see SURVEY.md §5).
Outside a cluster manager that JAX detects (Slurm, Open MPI), a multi-host
run passes the coordinator address, process count and process id.
"""
from __future__ import annotations

import os
from typing import Optional

import jax


_initialized = False


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Initialise multi-host JAX. No-ops on single-process setups and when
    already initialised; arguments fall back to the standard env vars /
    the cluster manager's autodetection."""
    global _initialized
    if _initialized:
        return
    if (coordinator_address is None
            and "JAX_COORDINATOR_ADDRESS" not in os.environ
            and num_processes is None
            and not _cluster_env_present()):
        # single host; nothing to do. NOTE: this guard must not touch
        # jax.process_count()/jax.devices() — any backend probe
        # initialises XLA and makes a later real initialize() impossible.
        _initialized = True
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    _initialized = True


def _cluster_env_present() -> bool:
    """True under a multi-process cluster manager (Slurm / Open MPI /
    GKE) where ``jax.distributed.initialize()`` autodetects the
    coordinator itself — skipping it there silently degrades scale-out
    to per-host work. Single-task allocations stay no-op."""
    for var in ("SLURM_NTASKS", "SLURM_JOB_NUM_NODES",
                "OMPI_COMM_WORLD_SIZE", "PMI_SIZE"):
        try:
            if int(os.environ.get(var, "1")) > 1:
                return True
        except ValueError:
            continue
    return "COORDINATOR_ADDRESS" in os.environ


def process_info() -> dict:
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }


def is_coordinator() -> bool:
    return jax.process_index() == 0

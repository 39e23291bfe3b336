"""Multi-host initialisation.

The reference is single-process (SURVEY §2.3); multi-host here is standard
jax.distributed + the same shard_map program as single-host: the mesh in
parallel/mesh.py spans all global devices, per-chain state shards across
hosts, and the only cross-host traffic is the per-step lax.pmean of
O(#hyperparams) scalars.

    from semiblind_tv.runtime.distributed import initialize
    initialize("localhost:1234", 2, 0)  # coordinator, processes, rank
    mesh = make_mesh(data=2, chains=jax.device_count() // 2)
    run_sapg_sharded(problems, mesh, key, ...)

Validated in this repo via the 8-device virtual CPU mesh
(tests/test_parallel.py) and the driver's dryrun_multichip; real multi-host
runs need only this initialize() call first.
"""
from __future__ import annotations

from typing import Optional

import jax

__all__ = ["initialize", "is_multi_host", "local_slice_info"]


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """jax.distributed.initialize with explicit cluster arguments.

    No-op when already initialised or when running single-process.
    """
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError:
        # already initialised (or single-process environment)
        pass


def is_multi_host() -> bool:
    return jax.process_count() > 1


def local_slice_info() -> dict:
    return dict(
        process_index=jax.process_index(),
        process_count=jax.process_count(),
        local_devices=len(jax.local_devices()),
        global_devices=len(jax.devices()),
    )

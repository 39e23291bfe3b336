"""Device-mesh construction for ('data', 'chains') SPMD parallelism.

The reference is strictly single-process/single-thread (SURVEY.md §2.3);
every parallel axis here is new design:

  * 'chains' — independent MYULA Markov chains of the SAME problem; the
    per-chain SAPG statistics (4-6 scalars) are psum-reduced each outer
    step, so cross-device traffic is O(#hyperparams) per iteration.
  * 'data'   — independent problems (images); no cross-shard reduction.

Hyperparameter state is replicated along 'chains' and sharded along 'data'.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = ["make_mesh", "make_spatial_mesh", "DATA_AXIS", "CHAINS_AXIS", "SPACE_AXIS"]

DATA_AXIS = "data"
CHAINS_AXIS = "chains"
SPACE_AXIS = "space"


def make_mesh(
    data: Optional[int] = None,
    chains: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a ('data', 'chains') mesh over the available devices.

    Defaults to data=1 (all devices on chains).  `data * chains` must equal
    the device count.
    """
    devs = list(devices if devices is not None else jax.devices())
    n = len(devs)
    if data is None and chains is None:
        data, chains = 1, n
    elif data is None:
        data = n // chains
    elif chains is None:
        chains = n // data
    if data * chains != n:
        raise ValueError(f"mesh {data}x{chains} != {n} devices")
    arr = np.asarray(devs).reshape(data, chains)
    return Mesh(arr, (DATA_AXIS, CHAINS_AXIS))


def make_spatial_mesh(space: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """1-D ('space',) mesh for row-sharded single-image processing
    (images ≫ HBM — the SURVEY §5 long-context analog).  The image's first
    axis is split into `space` contiguous row blocks, one per device."""
    devs = list(devices if devices is not None else jax.devices())
    space = len(devs) if space is None else space
    if space > len(devs):
        raise ValueError(f"space mesh of {space} > {len(devs)} devices")
    return Mesh(np.asarray(devs[:space]), (SPACE_AXIS,))

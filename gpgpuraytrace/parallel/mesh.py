"""Device mesh construction and multi-process bring-up (SURVEY.md §3.2).

The reference has no multi-device story (one GPU, per-pixel SIMT threads);
scaling is a new-framework capability (BASELINE.json:5,11): image row-tiles
shard over a 1D ``'tiles'`` mesh axis spanning every card of every host,
scene params stay replicated, and parameter gradients are
``psum``-all-reduced by XLA (NCCL on GPUs).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

TILE_AXIS = "tiles"


def make_mesh(devices=None, axis_name: str = TILE_AXIS) -> Mesh:
    """1D mesh over all (or the given) devices.

    Rays are embarrassingly parallel, so a single flat axis is the right
    topology: every collective in this framework is a small param-grad psum,
    and the cards of a host are joined all to all (NVLink), so no mesh
    shape is closer than another.
    """
    devices = np.asarray(jax.devices() if devices is None else devices)
    return Mesh(devices.reshape(-1), (axis_name,))


def image_sharding(mesh: Mesh, axis_name: str = TILE_AXIS) -> NamedSharding:
    """(H, W, 3) image sharded by rows over the tile axis."""
    return NamedSharding(mesh, P(axis_name, None, None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def initialize_distributed(**kwargs) -> None:
    """Multi-host bring-up: ``jax.distributed.initialize`` (BASELINE.json:11).

    No-op when already initialized or single-process (so single-host code
    paths never need to care)."""
    try:
        jax.distributed.initialize(**kwargs)
    except (RuntimeError, ValueError):
        pass  # already initialized or single-process env vars absent

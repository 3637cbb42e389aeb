"""Sharded render and fit: shard_map over the 'tiles' mesh axis.

Driver config 5 (BASELINE.json:11): a large frame's rows shard across every
card of a (multi-host) mesh; each device runs the fused forward+backward over
its own row band (no cross-device traffic), then the small
terrain/camera/material parameter gradients are ``psum``-all-reduced.

Bands are whole coarse rows of the depth prime: a band height that
cfg.prime_ds does not divide primes at a smaller factor
(ops/march.py:band_prime_cfg) — 4K on four cards gives 540-row bands,
primed at 4.

Overlap (BASELINE.json:5 "all-reduced and overlapped with the backward
march"): gradients are psum'd **per pytree leaf**. Compiled-schedule
analysis (scripts/profile_overlap.py; ARCHITECTURE.md "Overlap … measured")
shows XLA's all-reduce combiner fuses the 22 per-leaf psums into ONE tuple
all-reduce of ~45 f32 (180 B) — pure launch latency, nothing worth
overlapping against a multi-ms backward. Per-leaf emission is kept because
it costs nothing and leaves the combiner/scheduler free: with large future
parameter tensors the same code shape lets XLA split and overlap them.
"""

from __future__ import annotations

import functools
from typing import Any

import jax
import jax.numpy as jnp
import optax
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gpgpuraytrace.models.scene import RenderConfig, Scene
from gpgpuraytrace.ops.march import band_prime_cfg
from gpgpuraytrace.ops.render import render
from gpgpuraytrace.parallel.mesh import TILE_AXIS


def _band(cfg: RenderConfig, n_shards: int) -> tuple[RenderConfig, int]:
    """(band config, rows per band) for ``n_shards`` row bands."""
    assert cfg.height % n_shards == 0, (
        f"image height {cfg.height} must divide evenly over {n_shards} shards"
    )
    local_h = cfg.height // n_shards
    return band_prime_cfg(cfg, local_h), local_h


@functools.lru_cache(maxsize=64)
def _sharded_render_fn(cfg: RenderConfig, mesh: Mesh):
    """jit-compiled sharded render, cached per (cfg, mesh).

    The jit wrapper is load-bearing, not a convenience: an eager shard_map
    call dispatches the traced body op-by-op through the SPMD machinery
    (~200 s for even a tiny frame on the CPU test backend); under jit the
    same program compiles once in seconds and replays from cache.
    """
    cfg, local_h = _band(cfg, mesh.shape[TILE_AXIS])

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(),),
        out_specs=P(TILE_AXIS, None, None),
        check_vma=False,
    )
    def body(scene):
        row0 = jax.lax.axis_index(TILE_AXIS).astype(jnp.float32) * local_h
        return render(scene, cfg, row0=row0, local_height=local_h)

    return jax.jit(body)


def sharded_render(scene: Scene, cfg: RenderConfig, mesh: Mesh) -> jax.Array:
    """Full frame rendered with rows sharded over the mesh: (H, W, 3), output
    sharded ``P('tiles', None, None)``. Params replicated; no collectives at
    all in the forward path (rays are embarrassingly parallel)."""
    return _sharded_render_fn(cfg, mesh)(scene)


@functools.lru_cache(maxsize=64)
def _sharded_loss_and_grad_body(merge, cfg: RenderConfig, mesh: Mesh):
    """Raw (un-jitted) shard_map body for loss+grad, cached per
    (merge, cfg, mesh). Kept separate from the jitted wrapper so callers that
    embed it in a larger jit (the fit step) don't nest jit-of-shard_map inside
    jit — nesting re-traces the SPMD program and multiplies compile time ~10x
    on wide meshes (measured 221 s vs 18 s at 8 devices).

    Caching caveat: the cache key uses ``merge`` by *identity* (closures are
    not value-hashable). Call sites must reuse one ``partition_scene`` result;
    building a fresh merge closure per call occupies a new cache slot and
    forces a full SPMD recompile. Applies equally to every cached builder
    here (_sharded_loss_and_grad_fn, make_sharded_fit_step)."""
    cfg, local_h = _band(cfg, mesh.shape[TILE_AXIS])
    inv_npix = 1.0 / (cfg.height * cfg.width * 3)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(TILE_AXIS, None, None)),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def body(train_leaves, target_local):
        row0 = jax.lax.axis_index(TILE_AXIS).astype(jnp.float32) * local_h

        def local_loss(leaves):
            img = render(merge(leaves), cfg, row0=row0, local_height=local_h)
            d = img - target_local
            return jnp.sum(d * d) * inv_npix

        loss, grads = jax.value_and_grad(local_loss)(train_leaves)
        # Per-leaf psum → XLA can overlap each all-reduce with remaining
        # backward work instead of serializing one big fused reduce.
        grads = jax.tree_util.tree_map(
            lambda g: jax.lax.psum(g, TILE_AXIS), grads
        )
        return jax.lax.psum(loss, TILE_AXIS), grads

    return body


@functools.lru_cache(maxsize=64)
def _sharded_loss_and_grad_fn(merge, cfg: RenderConfig, mesh: Mesh):
    """jit-compiled standalone sharded value_and_grad (see body builder)."""
    return jax.jit(_sharded_loss_and_grad_body(merge, cfg, mesh))


def sharded_loss_and_grad(
    train_leaves, merge, cfg: RenderConfig, target: jax.Array, mesh: Mesh
):
    """Global-mean pixel loss + trainable-param grads, computed shard-wise.

    ``train_leaves``/``merge`` come from ``ops.fit.partition_scene`` (the
    trainable float leaves and the scene re-assembler). Each device runs
    forward + checkpointed backward over its row band, then ``psum``s the
    (small) parameter cotangents per leaf across the mesh — the grad
    all-reduce BASELINE.json calls out (NCCL between cards).
    """
    return _sharded_loss_and_grad_fn(merge, cfg, mesh)(train_leaves, target)


@functools.lru_cache(maxsize=64)
def make_sharded_fit_step(
    cfg: RenderConfig, mesh: Mesh, merge, tx: optax.GradientTransformation
):
    """jit-compiled sharded training step over the trainable-leaf list:
    (train_leaves, opt_state, target) → (train_leaves, opt_state, loss).
    Leaves/optimizer state replicated, target row-sharded; the update itself
    is replicated elementwise work.

    Cached by identity on (cfg, mesh, merge, tx) like the sibling builders
    (full-SPMD compiles cost ~18 s on wide meshes): reuse ONE
    partition_scene merge and ONE optax transformation per fit loop, or each
    call recompiles."""

    loss_and_grad = _sharded_loss_and_grad_body(merge, cfg, mesh)

    @jax.jit
    def step(train_leaves, opt_state: Any, target: jax.Array):
        loss, grads = loss_and_grad(train_leaves, target)
        updates, opt_state = tx.update(grads, opt_state, train_leaves)
        train_leaves = optax.apply_updates(train_leaves, updates)
        return train_leaves, opt_state, loss

    return step


def shard_target(target: jax.Array, mesh: Mesh) -> jax.Array:
    """Place a target image with rows sharded over the mesh."""
    return jax.device_put(target, NamedSharding(mesh, P(TILE_AXIS, None, None)))

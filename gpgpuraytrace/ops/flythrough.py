"""Animated flythrough — driver config 4 (BASELINE.json:10): per-frame camera
update with NO recompilation (camera is a traced pytree argument, replacing
the reference's per-frame constant-buffer upload) and temporal ray batching
(a vmapped batch of frames marches as one big launch, keeping the chip full
at small-per-frame sizes).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import jax
import jax.numpy as jnp
import numpy as np

from gpgpuraytrace.models.scene import Camera, RenderConfig, Scene
from gpgpuraytrace.ops.render import render
from gpgpuraytrace.ops.shade import tonemap


def flythrough_camera(scene: Scene, time_s: jax.Array) -> Camera:
    """Default orbit/fly path: forward drift + gentle yaw sweep + bob."""
    cam = scene.camera
    return dataclasses.replace(
        cam,
        position=cam.position
        + jnp.stack(
            [
                2.0 * jnp.sin(0.15 * time_s),
                0.8 * jnp.sin(0.23 * time_s),
                3.0 * time_s,
            ]
        ),
        yaw=cam.yaw + 0.12 * jnp.sin(0.2 * time_s),
    )


def _make_batch_render(cfg: RenderConfig):
    """jit(vmap(render over cameras)): one launch renders a frame batch.

    Frames leave the device as **uint8** — tonemap + quantize run on-chip so
    the host pull moves 3 bytes/pixel instead of 12. At 1080p×batch-4 that
    is 8.3 MB per dispatch instead of 33 MB; on a bandwidth-limited link
    (PCIe under load) the transfer, not the render, is the frame-rate
    ceiling.
    """

    def render_one(scene: Scene, time_s: jax.Array) -> jax.Array:
        cam = flythrough_camera(scene, time_s)
        img = tonemap(render(dataclasses.replace(scene, camera=cam), cfg))
        return (jnp.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(jnp.uint8)

    batched = jax.vmap(render_one, in_axes=(None, 0))
    return jax.jit(batched)


def fly_frames(
    scene: Scene,
    cfg: RenderConfig,
    num_frames: int,
    batch: int = 4,
    fps: float = 30.0,
    on_batch=None,
    aot_cache: str = "",
) -> Iterator[tuple[int, np.ndarray]]:
    """Yield (frame_index, tonemapped (H,W,3) uint8 array, PNG-ready).

    Frames are produced in batches of ``batch`` (temporal ray batching); the
    same compiled executable serves every batch — camera params are traced
    arguments, so per-frame updates never recompile. ``on_batch(scene) ->
    scene`` runs before each batch (the live-tweak hook: scene edits are
    traced args, so they also never recompile). ``aot_cache`` (a cache
    directory) restores the compiled batch-render executable from disk,
    skipping the cold lower+compile (VERDICT r4 item 7).
    """
    fn = _make_batch_render(cfg)
    if aot_cache:
        from gpgpuraytrace.utils.aot import load_or_compile

        times0 = jnp.zeros((batch,), jnp.float32)
        fn, aot_status = load_or_compile(
            fn, (scene, times0),
            static_desc=f"fly:{cfg!r}:batch={batch}",
            cache_dir=aot_cache,
        )
        print(f"fly: aot {aot_status}")
    for start in range(0, num_frames, batch):
        if on_batch is not None:
            scene = on_batch(scene)
        n = min(batch, num_frames - start)
        times = (jnp.arange(start, start + batch, dtype=jnp.float32)) / fps
        frames = jax.block_until_ready(fn(scene, times))
        host = np.asarray(frames[:n])
        for k in range(n):
            yield start + k, host[k]

"""The render pipeline: raygen → march → shade, as one jittable function.

This is the pure-JAX/XLA path (SURVEY.md §8 stage 1–2): correct on every
backend, fully differentiable, and the semantic reference that the fused
Pallas kernel (gpgpuraytrace/kernels/) must match within tolerance. The
dispatch structure mirrors the reference's per-frame GPU pipeline
(BASELINE.json:5: camerarays.hlsl → tracescreen.hlsl → screen UAV), collapsed
into a single traced function XLA fuses end-to-end.
"""

from __future__ import annotations

import dataclasses
import functools

import jax

from gpgpuraytrace.models.scene import RenderConfig, Scene
from gpgpuraytrace.ops.camera import generate_rays
from gpgpuraytrace.ops.march import (
    check_prime_band, coarse_prime_cfg, march, march_from_saved, march_primed,
    prime_from_coarse,
)
from gpgpuraytrace.ops.shade import shade


def prime_map_jax(
    scene: Scene, cfg: RenderConfig, row0=0.0, local_height: int | None = None
) -> jax.Array:
    """Depth-prime map via the pure-XLA coarse march (cfg.prime_ds > 0):
    march a (h/ds, w/ds) coarse pass and expand its conservative
    3×3-neighborhood-min t to full resolution (ops/march.py:
    prime_from_coarse). stop_gradient: the prime accelerates the march
    start, it is not a differentiable input."""
    ds = cfg.prime_ds
    h = cfg.height if local_height is None else local_height
    check_prime_band(cfg, row0, h)
    ccfg = coarse_prime_cfg(cfg)
    # One coarse halo row above and below (virtual rows −1 / H_c at the
    # image edges) so band-sharded priming is bit-identical to full-frame
    # (ops/march.py:prime_from_coarse).
    lh = h // ds
    o_c, d_c = generate_rays(
        scene.camera, ccfg.height, ccfg.width, row0 / ds - 1.0, lh + 2
    )
    t_c, _ = march(ccfg, o_c, d_c, scene.noise)
    return prime_from_coarse(jax.lax.stop_gradient(t_c), cfg)


def render_jax(
    scene: Scene, cfg: RenderConfig, row0=0.0, local_height: int | None = None
) -> jax.Array:
    """Pure-XLA render: (h, W, 3) linear RGB. Differentiable w.r.t. scene.

    ``row0``/``local_height`` render a row band of the full frame (the tile
    sharding unit used by parallel/sharded.py); defaults = full frame.
    """
    ray_o, ray_d = generate_rays(scene.camera, cfg.height, cfg.width, row0, local_height)
    if cfg.prime_ds:
        t0p = prime_map_jax(scene, cfg, row0, local_height)
        t, hit = march_primed(cfg, ray_o, ray_d, scene.noise, t0p)
    else:
        t, hit = march(cfg, ray_o, ray_d, scene.noise)
    return shade(
        ray_o, ray_d, t, hit, scene.noise, scene.materials,
        cfg.volumetric, cfg.warp_octaves,
    )


def render_from_checkpoint(
    scene: Scene,
    cfg: RenderConfig,
    t_saved: jax.Array,
    hit_saved: jax.Array,
    row0=0.0,
    local_height: int | None = None,
) -> jax.Array:
    """Render with the march replaced by a saved per-pixel (t, hit) checkpoint.

    Used as the differentiable backward path for the fused Pallas forward
    kernel (BASELINE.json:5 "checkpointed re-march backward"): gradients flow
    through shading directly and through the hit distance via the
    implicit-function VJP of ``march_from_saved`` — no forward re-march.
    """
    ray_o, ray_d = generate_rays(scene.camera, cfg.height, cfg.width, row0, local_height)
    t, hit = march_from_saved(cfg, ray_o, ray_d, scene.noise, t_saved, hit_saved)
    return shade(
        ray_o, ray_d, t, hit, scene.noise, scene.materials,
        cfg.volumetric, cfg.warp_octaves,
    )


def render(
    scene: Scene, cfg: RenderConfig, row0=0.0, local_height: int | None = None
) -> jax.Array:
    """Main entry: the fused kernel when ``cfg.use_pallas`` (the GPU
    default), the pure-XLA path otherwise.

    ``cfg.supersample`` > 1 renders at k× resolution and box-downsamples
    (differentiable SSAA; full frames only — the sharded row-band path
    supersamples inside its own band by scaling row0/local_height).
    """
    ss = cfg.supersample
    if ss > 1:
        hi_cfg = dataclasses.replace(
            cfg, height=cfg.height * ss, width=cfg.width * ss, supersample=1
        )
        lh = None if local_height is None else local_height * ss
        img = render(scene, hi_cfg, row0 * ss, lh)
        h = img.shape[0] // ss
        w = img.shape[1] // ss
        return img.reshape(h, ss, w, ss, 3).mean(axis=(1, 3))
    if cfg.use_pallas:
        from gpgpuraytrace.kernels.trace import render_pallas

        return render_pallas(scene, cfg, row0, local_height)
    return render_jax(scene, cfg, row0, local_height)


@functools.partial(jax.jit, static_argnums=(1,))
def render_jit(scene: Scene, cfg: RenderConfig) -> jax.Array:
    return render(scene, cfg)

"""The procedural terrain field f(p, θ) — the scene geometry.

The reference's ``tracescreen.hlsl`` marches a density field built from
Perlin/fBm noise (BASELINE.json:5,8 "procedural Perlin/fBm noise terrain
volumes"). Two field modes:

* **heightfield** (default): f(p) = p.y - h(p.x, p.z) with h an fBm
  heightfield — a conservative distance bound once scaled by ``step_relax``.
* **volumetric**: f(p) = p.y - h(p.x, p.z) - warp_amplitude · fbm3(p · wf)
  — a true 3D noise volume producing overhangs and caves, the full
  "terrain volume" capability. ``warp_amplitude`` and ``warp_frequency``
  are differentiable scene parameters.

All field functions return analytic spatial gradients alongside values, so
surface normals and the implicit march VJP cost no extra evaluations.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gpgpuraytrace.models.scene import NoiseParams
from gpgpuraytrace.ops.noise import fbm2, fbm3

WARP_LACUNARITY = 2.0
WARP_GAIN = 0.5


def terrain_height(
    x: jax.Array, z: jax.Array, noise: NoiseParams
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Heightfield h(x, z) and its analytic derivatives (h, dh/dx, dh/dz)."""
    hs = noise.horizontal_scale
    n, nx, nz = fbm2(x * hs, z * hs, noise.amplitudes, noise.lacunarity, noise.seed)
    h = noise.height_offset + noise.height_scale * n
    dh_dx = noise.height_scale * hs * nx
    dh_dz = noise.height_scale * hs * nz
    return h, dh_dx, dh_dz


def warp_term(
    p: jax.Array, noise: NoiseParams, warp_octaves: int
) -> tuple[jax.Array, jax.Array]:
    """Volumetric displacement w(p) = warp_amplitude · fbm3(p · wf) and its
    spatial gradient (..., 3)."""
    wf = noise.warp_frequency
    n, nx, ny, nz = fbm3(
        p[..., 0] * wf,
        p[..., 1] * wf,
        p[..., 2] * wf,
        warp_octaves,
        WARP_LACUNARITY,
        WARP_GAIN,
        noise.seed,
    )
    wa = noise.warp_amplitude
    grad = jnp.stack([wa * wf * nx, wa * wf * ny, wa * wf * nz], axis=-1)
    return wa * n, grad


def envelope_height(
    noise: NoiseParams, volumetric: bool = False, warp_octaves: int = 2
) -> jax.Array:
    """Certified upper bound on the terrain surface height: every noise
    octave lies in [-1, 1], so h(x,z) + w(p) ≤ height_offset +
    |height_scale|·Σ|amp| (+ |warp_amplitude|·Σ gain^i in volumetric mode)
    everywhere. Above this plane the field is provably positive — the march
    can skip to it analytically (sky-envelope skip) and any ray above it
    heading up is a certain miss."""
    env = noise.height_offset + jnp.abs(noise.height_scale) * jnp.sum(
        jnp.abs(noise.amplitudes)
    )
    if volumetric:
        tail = float(sum(WARP_GAIN**i for i in range(warp_octaves)))
        env = env + jnp.abs(noise.warp_amplitude) * tail
    return env


def field(
    p: jax.Array,
    noise: NoiseParams,
    volumetric: bool = False,
    warp_octaves: int = 2,
) -> jax.Array:
    """Signed field value: >0 above the surface. Shape (...,3) → (...)."""
    h, _, _ = terrain_height(p[..., 0], p[..., 2], noise)
    f = p[..., 1] - h
    if volumetric:
        w, _ = warp_term(p, noise, warp_octaves)
        f = f - w
    return f


def field_and_grad(
    p: jax.Array,
    noise: NoiseParams,
    volumetric: bool = False,
    warp_octaves: int = 2,
) -> tuple[jax.Array, jax.Array]:
    """f(p) and its analytic spatial gradient ∇p f, shape (..., 3)."""
    h, dh_dx, dh_dz = terrain_height(p[..., 0], p[..., 2], noise)
    f = p[..., 1] - h
    grad = jnp.stack([-dh_dx, jnp.ones_like(h), -dh_dz], axis=-1)
    if volumetric:
        w, wgrad = warp_term(p, noise, warp_octaves)
        f = f - w
        grad = grad - wgrad
    return f, grad


def surface_normal(
    p: jax.Array,
    noise: NoiseParams,
    volumetric: bool = False,
    warp_octaves: int = 2,
) -> jax.Array:
    """Unit surface normal from the analytic field gradient.

    Replaces the reference's normals-from-gradient central differences
    (BASELINE.json:5 "normals-from-gradient") with the exact derivative —
    zero extra noise evaluations.
    """
    _, grad = field_and_grad(p, noise, volumetric, warp_octaves)
    return grad * jax.lax.rsqrt(jnp.sum(grad * grad, axis=-1, keepdims=True))

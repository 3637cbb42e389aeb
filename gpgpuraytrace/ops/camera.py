"""Per-pixel camera-ray generation — the role of the reference's
``camerarays.hlsl`` (BASELINE.json:5), as pure differentiable JAX.

Given a ``Camera`` pytree and a static image size, produce one primary ray
(origin, direction) per pixel. Fully traceable: per-frame camera updates are
plain argument changes, never recompiles (replacing the reference's per-frame
constant-buffer upload).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gpgpuraytrace.models.scene import Camera


def camera_basis(camera: Camera) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Orthonormal (forward, right, up) from yaw/pitch (world up = +y)."""
    cy, sy = jnp.cos(camera.yaw), jnp.sin(camera.yaw)
    cp, sp = jnp.cos(camera.pitch), jnp.sin(camera.pitch)
    forward = jnp.stack([sy * cp, sp, cy * cp])
    right = jnp.stack([cy, jnp.zeros_like(cy), -sy])
    up = jnp.cross(forward, right)
    return forward, right, up


def pixel_ndc(
    height: int, width: int, row0=0.0, local_height: int | None = None
) -> tuple[jax.Array, jax.Array]:
    """Pixel-center NDC grids: x in [-1,1] left→right, y in [-1,1] top→bottom
    flipped so +y is up. Shapes (local_height, width).

    ``row0`` (traced scalar) and ``local_height`` select a horizontal band of
    the full image — the unit of tile sharding across devices (the new
    framework's replacement for the reference's thread-group grid over one
    GPU; SURVEY.md §3.2).
    """
    local_height = height if local_height is None else local_height
    row0 = jnp.asarray(row0, jnp.float32)
    ys = (jnp.arange(local_height, dtype=jnp.float32) + row0 + 0.5) / height * 2.0 - 1.0
    xs = (jnp.arange(width, dtype=jnp.float32) + 0.5) / width * 2.0 - 1.0
    ndc_y = -ys[:, None] * jnp.ones((1, width), jnp.float32)  # top row = +1
    ndc_x = jnp.ones((local_height, 1), jnp.float32) * xs[None, :]
    return ndc_x, ndc_y


def ray_directions_from_ndc(
    camera: Camera, ndc_x: jax.Array, ndc_y: jax.Array, aspect
) -> jax.Array:
    """Normalized world-space ray directions for given NDC coords.

    dir = normalize(forward + tan(fov/2) * (aspect * ndc_x * right + ndc_y * up))

    Shape: ndc (...,) → (..., 3). Differentiable w.r.t. camera pose/fov.
    """
    forward, right, up = camera_basis(camera)
    t = jnp.tan(0.5 * camera.fov_y)
    aspect = jnp.asarray(aspect, jnp.float32)
    d = (
        forward
        + (t * aspect * ndc_x)[..., None] * right
        + (t * ndc_y)[..., None] * up
    )
    return d * jax.lax.rsqrt(jnp.sum(d * d, axis=-1, keepdims=True))


def generate_rays(
    camera: Camera,
    height: int,
    width: int,
    row0=0.0,
    local_height: int | None = None,
) -> tuple[jax.Array, jax.Array]:
    """Primary rays for a (full or row-band) image block:
    (origins (h,W,3), directions (h,W,3)) with h = local_height or height."""
    local_height = height if local_height is None else local_height
    ndc_x, ndc_y = pixel_ndc(height, width, row0, local_height)
    dirs = ray_directions_from_ndc(camera, ndc_x, ndc_y, width / height)
    origins = jnp.broadcast_to(camera.position, (local_height, width, 3))
    return origins, dirs

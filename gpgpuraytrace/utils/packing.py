"""Scene → flat scalar vector packing for the Pallas kernels.

The reference uploaded camera/material constants to the GPU in D3D11 constant
buffers each frame (BASELINE.json:5). Here: derive the camera basis once per
frame in traced JAX, pack every scalar the kernel needs into one small f32
vector (zero-padded to a power-of-two length, as Triton's tensors must be),
pass it as an ordinary kernel input, and read scalars from it inside the
kernel. Layout offsets are module constants shared with ``kernels/trace.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gpgpuraytrace.models.scene import Scene
from gpgpuraytrace.ops.camera import camera_basis

# f32 vector layout (fixed head; amplitudes tail starts at AMPS).
POS = 0  # 3: camera position
FWD = 3  # 3: camera forward
RIGHT = 6  # 3: camera right
UP = 9  # 3: camera up
TANFOV = 12  # tan(fov_y / 2)
ASPECT = 13  # width / height
LACUNARITY = 14
HEIGHT_SCALE = 15
HEIGHT_OFFSET = 16
HORIZONTAL_SCALE = 17
SUN_DIR = 18  # 3 (normalized)
SUN_COLOR = 21  # 3
AMBIENT = 24  # 3
ALBEDO_LOW = 27  # 3
ALBEDO_HIGH = 30  # 3
SNOW_COLOR = 33  # 3
SNOW_HEIGHT = 36
FOG_COLOR = 37  # 3
FOG_DENSITY = 40
SKY_ZENITH = 41  # 3
SKY_HORIZON = 44  # 3
ROW0 = 47  # first image row of this block (tile sharding offset)
WARP_AMP = 48  # volumetric 3D warp amplitude
WARP_FREQ = 49  # volumetric 3D warp base frequency
AMPS = 50  # num_octaves amplitudes


def pack_scene(
    scene: Scene, height: int, width: int, row0=0.0
) -> tuple[jax.Array, jax.Array]:
    """Returns (packed f32 (n_pad,), seed int32 (1,)), where n_pad is the
    next power of two ≥ AMPS + octaves (the tail is zero).

    ``height``/``width`` are the FULL image dims (NDC scale); ``row0`` is the
    traced first-row offset of the block being rendered (0 for full frames).
    """
    fwd, right, up = camera_basis(scene.camera)
    m = scene.materials
    n = scene.noise
    sun = m.sun_dir * jax.lax.rsqrt(jnp.sum(m.sun_dir * m.sun_dir) + 1e-12)
    parts = [
        scene.camera.position,
        fwd,
        right,
        up,
        jnp.tan(0.5 * scene.camera.fov_y)[None],
        jnp.float32(width / height)[None],
        n.lacunarity[None],
        n.height_scale[None],
        n.height_offset[None],
        n.horizontal_scale[None],
        sun,
        m.sun_color,
        m.ambient_color,
        m.albedo_low,
        m.albedo_high,
        m.snow_color,
        m.snow_height[None],
        m.fog_color,
        m.fog_density[None],
        m.sky_zenith,
        m.sky_horizon,
        jnp.asarray(row0, jnp.float32)[None],
        n.warp_amplitude[None],
        n.warp_frequency[None],
        n.amplitudes,
    ]
    packed = jnp.concatenate([jnp.asarray(p, jnp.float32).reshape(-1) for p in parts])
    n_pad = 1 << (packed.shape[0] - 1).bit_length()
    packed = jnp.pad(packed, (0, n_pad - packed.shape[0]))
    seed = jnp.asarray(n.seed, jnp.int32).reshape(1)
    return packed, seed

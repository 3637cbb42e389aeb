"""Hash-based gradient (Perlin-style) noise with analytic derivatives.

Replaces the reference's HLSL noise library (the Perlin/fBm include used by
``tracescreen.hlsl``; BASELINE.json:5 "procedural Perlin/fBm noise terrain
volumes"). Deviations from classic Perlin:

* **No permutation table.** Lattice gradients come from an arithmetic
  integer hash (murmur3-style finalizer) — pure int32 mul/xor/shift, fully
  vectorized, no gathers, so the kernel's registers hold everything.
* **int32 everywhere.** All hash arithmetic runs in int32 — bitwise
  identical to uint32 for mul/xor/add (two's-complement wraparound) — with
  ``lax.shift_right_logical`` standing in for uint32 ``>>``.
* **Analytic derivatives.** The value and its spatial derivative are computed
  together in closed form (one pass), so surface normals and the implicit
  march gradient need no extra finite-difference field evaluations
  (the reference estimates normals with extra field taps; we get them free).
* **Everything is differentiable w.r.t. the continuous inputs** (point
  coordinates and fBm amplitudes); lattice hashing is integer-only and
  correctly contributes zero gradient.

All functions broadcast over leading dimensions: inputs of shape (...,) give
outputs of shape (...,).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# murmur3-inspired mixing constants (public-domain finalizer constants),
# reinterpreted as int32 literals (same bit patterns as the uint32 values).
_C1 = np.int32(np.uint32(0x85EBCA6B).view(np.int32))
_C2 = np.int32(np.uint32(0xC2B2AE35).view(np.int32))
_KX = np.int32(np.uint32(0x8DA6B343).view(np.int32))
_KZ = np.int32(np.uint32(0xD8163841).view(np.int32))
_KY = np.int32(np.uint32(0xCB1AB31F).view(np.int32))

_lsr = jax.lax.shift_right_logical

# Precomputed corner-offset key sums (int32 wraparound): hashing the 2x2 /
# 2x2x2 cell corners shares ONE linear base h = ix·KX + iz·KZ (+ iy·KY) and
# adds these — bit-identical to hashing each corner coordinate separately
# (multiplication distributes over addition in two's-complement wraparound),
# but 2 int muls total instead of 2 per corner (round-5 ops-per-step work).
def _wrap32(v: int) -> np.int32:
    """Python int → int32 with two's-complement wraparound, warning-free."""
    return np.uint32(v & 0xFFFFFFFF).view(np.int32).item() * np.int32(1)


_KXZ = _wrap32(int(_KX) + int(_KZ))
_KXY = _wrap32(int(_KX) + int(_KY))
_KYZ = _wrap32(int(_KY) + int(_KZ))
_KXYZ = _wrap32(int(_KX) + int(_KY) + int(_KZ))


def _mix(h: jax.Array) -> jax.Array:
    """Finalize an int32 hash: 2-stage (xorshift + multiply) since round 5.

    murmur3's full fmix32 (xs16·mul·xs13·mul·xs16, 8 ops) buys avalanche
    quality this noise never observes — the gradient decoders consume THREE
    bits per corner. The 2-stage finalizer's HIGH half is fully mixed (every
    output bit of ``h*C1`` above bit 15 depends on ~all input bits through
    the carry chain), so the decoders read bits 16+ (``_GRAD_SHIFT``); the
    LOW product bits are nearly the input's and must never be used. Half
    the ops of the full mix, with direction-histogram uniformity, second-
    moment isotropy, and adjacent-cell correlation statistically identical
    to it (suite-gated: test_grad2_isotropy_statistics and the adjacency
    test in tests/test_noise.py).
    """
    h = h ^ _lsr(h, 16)
    return h * _C1


# Gradient decoders read hash bits starting here (see _mix: the 2-stage
# finalizer's low product bits are unmixed).
_GRAD_SHIFT = 16


def hash2(ix: jax.Array, iz: jax.Array, seed: jax.Array) -> jax.Array:
    """int32 hash of a 2D integer lattice coordinate (+ seed)."""
    h = ix.astype(jnp.int32) * _KX + iz.astype(jnp.int32) * _KZ
    return _mix(h + seed.astype(jnp.int32) * _KY)


def _corner_hashes2(ix, iz, seed):
    """Hashes of the 2x2 cell corners, sharing one linear base — bit-exact
    to four ``hash2`` calls (see _KXZ note). Order: h00, h10, h01, h11."""
    base = (
        ix.astype(jnp.int32) * _KX
        + iz.astype(jnp.int32) * _KZ
        + jnp.asarray(seed).astype(jnp.int32) * _KY
    )
    return _mix(base), _mix(base + _KX), _mix(base + _KZ), _mix(base + _KXZ)


def _grad2(h: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Exactly-unit 2D lattice gradient from an int32 hash — arithmetic only.

    Perlin's classic trick, select- and rsqrt-free: three hash bits pick one
    of the eight directions (±1, ±2)/√5 and (±2, ±1)/√5. All eight are
    exactly unit length (so every |noise| ≤ 1 certificate downstream is
    unchanged), none is axis-aligned (no zero-derivative cells), and the set
    is symmetric under sign flips and the diagonal swap.

    An earlier version decoded the hash into a continuous direction and
    rsqrt-normalized it per corner; the 8-direction set keeps |g| = 1
    exactly with pure int bit-picks + cheap int→f32 converts and no
    special-function ops.
    """
    gx, gz = _grad2_raw(h)
    return gx * _INV_SQRT5, gz * _INV_SQRT5


_INV_SQRT5 = 0.4472135954999579
_INV_SQRT2 = 0.7071067811865476


def _grad2_raw(h: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Unnormalized 8-direction gradient: (±1, ±2) / (±2, ±1) WITHOUT the
    1/√5 scale. The noise kernels blend these raw dots and apply 1/√5 ONCE
    to the final value (and derivatives) — one mul per noise evaluation
    instead of two per corner (round-5 ops-per-step work; bit-equal up to
    f32 rounding since the whole pipeline is linear in the gradient set)."""
    h = _lsr(h, _GRAD_SHIFT)  # only the hash's high half is mixed (_mix)
    s1 = ((h & 1) * 2 - 1).astype(jnp.float32)  # ±1
    s2 = ((_lsr(h, 1) & 1) * 2 - 1).astype(jnp.float32)  # ±1
    c = (_lsr(h, 2) & 1).astype(jnp.float32)  # 0: (±1,±2), 1: (±2,±1)
    return s1 * (1.0 + c), s2 * (2.0 - c)


def _fade(f: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Quintic fade u(f) = 6f^5 - 15f^4 + 10f^3 and its derivative."""
    u = f * f * f * (f * (f * 6.0 - 15.0) + 10.0)
    du = 30.0 * f * f * (f * (f - 2.0) + 1.0)
    return u, du


def noise2_value(x: jax.Array, z: jax.Array, seed) -> jax.Array:
    """Value-only 2D gradient noise — the march-loop fast path.

    Identical value to ``noise2`` but with no derivative chains, minimizing
    the live-value set inside kernel march loops (register pressure is the
    kernel's limiting resource; XLA DCE would remove the dead chains in
    pure-JAX code, but being explicit keeps the kernel lowering tight).
    """
    x0 = jnp.floor(x)
    z0 = jnp.floor(z)
    fx = x - x0
    fz = z - z0
    ix = x0.astype(jnp.int32)
    iz = z0.astype(jnp.int32)

    h00, h10, h01, h11 = _corner_hashes2(ix, iz, seed)
    g00x, g00z = _grad2_raw(h00)
    g10x, g10z = _grad2_raw(h10)
    g01x, g01z = _grad2_raw(h01)
    g11x, g11z = _grad2_raw(h11)

    n00 = g00x * fx + g00z * fz
    n10 = g10x * (fx - 1.0) + g10z * fz
    n01 = g01x * fx + g01z * (fz - 1.0)
    n11 = g11x * (fx - 1.0) + g11z * (fz - 1.0)

    u, _ = _fade(fx)
    v, _ = _fade(fz)
    k1 = n10 - n00
    k2 = n01 - n00
    k3 = n00 - n10 - n01 + n11
    # 1/√5 applied once here instead of per corner (see _grad2_raw).
    return (n00 + u * k1 + v * k2 + u * v * k3) * _INV_SQRT5


def noise2(x: jax.Array, z: jax.Array, seed) -> tuple[jax.Array, jax.Array, jax.Array]:
    """2D gradient noise: returns (value, d/dx, d/dz), all analytic.

    Value range is roughly [-1, 1]. The derivative is exact (verified against
    finite differences in tests/test_noise.py).
    """
    x0 = jnp.floor(x)
    z0 = jnp.floor(z)
    fx = x - x0
    fz = z - z0
    ix = x0.astype(jnp.int32)
    iz = z0.astype(jnp.int32)

    h00, h10, h01, h11 = _corner_hashes2(ix, iz, seed)
    g00x, g00z = _grad2_raw(h00)
    g10x, g10z = _grad2_raw(h10)
    g01x, g01z = _grad2_raw(h01)
    g11x, g11z = _grad2_raw(h11)

    # Corner dot products g · (p - corner).
    n00 = g00x * fx + g00z * fz
    n10 = g10x * (fx - 1.0) + g10z * fz
    n01 = g01x * fx + g01z * (fz - 1.0)
    n11 = g11x * (fx - 1.0) + g11z * (fz - 1.0)

    u, du = _fade(fx)
    v, dv = _fade(fz)

    k1 = n10 - n00
    k2 = n01 - n00
    k3 = n00 - n10 - n01 + n11
    value = n00 + u * k1 + v * k2 + u * v * k3

    # d(corner dot)/dx is just the corner gradient's x component; chain rule
    # through the bilinear blend plus the fade-weight term. Everything is
    # linear in the gradient set, so the 1/√5 applies once at the end.
    gx_blend = (
        g00x
        + u * (g10x - g00x)
        + v * (g01x - g00x)
        + u * v * (g00x - g10x - g01x + g11x)
    )
    gz_blend = (
        g00z
        + u * (g10z - g00z)
        + v * (g01z - g00z)
        + u * v * (g00z - g10z - g01z + g11z)
    )
    d_dx = gx_blend + du * (k1 + k3 * v)
    d_dz = gz_blend + dv * (k2 + k3 * u)
    return value * _INV_SQRT5, d_dx * _INV_SQRT5, d_dz * _INV_SQRT5


def hash3(ix: jax.Array, iy: jax.Array, iz: jax.Array, seed: jax.Array) -> jax.Array:
    """int32 hash of a 3D integer lattice coordinate (+ seed)."""
    h = (
        ix.astype(jnp.int32) * _KX
        + iy.astype(jnp.int32) * _KY
        + iz.astype(jnp.int32) * _KZ
    )
    return _mix(h + seed.astype(jnp.int32) * _C2)


def _corner_hashes3(ix, iy, iz, seed):
    """Hashes of the 2x2x2 cell corners sharing one linear base — bit-exact
    to eight ``hash3`` calls. Order: corner c = (i, j, k) bit-packed as in
    noise3 (c & 1 → +x, (c >> 1) & 1 → +y, (c >> 2) & 1 → +z)."""
    base = (
        ix.astype(jnp.int32) * _KX
        + iy.astype(jnp.int32) * _KY
        + iz.astype(jnp.int32) * _KZ
        + jnp.asarray(seed).astype(jnp.int32) * _C2
    )
    return (
        _mix(base), _mix(base + _KX), _mix(base + _KY), _mix(base + _KXY),
        _mix(base + _KZ), _mix(base + _KXZ), _mix(base + _KYZ),
        _mix(base + _KXYZ),
    )


def _grad3(h: jax.Array) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Exactly-unit 3D lattice gradient: 12 cube-edge directions
    (±1, ±1, 0)/√2 and permutations, select-based decode — the 3D analogue
    of ``_grad2``'s rsqrt-free redesign (selects instead of a per-corner
    rsqrt). ``zsel == 3`` remaps
    to axis 0, Perlin's own duplication trick — a mild x-axis bias that the
    quintic blend washes out."""
    gx, gy, gz = _grad3_raw(h)
    return gx * _INV_SQRT2, gy * _INV_SQRT2, gz * _INV_SQRT2


def _grad3_raw(h: jax.Array) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Unnormalized cube-edge gradient (components 0/±1, WITHOUT the 1/√2):
    the noise kernels apply 1/√2 once to the final value/derivatives — the
    3D analogue of ``_grad2_raw`` (round-5 ops-per-step work)."""
    h = _lsr(h, _GRAD_SHIFT)  # only the hash's high half is mixed (_mix)
    zsel = _lsr(h, 4) & 3
    zero = jnp.where(zsel == 3, 0, zsel)  # which component is zero
    s1 = ((h & 1) * 2 - 1).astype(jnp.float32)
    s2 = ((_lsr(h, 1) & 1) * 2 - 1).astype(jnp.float32)
    gx = jnp.where(zero == 0, 0.0, s1)
    gy = jnp.where(zero == 1, 0.0, jnp.where(zero == 0, s1, s2))
    gz = jnp.where(zero == 2, 0.0, s2)
    return gx, gy, gz


def noise3_value(x: jax.Array, y: jax.Array, z: jax.Array, seed) -> jax.Array:
    """Value-only 3D gradient noise (march fast path; see noise2_value)."""
    x0, y0, z0 = jnp.floor(x), jnp.floor(y), jnp.floor(z)
    fx, fy, fz = x - x0, y - y0, z - z0
    ix, iy, iz = x0.astype(jnp.int32), y0.astype(jnp.int32), z0.astype(jnp.int32)

    hs = _corner_hashes3(ix, iy, iz, seed)
    n = [None] * 8
    for c in range(8):
        i, j, k = c & 1, (c >> 1) & 1, (c >> 2) & 1
        gxc, gyc, gzc = _grad3_raw(hs[c])
        n[c] = gxc * (fx - i) + gyc * (fy - j) + gzc * (fz - k)

    u, _ = _fade(fx)
    v, _ = _fade(fy)
    w, _ = _fade(fz)
    q00 = n[0] + u * (n[1] - n[0])
    q10 = n[2] + u * (n[3] - n[2])
    q01 = n[4] + u * (n[5] - n[4])
    q11 = n[6] + u * (n[7] - n[6])
    q0 = q00 + v * (q10 - q00)
    q1 = q01 + v * (q11 - q01)
    return (q0 + w * (q1 - q0)) * _INV_SQRT2


def fbm3_value(x, y, z, num_octaves: int, lacunarity, gain, seed) -> jax.Array:
    """Value-only 3D fBm (march fast path)."""
    value = jnp.zeros_like(jnp.asarray(x, jnp.float32))
    freq = 1.0
    amp = 1.0
    for i in range(num_octaves):
        value = value + amp * noise3_value(
            x * freq, y * freq, z * freq, jnp.asarray(seed) + 101 + i
        )
        freq = freq * lacunarity
        amp = amp * gain
    return value


def noise3(
    x: jax.Array, y: jax.Array, z: jax.Array, seed
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """3D gradient noise with analytic derivatives: (value, d/dx, d/dy, d/dz).

    The volumetric component of the terrain field (the reference marches
    "Perlin/fBm noise terrain volumes", BASELINE.json:5); trilinear blend of
    8 hashed corner gradients with quintic fades, derivative by chain rule.
    """
    x0, y0, z0 = jnp.floor(x), jnp.floor(y), jnp.floor(z)
    fx, fy, fz = x - x0, y - y0, z - z0
    ix, iy, iz = x0.astype(jnp.int32), y0.astype(jnp.int32), z0.astype(jnp.int32)

    # Corner dot products and gradients; index c = (i, j, k) bit-packed.
    # Raw (un-normalized) gradients; 1/√2 applies once at the end.
    hs = _corner_hashes3(ix, iy, iz, seed)
    n = [None] * 8
    gx = [None] * 8
    gy = [None] * 8
    gz = [None] * 8
    for c in range(8):
        i, j, k = c & 1, (c >> 1) & 1, (c >> 2) & 1
        gxc, gyc, gzc = _grad3_raw(hs[c])
        n[c] = gxc * (fx - i) + gyc * (fy - j) + gzc * (fz - k)
        gx[c], gy[c], gz[c] = gxc, gyc, gzc

    u, du = _fade(fx)
    v, dv = _fade(fy)
    w, dw = _fade(fz)

    def trilerp(q):
        q00 = q[0] + u * (q[1] - q[0])
        q10 = q[2] + u * (q[3] - q[2])
        q01 = q[4] + u * (q[5] - q[4])
        q11 = q[6] + u * (q[7] - q[6])
        q0 = q00 + v * (q10 - q00)
        q1 = q01 + v * (q11 - q01)
        return q0 + w * (q1 - q0)

    def bilerp_vw(q):  # blend over v (axis j) and w (axis k) only
        q0 = q[0] + v * (q[1] - q[0])
        q1 = q[2] + v * (q[3] - q[2])
        return q0 + w * (q1 - q0)

    def bilerp_uw(q):  # blend over u (axis i) and w (axis k) only
        q0 = q[0] + u * (q[1] - q[0])
        q1 = q[2] + u * (q[3] - q[2])
        return q0 + w * (q1 - q0)

    def bilerp_uv(q):  # blend over u (axis i) and v (axis j) only
        q0 = q[0] + u * (q[1] - q[0])
        q1 = q[2] + u * (q[3] - q[2])
        return q0 + v * (q1 - q0)

    value = trilerp(n)
    # Chain rule: fade-weight term + blended corner-gradient term.
    d_dx = du * bilerp_vw([n[1] - n[0], n[3] - n[2], n[5] - n[4], n[7] - n[6]]) + trilerp(gx)
    d_dy = dv * bilerp_uw([n[2] - n[0], n[3] - n[1], n[6] - n[4], n[7] - n[5]]) + trilerp(gy)
    d_dz = dw * bilerp_uv([n[4] - n[0], n[5] - n[1], n[6] - n[2], n[7] - n[3]]) + trilerp(gz)
    return (value * _INV_SQRT2, d_dx * _INV_SQRT2, d_dy * _INV_SQRT2,
            d_dz * _INV_SQRT2)


# Per-octave lattice rotation (golden-angle increments): decorrelates the
# octave lattices (standard fBm practice) and — with the 8-direction unit
# gradient set — multiplies the effective gradient-direction diversity to
# 8 x num_octaves distinct directions. Measured to matter beyond aesthetics:
# without it, a 2-octave amplitude-fit landscape develops a local minimum
# (~0.1 wide at ~23% amplitude error) that traps Adam; with it the same
# landscape descends monotonically to the global minimum (round 3).
_OCTAVE_ROT = 2.3999632297286535  # golden angle, radians


def octave_rotation(i: int) -> tuple[float, float]:
    """(cos, sin) of octave ``i``'s static lattice rotation."""
    return (
        float(np.cos(_OCTAVE_ROT * i)),
        float(np.sin(_OCTAVE_ROT * i)),
    )


def fbm2(
    x: jax.Array,
    z: jax.Array,
    amplitudes: jax.Array,
    lacunarity,
    seed,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """fBm octave sum with per-octave learnable amplitudes (BASELINE.json:9).

    value(p) = sum_i amp[i] * noise2(R_i p * lacunarity**i, seed + i)

    with ``R_i`` the static per-octave lattice rotation (``octave_rotation``;
    derivatives are pulled back through R_i by the chain rule). The octave
    count is static (``amplitudes.shape[0]``) so the loop unrolls under
    jit/Pallas. Returns (value, d/dx, d/dz); derivatives scale with each
    octave's frequency. Differentiable w.r.t. x, z and ``amplitudes``.
    """
    num_octaves = amplitudes.shape[0]
    lac = jnp.asarray(lacunarity, jnp.float32)
    value = jnp.zeros_like(jnp.asarray(x, jnp.float32))
    d_dx = jnp.zeros_like(value)
    d_dz = jnp.zeros_like(value)
    freq = jnp.float32(1.0)
    for i in range(num_octaves):
        c, s = octave_rotation(i)
        # Rotation and frequency fused into 4 scalar coefficients (the
        # rotation matrix commutes with the uniform scale): 4 vector muls +
        # 2 adds per octave instead of 6 + 2 (round-5 ops-per-step work).
        cf, sf = c * freq, s * freq
        n, nx, nz = noise2(cf * x - sf * z, sf * x + cf * z,
                           jnp.asarray(seed) + i)
        amp = amplitudes[i]
        af = amp * freq  # scalar; folds into the chain-rule coefficients
        value = value + amp * n
        d_dx = d_dx + af * (c * nx + s * nz)
        d_dz = d_dz + af * (-s * nx + c * nz)
        freq = freq * lac
    return value, d_dx, d_dz


def fbm3(
    x: jax.Array,
    y: jax.Array,
    z: jax.Array,
    num_octaves: int,
    lacunarity,
    gain,
    seed,
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """3D fBm with geometric amplitude decay ``gain**i`` (the volumetric warp
    octave stack). Returns (value, d/dx, d/dy, d/dz); differentiable w.r.t.
    the point and ``gain``/``lacunarity``."""
    value = jnp.zeros_like(jnp.asarray(x, jnp.float32))
    d_dx = jnp.zeros_like(value)
    d_dy = jnp.zeros_like(value)
    d_dz = jnp.zeros_like(value)
    freq = 1.0
    amp = 1.0
    for i in range(num_octaves):
        n, nx, ny, nz = noise3(x * freq, y * freq, z * freq, jnp.asarray(seed) + 101 + i)
        value = value + amp * n
        d_dx = d_dx + amp * freq * nx
        d_dy = d_dy + amp * freq * ny
        d_dz = d_dz + amp * freq * nz
        freq = freq * lacunarity
        amp = amp * gain
    return value, d_dx, d_dy, d_dz

"""Fused GPU kernels (Pallas, Triton route): raygen → sphere-trace march →
Newton polish → shade in one pass, and the fused backward pass producing
parameter gradients.

The reference ran two D3D11 dispatches (``camerarays.hlsl`` then
``tracescreen.hlsl``) with one ray per GPU thread and a per-thread
``break`` out of the march. Here one ``pallas_call`` program renders a
(block_h, block_w) pixel block entirely in registers: ray directions from
the packed camera scalars, the march as a chunked early-exit loop (the
block stops as soon as every ray in it is done, checked every
``march_chunk`` steps — divergence is paid per block of a few hundred rays,
not per frame as in the pure-XLA while_loop), analytic-gradient normals,
Lambert/fog/sky shading, and the per-pixel hit-t **checkpoint** that the
custom-VJP backward consumes (the backward uses the implicit-function
gradient — see ops/march.py).

The backward kernel (``_trace_bwd_kernel``): per block it replays raygen +
shade from the saved (t, hit) checkpoint, pulls the output cotangent back
onto the packed scene-scalar vector with an in-kernel ``jax.vjp`` (shade
channel), adds the implicit-function march channel (scale = -t̄ / (∇f·d)
pulled back through one field evaluation — the same math as
ops/march.py:_march_bwd_core), and writes one partial cotangent vector per
block. Blocks run in parallel and in no order, so the partials are summed
by XLA after the kernel; nothing is shared between blocks.

Layout:
* Pixels are (H, W); blocks (block_h, block_w) are powers of two (Triton's
  tensors must be). Outputs are allocated padded up to whole blocks and
  sliced back by the wrapper, so no block is partial; padded lanes start
  inactive and never march. Backward inputs are padded with a benign
  checkpoint (t = 1, miss) and a zero cotangent, so padded lanes add
  exactly zero to every partial.
* Color planes are a leading dim: (3, H, W).
* Scene scalars are one f32 vector padded to a power-of-two length
  (utils/packing.py), an ordinary kernel input; the lattice seed is a
  (1,) int32 input. Every scalar is read once, before the march loop.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from gpgpuraytrace.models.scene import (
    MARCH_CHUNK_DEFAULT, RenderConfig, Scene,
)
from gpgpuraytrace.ops.field import WARP_GAIN, WARP_LACUNARITY
from gpgpuraytrace.ops.march import (
    _BWD_DENOM_MIN, _DENOM_EPS, _PRIME_PREV_PULLBACK, _RESIDUAL_SLACK,
    check_prime_band, coarse_prime_cfg, prime_from_coarse,
)
from gpgpuraytrace.ops.noise import (
    fbm3, fbm3_value, noise2, noise2_value, octave_rotation,
)
from gpgpuraytrace.ops.render import render_from_checkpoint
from gpgpuraytrace.utils import packing as pk


def _smoothstep(lo, hi, x):
    u = jnp.clip((x - lo) / (hi - lo), 0.0, 1.0)
    return u * u * (3.0 - 2.0 * u)


def _fbm_scalar_amps(x, z, amps, lacunarity, seed):
    """fBm with amplitudes as a Python tuple of traced scalars.

    Mirrors ops.noise.fbm2 — including the static per-octave lattice
    rotation (ops.noise.octave_rotation; the cos/sin are Python constants)
    — but never builds an (octaves,) vector: inside a Triton kernel each
    amplitude stays a scalar register broadcast into the block's math.
    """
    value = jnp.zeros_like(x)
    d_dx = jnp.zeros_like(x)
    d_dz = jnp.zeros_like(x)
    freq = 1.0
    for i, amp in enumerate(amps):
        c, s = octave_rotation(i)
        # Rotation×frequency fused into scalar coefficients (mirrors
        # ops.noise.fbm2), computed once outside the march loop.
        cf, sf = c * freq, s * freq
        n, nx, nz = noise2(cf * x - sf * z, sf * x + cf * z, seed + i)
        af = amp * freq
        value = value + amp * n
        d_dx = d_dx + af * (c * nx + s * nz)
        d_dz = d_dz + af * (-s * nx + c * nz)
        freq = freq * lacunarity
    return value, d_dx, d_dz


def _fbm_scalar_amps_value(x, z, amps, lacunarity, seed):
    """Value-only variant of _fbm_scalar_amps — the march-loop fast path
    (roughly 40% fewer live values / ops per step than the derivative
    form)."""
    value = jnp.zeros_like(x)
    freq = 1.0
    for i, amp in enumerate(amps):
        c, s = octave_rotation(i)
        cf, sf = c * freq, s * freq
        value = value + amp * noise2_value(cf * x - sf * z, sf * x + cf * z, seed + i)
        freq = freq * lacunarity
    return value


# --- shared block builders (forward kernel and backward kernel) -------------
# Every builder takes ``sc``, a scalar accessor ``sc(k) -> traced f32`` over
# the packed-scene layout (utils/packing.py offsets). The forward kernel
# reads straight from the parameter ref; the backward kernel passes a tuple
# of the same scalars through jax.vjp, so gradients w.r.t. every packed
# entry fall out of the identical code path.


def _block_rc(cfg: RenderConfig, i, j):
    """Band-local integer (row, col) index blocks of block (i, j)."""
    shape = (cfg.block_h, cfg.block_w)
    rows = jax.lax.broadcasted_iota(jnp.int32, shape, 0) + i * cfg.block_h
    cols = jax.lax.broadcasted_iota(jnp.int32, shape, 1) + j * cfg.block_w
    return rows, cols


def _raygen(sc, cfg: RenderConfig, i, j):
    """Per-pixel primary rays for block (i, j): ((ox,oy,oz), (dx,dy,dz)).

    The role of the reference's camerarays.hlsl, fused into the same kernel
    — origins are camera scalars, directions (block_h, block_w) blocks. Adds
    the row-band offset (ROW0, 0 for full frames) itself.
    """
    rows, cols = _block_rc(cfg, i, j)
    rows = rows.astype(jnp.float32) + sc(pk.ROW0)
    cols = cols.astype(jnp.float32)
    ndc_x = (cols + 0.5) * (2.0 / cfg.width) - 1.0
    ndc_y = 1.0 - (rows + 0.5) * (2.0 / cfg.height)

    sx = sc(pk.TANFOV) * sc(pk.ASPECT) * ndc_x
    sy = sc(pk.TANFOV) * ndc_y
    dx = sc(pk.FWD + 0) + sx * sc(pk.RIGHT + 0) + sy * sc(pk.UP + 0)
    dy = sc(pk.FWD + 1) + sx * sc(pk.RIGHT + 1) + sy * sc(pk.UP + 1)
    dz = sc(pk.FWD + 2) + sx * sc(pk.RIGHT + 2) + sy * sc(pk.UP + 2)
    inv = jax.lax.rsqrt(dx * dx + dy * dy + dz * dz)
    return (sc(pk.POS + 0), sc(pk.POS + 1), sc(pk.POS + 2)), (
        dx * inv,
        dy * inv,
        dz * inv,
    )


def _field_fns(sc, seed, cfg: RenderConfig, o, d):
    """Closures evaluating the terrain field along the ray at distance t.

    Returns (field_grad_at, field_at): the derivative form used by the Newton
    polish / shading / backward, and the value-only march fast path.
    """
    ox, oy, oz = o
    dx, dy, dz = d
    hs = sc(pk.HORIZONTAL_SCALE)
    lac = sc(pk.LACUNARITY)
    h_off = sc(pk.HEIGHT_OFFSET)
    h_scale = sc(pk.HEIGHT_SCALE)
    amps = tuple(sc(pk.AMPS + i) for i in range(cfg.num_octaves))
    if cfg.volumetric:
        w_amp = sc(pk.WARP_AMP)
        w_freq = sc(pk.WARP_FREQ)

    def field_grad_at(t):
        """f(p(t)), its spatial gradient components, and the heightfield h
        (h feeds the snow/albedo shading terms)."""
        px = ox + t * dx
        py = oy + t * dy
        pz = oz + t * dz
        n, nx, nz = _fbm_scalar_amps(px * hs, pz * hs, amps, lac, seed)
        h = h_off + h_scale * n
        scale = h_scale * hs
        f = py - h
        gx, gy, gz = -scale * nx, jnp.ones_like(h), -scale * nz
        if cfg.volumetric:
            n3, nx3, ny3, nz3 = fbm3(
                px * w_freq, py * w_freq, pz * w_freq,
                cfg.warp_octaves, WARP_LACUNARITY, WARP_GAIN, seed,
            )
            f = f - w_amp * n3
            gx = gx - w_amp * w_freq * nx3
            gy = gy - w_amp * w_freq * ny3
            gz = gz - w_amp * w_freq * nz3
        return f, gx, gy, gz, h

    def field_at(t):
        """Value-only field — the march-loop fast path (no derivative
        chains: a smaller live set per step, which is what decides register
        pressure in the hot loop)."""
        px = ox + t * dx
        py = oy + t * dy
        pz = oz + t * dz
        n = _fbm_scalar_amps_value(px * hs, pz * hs, amps, lac, seed)
        f = py - (h_off + h_scale * n)
        if cfg.volumetric:
            f = f - w_amp * fbm3_value(
                px * w_freq, py * w_freq, pz * w_freq,
                cfg.warp_octaves, WARP_LACUNARITY, WARP_GAIN, seed,
            )
        return f

    return field_grad_at, field_at


def _shade_block(sc, cfg: RenderConfig, t, hit, d, field_grad_at):
    """Shading tail (componentwise mirror of ops/shade.py): returns the
    (c0, c1, c2) color-plane blocks. ``hit`` is a constant bool block."""
    _, gx, gy, gz, h = field_grad_at(t)
    return _shade_from_grads(sc, cfg, t, hit, d, (gx, gy, gz, h))


def _shade_from_grads(sc, cfg: RenderConfig, t, hit, d, grads):
    """Shade from a precomputed field evaluation at t (the forward kernel
    reuses its residual-check evaluation here; the backward kernel's
    ``jax.vjp`` goes through ``_shade_block`` so the eval stays inside the
    pullback)."""
    dx, dy, dz = d
    gx, gy, gz, h = grads
    ninv = jax.lax.rsqrt(gx * gx + gy * gy + gz * gz + 1e-12)
    nx_, ny_, nz_ = gx * ninv, gy * ninv, gz * ninv

    lx = sc(pk.SUN_DIR + 0)
    ly = sc(pk.SUN_DIR + 1)
    lz = sc(pk.SUN_DIR + 2)

    # Sky (for all rays; also the fog tint component).
    up_amount = jnp.clip(dy, 0.0, 1.0)
    cos_sun = jnp.clip(dx * lx + dy * ly + dz * lz, 0.0, 1.0)
    c2 = cos_sun * cos_sun
    c4 = c2 * c2
    c8 = c4 * c4
    c16 = c8 * c8
    c64 = c16 * c16 * c16 * c16
    c512 = c64 * c64 * c64 * c64 * c64 * c64 * c64 * c64
    sun_term = 0.25 * c64 + 1.5 * c512

    steep = _smoothstep(0.85, 0.55, ny_)
    snow = _smoothstep(sc(pk.SNOW_HEIGHT), sc(pk.SNOW_HEIGHT) + 1.0, h) * (
        1.0 - steep
    )
    diffuse = jnp.clip(nx_ * lx + ny_ * ly + nz_ * lz, 0.0, 1.0)
    sky_fill = 0.5 + 0.5 * ny_
    fog = 1.0 - jnp.exp(-sc(pk.FOG_DENSITY) * t)

    out = []
    for ch in range(3):
        sky = (
            sc(pk.SKY_HORIZON + ch)
            + (sc(pk.SKY_ZENITH + ch) - sc(pk.SKY_HORIZON + ch)) * up_amount
            + sun_term * sc(pk.SUN_COLOR + ch)
        )
        albedo = (
            sc(pk.ALBEDO_LOW + ch)
            + (sc(pk.ALBEDO_HIGH + ch) - sc(pk.ALBEDO_LOW + ch)) * steep
        )
        albedo = albedo + (sc(pk.SNOW_COLOR + ch) - albedo) * snow
        light = sc(pk.SUN_COLOR + ch) * diffuse + sc(pk.AMBIENT + ch) * sky_fill
        surf = albedo * light
        fog_tint = 0.5 * (sc(pk.FOG_COLOR + ch) + sky)
        surf = surf + (fog_tint - surf) * fog
        out.append(jnp.where(hit, surf, sky))
    return tuple(out)


def _envelope(sc, cfg: RenderConfig):
    """Certified terrain upper bound: every noise octave is in [-1,1], so no
    surface exists above ``env`` (plus the volumetric warp tail)."""
    amps_abs = jnp.float32(0.0)
    for k in range(cfg.num_octaves):
        amps_abs = amps_abs + jnp.abs(sc(pk.AMPS + k))
    env = sc(pk.HEIGHT_OFFSET) + jnp.abs(sc(pk.HEIGHT_SCALE)) * amps_abs
    if cfg.volumetric:
        tail = float(sum(WARP_GAIN**k for k in range(cfg.warp_octaves)))
        env = env + jnp.abs(sc(pk.WARP_AMP)) * tail
    return env + cfg.hit_eps


def _block_trace(sc, seed, cfg: RenderConfig, o, d, valid, t0p=None):
    """Envelope entry + march (chunked early exit) + bracketed-Newton polish
    + residual verdict + shade for one block's rays.

    Rays starting above the certified envelope fast-forward to it
    analytically (or miss at once if heading up), so sky lanes never crawl
    while terrain lanes finish. With ``t0p`` (depth priming) each ray starts
    at max(envelope entry, its prime). Masks are f32 0/1 multiplied into
    the update arithmetic. Returns ((c0, c1, c2), t, hitf, steps_exec) —
    ``steps_exec`` is the i32 scalar count of march steps this BLOCK
    executed (every lane of the block pays it: the divergence tax).
    """
    dx, dy, dz = d
    field_grad_at, field_at = _field_fns(sc, seed, cfg, o, d)
    env = _envelope(sc, cfg)
    oy = sc(pk.POS + 1)

    t_enter = (env - oy) / jnp.where(dy < 0.0, dy, 1.0)
    above = oy > env  # traced scalar, broadcasts
    t0 = jnp.where(
        above & (dy < 0.0),
        jnp.clip(t_enter, cfg.t_min, cfg.t_max),
        jnp.full(dy.shape, cfg.t_min, jnp.float32),
    )
    t0 = jnp.where(above & (dy >= 0.0), cfg.t_max, t0)
    prev0 = t0
    if t0p is not None:
        # Depth priming: start at the coarse prepass's conservative bound
        # (max keeps the envelope fast-forward when it is further along).
        # prev0 one pull-back factor below keeps the Newton bracket
        # non-degenerate on immediate hits — mirrors ops/march.py.
        t0 = jnp.maximum(t0, t0p)
        prev0 = jnp.maximum(t0 * _PRIME_PREV_PULLBACK, cfg.t_min)
    # Padded lanes (past the band's last row or column) never march.
    active0 = jnp.where(valid & (t0 < cfg.t_max), 1.0, 0.0)
    hit0 = jnp.zeros_like(t0)
    budget = cfg.max_steps
    chunk = cfg.march_chunk or MARCH_CHUNK_DEFAULT
    num_chunks = pl.cdiv(budget, chunk)

    eps_m = cfg.hit_eps * cfg.march_eps_scale

    def march_step(s):
        t, prev_t, hit, active = s
        f = field_at(t)
        is_hit = jnp.where(f < eps_m * t, active, 0.0)
        advance = active - is_hit  # is_hit ⊆ active
        # Envelope escape: above the bound and not descending → certain miss.
        escape = jnp.where((oy + t * dy > env) & (dy >= 0.0), advance, 0.0)
        advance = advance - escape
        step = jnp.maximum(cfg.step_relax * f, cfg.hit_eps)
        if cfg.step_floor_t > 0.0:
            # Screen-space step floor: never crawl slower than ~a fraction
            # of the pixel footprint; oversteps land at f<0 and the
            # bracketed Newton polish pulls them back to the exact root.
            step = jnp.maximum(step, cfg.step_floor_t * t)
        t_new = jnp.minimum(t + step * advance, cfg.t_max)
        t_new = jnp.where(escape > 0.0, cfg.t_max, t_new)
        prev_new = jnp.where(advance > 0.0, t, prev_t)
        hit_new = jnp.maximum(hit, is_hit)
        active_new = jnp.where(t_new < cfg.t_max, advance, 0.0)
        return t_new, prev_new, hit_new, active_new

    if cfg.march_mode == "fixed":
        # No early exit — one flat fori_loop over the budget.
        t, prev_t, hitf, _ = jax.lax.fori_loop(
            0, budget, lambda _, s: march_step(s), (t0, prev0, hit0, active0)
        )
        steps_exec = jnp.int32(budget)
    else:
        def chunk_body(carry):
            c, t, prev_t, hit, active = carry
            t, prev_t, hit, active = jax.lax.fori_loop(
                0, chunk, lambda _, s: march_step(s), (t, prev_t, hit, active)
            )
            return c + 1, t, prev_t, hit, active

        def chunk_cond(carry):
            c, _, _, _, active = carry
            return (c < num_chunks) & (jnp.max(active) > 0.0)

        c_fin, t, prev_t, hitf, _ = jax.lax.while_loop(
            chunk_cond, chunk_body, (jnp.int32(0), t0, prev0, hit0, active0)
        )
        steps_exec = c_fin * chunk
    hit = hitf > 0.5

    # --- bracketed safeguarded-Newton polish (mirrors ops/march.py) --------
    # As a fori_loop, not unrolled Python: each refine iteration inlines a
    # full gradient field evaluation, and straight-line kernel size is
    # compile time.
    def refine_once(x, lo, hi):
        f, gx, gy, gz, _ = field_grad_at(x)
        denom = gx * dx + gy * dy + gz * dz  # ∇f · d
        safe = jnp.abs(denom) > _DENOM_EPS
        newton = x - jnp.where(safe, f / jnp.where(safe, denom, 1.0), 0.0)
        lo = jnp.where(f > 0.0, x, lo)
        hi = jnp.where(f <= 0.0, x, hi)
        # Clamp (not bisect) into the bracket: clipping is continuous in the
        # inputs, so t(θ) stays smooth for well-behaved pixels (they never
        # clip and follow exact Newton), while divergent steps saturate at
        # the bracket edge instead of flying off.
        x_new = jnp.clip(newton, lo, jnp.minimum(hi, cfg.t_max))
        x = jnp.where(hit & safe, jnp.maximum(x_new, cfg.t_min), x)
        return x, lo, hi

    # First iteration also derives the bracket's upper bound from the local
    # descent rate (the first Newton estimate with 25% margin).
    f0, gx0, gy0, gz0, _ = field_grad_at(t)
    denom0 = gx0 * dx + gy0 * dy + gz0 * dz
    down0 = jnp.maximum(-denom0, _BWD_DENOM_MIN)
    hi = t + jnp.maximum(f0, 0.0) / down0 * 1.25 + cfg.hit_eps
    lo = prev_t
    safe0 = jnp.abs(denom0) > _DENOM_EPS
    newton0 = t - jnp.where(safe0, f0 / jnp.where(safe0, denom0, 1.0), 0.0)
    lo = jnp.where(f0 > 0.0, t, lo)
    hi = jnp.where(f0 <= 0.0, t, hi)
    x0r = jnp.clip(newton0, lo, jnp.minimum(hi, cfg.t_max))
    x = jnp.where(hit & safe0, jnp.maximum(x0r, cfg.t_min), t)

    x, _, _ = jax.lax.fori_loop(
        0, cfg.newton_iters - 1, lambda _, s: refine_once(*s), (x, lo, hi)
    )
    t = jnp.where(hit, x, t)

    # --- final field eval: shading normals + residual hit verdict ----------
    f_fin, gx, gy, gz, h = field_grad_at(t)
    if cfg.march_eps_scale != 1.0:
        # The march stopped at the loosened eps_m; the Newton polish brings
        # true hits (well) under the strict epsilon. Rays whose polished
        # residual is still large are near-misses the loose march flagged
        # prematurely — reject them so silhouettes don't dilate.
        hitf = hitf * jnp.where(f_fin < _RESIDUAL_SLACK * cfg.hit_eps * t, 1.0, 0.0)
        hit = hitf > 0.5

    colors = _shade_from_grads(sc, cfg, t, hit, d, (gx, gy, gz, h))
    return colors, t, hitf, steps_exec


def _trace_kernel(
    prm_ref,
    seed_ref,
    *refs,
    cfg: RenderConfig,
    local_h: int,
    primed: bool,
    debug_steps: bool,
):
    """One (block_h, block_w) pixel block: full raygen+march+shade.

    With ``primed`` an extra INPUT ref (first in ``refs``) carries the
    depth-prime plane (cfg.prime_ds): per-pixel conservative march-start
    distances from the coarse prepass; lanes primed to t_max never march.
    With ``debug_steps`` a fourth OUTPUT ref, one element per block,
    receives the block's executed march-step count.
    """
    if primed:
        t0p_ref, *refs = refs
    color_ref, t_ref, hit_ref, *dbg_refs = refs
    seed = seed_ref[0]
    i = pl.program_id(0)
    j = pl.program_id(1)

    def sc(k):
        return prm_ref[k]

    o, d = _raygen(sc, cfg, i, j)
    rows, cols = _block_rc(cfg, i, j)
    valid = (rows < local_h) & (cols < cfg.width)
    t0p = t0p_ref[...] if primed else None
    (c0, c1, c2), t, hitf, steps_exec = _block_trace(
        sc, seed, cfg, o, d, valid, t0p
    )
    color_ref[0, :, :] = c0
    color_ref[1, :, :] = c1
    color_ref[2, :, :] = c2
    t_ref[...] = t
    hit_ref[...] = hitf
    if debug_steps:
        dbg_refs[0][0, 0] = steps_exec


def _trace_bwd_kernel(
    prm_ref,
    seed_ref,
    t_ref,
    hit_ref,
    g_ref,
    pbar_ref,
    *,
    cfg: RenderConfig,
    n_params: int,
):
    """Fused backward block: output cotangent → this block's partial
    packed-parameter cotangents (one (n_pad,) vector; XLA sums the blocks).

    Two channels, identical math to the XLA checkpoint backward
    (ops/render.py:render_from_checkpoint + ops/march.py:_march_bwd_core):

    1. **Shade channel**: jax.vjp of raygen+shade (at the saved t) w.r.t.
       every packed scalar AND w.r.t. t — each scalar's cotangent is the
       block-reduced sum, t̄ a per-pixel block.
    2. **March channel (implicit function)**: scale = −t̄ / min(∇f·d,
       −_BWD_DENOM_MIN) at hits, pulled back through one field evaluation
       f(o(θ) + t·d(θ), θ) w.r.t. θ — covering noise parameters AND the
       camera chain (∂t/∂o, ∂t/∂d of ops/march.py in packed coordinates).
    """
    seed = seed_ref[0]
    i = pl.program_id(0)
    j = pl.program_id(1)
    t = t_ref[...]
    hit = hit_ref[...] > 0.5
    g = (g_ref[0, :, :], g_ref[1, :, :], g_ref[2, :, :])
    theta = tuple(prm_ref[k] for k in range(n_params))

    def color_of(th, t):
        sc = lambda k: th[k]  # noqa: E731
        o, d = _raygen(sc, cfg, i, j)
        field_grad_at, _ = _field_fns(sc, seed, cfg, o, d)
        return _shade_block(sc, cfg, t, hit, d, field_grad_at)

    _, pull_shade = jax.vjp(color_of, theta, t)
    th_bar, t_bar = pull_shade(g)

    # March channel. ∇f·d at the saved hit (no gradient through this —
    # matches _march_bwd_core, where denom is a forward value).
    sc0 = lambda k: theta[k]  # noqa: E731
    o0, d0 = _raygen(sc0, cfg, i, j)
    field_grad_at0, _ = _field_fns(sc0, seed, cfg, o0, d0)
    _, gx, gy, gz, _ = field_grad_at0(t)
    denom = jnp.minimum(gx * d0[0] + gy * d0[1] + gz * d0[2], -_BWD_DENOM_MIN)
    scale = jnp.where(hit, -t_bar / denom, 0.0)

    def f_of(th):
        sc = lambda k: th[k]  # noqa: E731
        o, d = _raygen(sc, cfg, i, j)
        _, field_at = _field_fns(sc, seed, cfg, o, d)
        return field_at(t)

    _, pull_march = jax.vjp(f_of, theta)
    (th_bar2,) = pull_march(scale)

    # Scatter the scalars into this block's partial vector by select (a
    # Triton tensor cannot be indexed element by element).
    k_idx = jax.lax.broadcasted_iota(jnp.int32, pbar_ref.shape, 2)
    acc = jnp.zeros(pbar_ref.shape, jnp.float32)
    for k in range(n_params):
        acc = jnp.where(k_idx == k, th_bar[k] + th_bar2[k], acc)
    pbar_ref[...] = acc


def _check_platform(cfg: RenderConfig) -> None:
    """The kernels compile only for the GPU; elsewhere they run only when
    a caller explicitly asks for the Pallas interpreter."""
    if not cfg.interpret and jax.default_backend() != "gpu":
        raise ValueError(
            f"the fused Pallas kernels compile only for the GPU (backend is "
            f"{jax.default_backend()!r}); use use_pallas=False for the XLA "
            f"path, or interpret=True to run the kernel in the interpreter"
        )


def _call(kernel, cfg: RenderConfig, name: str, **kw):
    return pl.pallas_call(
        kernel,
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=cfg.num_warps, num_stages=1
        ),
        interpret=cfg.interpret,
        name=name,
        **kw,
    )


def _grid(cfg: RenderConfig, h: int) -> tuple[int, int]:
    return pl.cdiv(h, cfg.block_h), pl.cdiv(cfg.width, cfg.block_w)


def _pad_to(x, hp: int, wp: int, value):
    h, w = x.shape[-2:]
    if (h, w) == (hp, wp):
        return x
    pad = [(0, 0)] * (x.ndim - 2) + [(0, hp - h), (0, wp - w)]
    return jnp.pad(x, pad, constant_values=value)


def pallas_prime_map(
    scene: Scene, cfg: RenderConfig, row0=0.0, local_height: int | None = None
) -> jax.Array:
    """Depth-prime map (cfg.prime_ds > 0) from a kernel coarse pass.

    The coarse pass renders 1/ds resolution (prime_ds=0 in the coarse cfg
    ends the recursion) with one halo row above and below, then the shared
    conservative 3×3-neighborhood-min expansion (ops/march.py:
    prime_from_coarse) — the same recipe as the pure-XLA
    ops/render.py:prime_map_jax, so band-sharded priming equals full-frame
    priming."""
    ds = cfg.prime_ds
    h = cfg.height if local_height is None else local_height
    check_prime_band(cfg, row0, h)
    _, t_c, _ = _render_pallas_raw(
        scene, coarse_prime_cfg(cfg), row0 / ds - 1.0, h // ds + 2
    )
    return prime_from_coarse(t_c, cfg)


def _render_pallas_raw(
    scene: Scene,
    cfg: RenderConfig,
    row0=0.0,
    local_height: int | None = None,
    debug_steps: bool = False,
):
    """Launch the fused kernel over the block grid. Returns (color, t, hit) —
    plus a (grid_h, grid_w) i32 array of per-block executed march-step
    counts when ``debug_steps`` (the measured divergence tax).

    ``row0``/``local_height`` select a row band of the full cfg.height image
    (the shard_map tile-sharding unit); defaults render the whole frame.
    """
    _check_platform(cfg)
    h = cfg.height if local_height is None else local_height
    w = cfg.width
    bh, bw = cfg.block_h, cfg.block_w
    grid = _grid(cfg, h)
    hp, wp = grid[0] * bh, grid[1] * bw
    primed = bool(cfg.prime_ds)
    packed, seed = pk.pack_scene(scene, cfg.height, w, row0)
    n_pad = packed.shape[0]

    in_specs = [
        pl.BlockSpec((n_pad,), lambda i, j: (0,)),
        pl.BlockSpec((1,), lambda i, j: (0,)),
    ]
    inputs = [packed, seed]
    if primed:
        t0p = pallas_prime_map(scene, cfg, row0, h)
        in_specs.append(pl.BlockSpec((bh, bw), lambda i, j: (i, j)))
        inputs.append(_pad_to(t0p, hp, wp, cfg.t_max))

    out_specs = [
        pl.BlockSpec((3, bh, bw), lambda i, j: (0, i, j)),
        pl.BlockSpec((bh, bw), lambda i, j: (i, j)),
        pl.BlockSpec((bh, bw), lambda i, j: (i, j)),
    ]
    out_shape = [
        jax.ShapeDtypeStruct((3, hp, wp), jnp.float32),
        jax.ShapeDtypeStruct((hp, wp), jnp.float32),
        jax.ShapeDtypeStruct((hp, wp), jnp.float32),
    ]
    if debug_steps:
        out_specs.append(pl.BlockSpec((1, 1), lambda i, j: (i, j)))
        out_shape.append(jax.ShapeDtypeStruct(grid, jnp.int32))

    kernel = functools.partial(
        _trace_kernel, cfg=cfg, local_h=h, primed=primed,
        debug_steps=debug_steps,
    )
    outs = _call(
        kernel, cfg, "trace_fwd", grid=grid, in_specs=in_specs,
        out_specs=out_specs, out_shape=out_shape,
    )(*inputs)
    color, t, hit_f = (x[..., :h, :w] for x in outs[:3])
    result = (jnp.moveaxis(color, 0, -1), t, hit_f > 0.5)
    if debug_steps:
        return result + (outs[3],)
    return result


def _backward_pallas(
    scene: Scene,
    cfg: RenderConfig,
    t: jax.Array,
    hit: jax.Array,
    g: jax.Array,
    row0,
    local_height: int | None,
):
    """Fused Pallas backward: (saved t/hit, cotangent image) → scene pytree
    cotangents, via per-block packed-parameter partials summed by XLA."""
    _check_platform(cfg)
    h = cfg.height if local_height is None else local_height
    w = cfg.width
    bh, bw = cfg.block_h, cfg.block_w
    grid = _grid(cfg, h)
    hp, wp = grid[0] * bh, grid[1] * bw
    packed, seed = pk.pack_scene(scene, cfg.height, w, row0)
    n_pad = packed.shape[0]
    n_params = pk.AMPS + cfg.num_octaves

    kernel = functools.partial(_trace_bwd_kernel, cfg=cfg, n_params=n_params)
    partials = _call(
        kernel, cfg, "trace_bwd", grid=grid,
        in_specs=[
            pl.BlockSpec((n_pad,), lambda i, j: (0,)),
            pl.BlockSpec((1,), lambda i, j: (0,)),
            pl.BlockSpec((bh, bw), lambda i, j: (i, j)),
            pl.BlockSpec((bh, bw), lambda i, j: (i, j)),
            pl.BlockSpec((3, bh, bw), lambda i, j: (0, i, j)),
        ],
        out_specs=pl.BlockSpec((1, 1, n_pad), lambda i, j: (i, j, 0)),
        out_shape=jax.ShapeDtypeStruct(grid + (n_pad,), jnp.float32),
    )(
        packed, seed,
        _pad_to(t, hp, wp, 1.0),
        _pad_to(hit.astype(jnp.float32), hp, wp, 0.0),
        _pad_to(jnp.moveaxis(g, -1, 0), hp, wp, 0.0),
    )
    pbar = jnp.sum(partials, axis=(0, 1))

    _, pull = jax.vjp(
        lambda s: pk.pack_scene(s, cfg.height, w, row0)[0], scene
    )
    (scene_bar,) = pull(pbar)
    return scene_bar


@functools.partial(jax.custom_vjp, nondiff_argnums=(0, 1))
def render_pallas_cfg(
    cfg: RenderConfig, local_height: int | None, scene: Scene, row0
) -> jax.Array:
    """Differentiable fused render: forward on the trace kernel, backward on
    the fused backward kernel (cfg.pallas_bwd) or the checkpointed pure-JAX
    path — the same gradients either way, asserted in tests/test_pallas.py."""
    color, _, _ = _render_pallas_raw(scene, cfg, row0, local_height)
    return color


def _rp_fwd(cfg, local_height, scene, row0):
    color, t, hit = _render_pallas_raw(scene, cfg, row0, local_height)
    return color, (scene, row0, t, hit)


def _rp_bwd(cfg, local_height, res, g):
    scene, row0, t, hit = res
    row0_bar = jnp.zeros_like(jnp.asarray(row0, jnp.float32))
    if cfg.pallas_bwd:
        scene_bar = _backward_pallas(scene, cfg, t, hit, g, row0, local_height)
        return scene_bar, row0_bar
    _, pullback = jax.vjp(
        lambda s: render_from_checkpoint(s, cfg, t, hit, row0, local_height),
        scene,
    )
    (scene_bar,) = pullback(g)
    return scene_bar, row0_bar


render_pallas_cfg.defvjp(_rp_fwd, _rp_bwd)


def render_pallas(
    scene: Scene, cfg: RenderConfig, row0=0.0, local_height: int | None = None
) -> jax.Array:
    return render_pallas_cfg(cfg, local_height, scene, row0)

"""Adaptive-step sphere-trace march with an implicit-function custom VJP.

Forward: the role of the reference's ``tracescreen.hlsl`` march loop
(BASELINE.json:5,8 "adaptive step sphere-trace"): per pixel, advance
t ← t + relax·f(o + t·d) until f < ε·t (hit) or t > t_max (miss), then a few
Newton refinement steps polish the hit distance using the analytic field
gradient. Vectorized over all pixels: one ``while_loop`` over the whole
frame with per-lane active masks (masked lanes are the array-program
equivalent of the reference's per-thread ``break``), exiting when every
lane is done.

Backward: the driver contract calls for a checkpointed re-march backward
(BASELINE.json:5). We implement something strictly cheaper and exact: at a
hit, t(θ, o, d) satisfies f(o + t·d, θ) = 0, so by the implicit function
theorem

    ∂t/∂θ = -(∂f/∂θ) / (∇p f · d)
    ∂t/∂o = -∇p f / (∇p f · d)
    ∂t/∂d = -t·∇p f / (∇p f · d)

— one field evaluation at the saved hit point replaces the entire re-march.
The saved per-pixel hit t IS the checkpoint (``march_from_saved`` re-uses it
for the Pallas forward kernel's backward pass). Misses and degenerate grazing
hits (|∇f·d| ≈ 0, i.e. silhouettes) get zero gradient; the silhouette
discontinuity is genuinely non-differentiable (SURVEY.md §8 hard-part 1) and
the finite-difference harness masks those pixels.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from gpgpuraytrace.models.scene import NoiseParams, RenderConfig
from gpgpuraytrace.ops.field import envelope_height, field, field_and_grad

_DENOM_EPS = 1e-4
# Backward-pass conditioning: at a legitimate hit the ray crosses the surface
# from above, so ∇f·d < 0. As |∇f·d| → 0 (grazing / silhouette rays) the
# implicit gradient 1/(∇f·d) blows up; those few pixels would dominate every
# summed pixel-loss gradient with near-random sign (the true derivative is
# undefined at the silhouette). Clamping the denominator to at most
# -_BWD_DENOM_MIN bounds the bias instead of admitting unbounded variance —
# the standard conditioning trick in differentiable sphere tracing.
_BWD_DENOM_MIN = 1e-2
# Depth priming (cfg.prime_ds): the bracket lower bound handed to the Newton
# polish for lanes that hit on their first primed sample. Decoupled from
# prime_margin so margin=1.0 (start exactly at the neighborhood min) still
# gives immediate hits a non-degenerate bracket to pull back into — with
# lo = t0 a primed lane landing inside the surface could not be polished
# back to the root. Shared with kernels/trace.py.
_PRIME_PREV_PULLBACK = 0.9
# Residual hit verdict (march_eps_scale > 1): after the Newton polish, a hit
# must satisfy f < _RESIDUAL_SLACK·hit_eps·t — true hits converge orders of
# magnitude below this; near-misses the loosened march flagged prematurely
# stay well above it and are rejected. The slack tolerates 4-iteration Newton
# non-convergence on extreme grazing hits (a false sky hole is worse than a
# sub-pixel silhouette dilate). Shared with kernels/trace.py.
_RESIDUAL_SLACK = 2.0


def coarse_prime_cfg(cfg: RenderConfig) -> RenderConfig:
    """The coarse-prepass config for depth priming (cfg.prime_ds > 0):
    1/ds resolution, one Newton iteration (the prime only needs an
    approximate t), and a ds-scaled step floor (the floor is tied to the
    pixel footprint, which is ds× larger at the coarse pass — the prime
    margin absorbs the coarse-pixel-bounded overstep error).

    Single source of truth: the kernel path (kernels/trace.py) and the
    pure-XLA path (ops/render.py) must march the SAME coarse pass for the
    kernel-parity tests to hold."""
    ds = cfg.prime_ds
    return dataclasses.replace(
        cfg,
        height=cfg.height // ds,
        width=cfg.width // ds,
        prime_ds=0,
        newton_iters=1,
        step_floor_t=cfg.step_floor_t * ds,
    )


def check_prime_band(cfg: RenderConfig, row0, local_height: int) -> None:
    """Depth priming renders whole coarse rows: the band's height and its
    first row must be multiples of cfg.prime_ds, or the coarse ray grid
    (row0/ds − 1) would shift by a fraction of a coarse pixel and break
    band == full-frame priming. A traced row0 (the shard_map band offset,
    axis_index × local_height) is a multiple whenever local_height is."""
    ds = cfg.prime_ds
    if local_height % ds:
        raise ValueError(
            f"prime_ds={ds} must divide the local render height "
            f"{local_height} (row bands must stay whole coarse rows; "
            f"band_prime_cfg picks a factor that does)"
        )
    if not isinstance(row0, jax.core.Tracer) and float(row0) % ds:
        raise ValueError(
            f"prime_ds={ds} must divide the band's first row {row0}"
        )


def band_prime_cfg(cfg: RenderConfig, local_height: int) -> RenderConfig:
    """``cfg`` for rendering row bands of ``local_height`` rows: prime_ds
    lowered to its largest factor that divides the band height (and the
    frame), or 0 when none does. Four-way 4K bands are 540 rows, which 8
    does not divide; they prime at 4."""
    ds = cfg.prime_ds
    if not ds or local_height % ds == 0:
        return cfg
    for d in range(ds - 1, 1, -1):
        if ds % d == 0 and all(
            n % d == 0 for n in (local_height, cfg.height, cfg.width)
        ):
            return dataclasses.replace(cfg, prime_ds=d)
    return dataclasses.replace(cfg, prime_ds=0)


def prime_from_coarse(t_c_ext: jax.Array, cfg: RenderConfig) -> jax.Array:
    """Full-res march-start map from a coarse-pass t image (depth priming).

    Each fine ray starts at ``prime_margin ×`` the minimum march distance of
    its 3×3 coarse neighborhood — a conservative lower bound on where its
    own surface crossing can be, up to features thinner than the coarse
    sampling (quantified against the dense oracle in
    scripts/prime_trial.py). A neighborhood whose nine coarse rays ALL
    reached t_max (certain misses: envelope escapes and marched-out rays
    clamp there) primes to t_max exactly, so whole sky regions skip the
    fine march; budget-exhausted coarse rays keep their final t < t_max,
    which stays a valid conservative bound. ``cfg`` is the FINE config (the
    coarse one has prime_ds=0).

    ``t_c_ext`` carries ONE HALO ROW above and below the band's coarse rows
    (virtual rows −1 and H_c for the image edges — the caller renders them;
    rays there are perfectly well defined, just outside the frame). The
    halo makes band-sharded priming bit-identical to full-frame priming:
    every interior window sees its true vertical neighbors instead of a
    band-local SAME pad, so ``sharded == unsharded`` holds exactly
    (tests/test_prime.py::test_primed_band_equals_full_frame)."""
    m = jax.lax.reduce_window(
        t_c_ext,
        jnp.float32(jnp.inf),
        jax.lax.min,
        window_dimensions=(3, 3),
        window_strides=(1, 1),
        padding="SAME",
    )[1:-1, :]
    tp = jnp.where(
        m >= cfg.t_max, jnp.float32(cfg.t_max), m * cfg.prime_margin
    )
    tp = jnp.clip(tp, cfg.t_min, cfg.t_max)
    ds = cfg.prime_ds
    return jnp.repeat(jnp.repeat(tp, ds, axis=0), ds, axis=1)


def _march_loop(
    cfg: RenderConfig, ray_o: jax.Array, ray_d: jax.Array, noise: NoiseParams,
    t0_prime: jax.Array | None = None,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Raw march: returns (t, hit, steps_used). Not differentiable (int loop).

    ``t0_prime`` (depth priming, cfg.prime_ds) starts each ray at
    max(envelope entry, prime map); primed-to-t_max rays never march."""
    shape = ray_o.shape[:-1]
    oy = ray_o[..., 1]
    dy = ray_d[..., 1]

    # Sky-envelope skip (certified, exact): no surface exists above
    # ``env``, so (a) a ray starting above it fast-forwards analytically to
    # the envelope plane (or is an immediate miss if heading up), and (b) a
    # ray that climbs above it while heading up is done — no more crossings
    # are possible. This removes the many-step sky crawl that dominates the
    # divergence tax in the fused kernel.
    env = envelope_height(noise, cfg.volumetric, cfg.warp_octaves) + cfg.hit_eps
    t_enter = jnp.where(
        dy < 0.0, (env - oy) / jnp.where(dy < 0.0, dy, 1.0), jnp.inf
    )
    t0 = jnp.where(
        oy > env,
        jnp.clip(t_enter, cfg.t_min, cfg.t_max),
        jnp.full(shape, cfg.t_min, jnp.float32),
    )
    prev0 = t0
    if t0_prime is not None:
        t0 = jnp.maximum(t0, t0_prime)
        # A primed lane may land within (or inside) the hit epsilon on its
        # first sample; prev0 one pull-back factor below gives the bracketed
        # Newton polish a non-degenerate lower bound to pull back into
        # (with prev0 = t0 the bracket degenerates to a point on
        # oversteps).
        prev0 = jnp.maximum(t0 * _PRIME_PREV_PULLBACK, cfg.t_min)
    hit0 = jnp.zeros(shape, bool)
    active0 = t0 < cfg.t_max
    steps0 = jnp.zeros(shape, jnp.int32)

    eps_m = cfg.hit_eps * cfg.march_eps_scale

    def body(_, carry):
        t, prev_t, hit, active, steps = carry
        p = ray_o + t[..., None] * ray_d
        f = field(p, noise, cfg.volumetric, cfg.warp_octaves)
        is_hit = active & (f < eps_m * t)
        advance = active & ~is_hit
        # Envelope escape: above the certified bound and not descending —
        # a certain miss; jump straight to t_max.
        escape = advance & (p[..., 1] > env) & (dy >= 0.0)
        advance = advance & ~escape
        step = jnp.maximum(cfg.step_relax * f, cfg.hit_eps)
        if cfg.step_floor_t > 0.0:
            # Screen-space step floor (mirrors kernels/trace.py): bounds the
            # grazing-ray crawl; oversteps land inside (f<0) and the
            # bracketed Newton polish resolves the exact root.
            step = jnp.maximum(step, cfg.step_floor_t * t)
        t_new = jnp.where(advance, t + step, jnp.where(escape, cfg.t_max, t))
        return (
            jnp.minimum(t_new, cfg.t_max),
            jnp.where(advance, t, prev_t),  # last t before the current one
            hit | is_hit,
            advance & (t_new < cfg.t_max),
            steps + advance.astype(jnp.int32),
        )

    # while_loop with a global early exit, not a fixed-trip fori: once every
    # lane has hit / escaped / reached t_max the remaining iterations are
    # exact no-ops (inactive lanes never change state), so exiting is
    # bitwise identical — and it lets this path benefit from depth priming
    # and the sky-envelope skip the way the kernel does. The any()
    # reduction per step is small next to a 6-octave field evaluation.
    def w_cond(carry):
        i = carry[0]
        return (i < cfg.max_steps) & jnp.any(carry[4])

    def w_body(carry):
        i, t, prev_t, hit, active, steps = carry
        t, prev_t, hit, active, steps = body(
            i, (t, prev_t, hit, active, steps)
        )
        return i + 1, t, prev_t, hit, active, steps

    _, t, prev_t, hit, _, steps = jax.lax.while_loop(
        w_cond, w_body, (jnp.int32(0), t0, prev0, hit0, active0, steps0)
    )

    # Bracketed safeguarded-Newton polish at hits. Plain Newton can diverge
    # on high-curvature (volumetric) fields; the bracket [prev_t, hi]
    # contains the crossing (f(prev_t) > 0; hi is the first Newton estimate
    # with 25% margin), and any Newton step leaving the current bracket
    # falls back to bisection. Bracket bounds tighten by sign each iteration.
    lo = prev_t
    hi = jnp.full_like(t, cfg.t_max)
    x = t
    for k in range(cfg.newton_iters):
        p = ray_o + x[..., None] * ray_d
        f, grad = field_and_grad(p, noise, cfg.volumetric, cfg.warp_octaves)
        denom = jnp.sum(grad * ray_d, axis=-1)
        down = jnp.maximum(-denom, _BWD_DENOM_MIN)  # descent rate along ray
        if k == 0:
            hi = x + jnp.maximum(f, 0.0) / down * 1.25 + cfg.hit_eps
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
    t = jnp.where(hit, x, t)
    if cfg.march_eps_scale != 1.0:
        # Residual hit verdict: re-impose the strict epsilon after the polish
        # (see _RESIDUAL_SLACK above; mirrors kernels/trace.py).
        p = ray_o + t[..., None] * ray_d
        f_fin = field(p, noise, cfg.volumetric, cfg.warp_octaves)
        hit = hit & (f_fin < _RESIDUAL_SLACK * cfg.hit_eps * t)
    return t, hit, steps


def _march_bwd_core(
    cfg: RenderConfig,
    ray_o: jax.Array,
    ray_d: jax.Array,
    noise: NoiseParams,
    t: jax.Array,
    hit: jax.Array,
    ct_t: jax.Array,
):
    """Shared implicit-function VJP: cotangent on t → (ō, d̄, noise_bar)."""
    p = jax.lax.stop_gradient(ray_o + t[..., None] * ray_d)
    _, grad_p = field_and_grad(p, noise, cfg.volumetric, cfg.warp_octaves)
    denom = jnp.sum(grad_p * ray_d, axis=-1)
    # Only downward crossings are true hits; clamp |denom| away from zero.
    denom = jnp.minimum(denom, -_BWD_DENOM_MIN)
    scale = jnp.where(hit, -ct_t / denom, 0.0)

    _, pullback = jax.vjp(
        lambda n: field(p, n, cfg.volumetric, cfg.warp_octaves), noise
    )
    (noise_bar,) = pullback(scale)
    o_bar = scale[..., None] * grad_p
    d_bar = (scale * t)[..., None] * grad_p
    return o_bar, d_bar, noise_bar


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def march(cfg: RenderConfig, ray_o, ray_d, noise):
    """Differentiable sphere trace: (t, hit) per pixel."""
    t, hit, _ = _march_loop(cfg, ray_o, ray_d, noise)
    return t, hit


def _march_fwd(cfg, ray_o, ray_d, noise):
    t, hit, _ = _march_loop(cfg, ray_o, ray_d, noise)
    return (t, hit), (ray_o, ray_d, noise, t, hit)


def _march_bwd(cfg, res, cotangents):
    ray_o, ray_d, noise, t, hit = res
    ct_t, _ = cotangents  # hit is boolean → float0 cotangent, ignored
    return _march_bwd_core(cfg, ray_o, ray_d, noise, t, hit, ct_t)


march.defvjp(_march_fwd, _march_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def march_from_saved(cfg: RenderConfig, ray_o, ray_d, noise, t_saved, hit_saved):
    """Checkpoint-resume march: forward is a no-op returning the saved hit
    distance (the per-pixel checkpoint written by the fused Pallas forward
    kernel, BASELINE.json:5 "checkpointed re-march backward"); backward is the
    same implicit-function VJP as ``march``. Gradients w.r.t. t_saved are not
    propagated (it is the checkpoint, not an input)."""
    return t_saved, hit_saved


def _mfs_fwd(cfg, ray_o, ray_d, noise, t_saved, hit_saved):
    return (t_saved, hit_saved), (ray_o, ray_d, noise, t_saved, hit_saved)


def _mfs_bwd(cfg, res, cotangents):
    ray_o, ray_d, noise, t, hit = res
    ct_t, _ = cotangents
    o_bar, d_bar, noise_bar = _march_bwd_core(cfg, ray_o, ray_d, noise, t, hit, ct_t)
    return o_bar, d_bar, noise_bar, jnp.zeros_like(t), None


march_from_saved.defvjp(_mfs_fwd, _mfs_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def march_primed(cfg: RenderConfig, ray_o, ray_d, noise, t0_prime):
    """Depth-primed differentiable sphere trace (cfg.prime_ds): the march
    starts from the coarse-prepass prime map. The prime is a march-start
    accelerator, not an input the result depends on smoothly — the Newton
    polish converges to the same root from any start outside the surface —
    so ``t0_prime`` carries zero gradient (like the checkpoint of
    ``march_from_saved``); the backward is the same implicit-function VJP."""
    t, hit, _ = _march_loop(cfg, ray_o, ray_d, noise, t0_prime)
    return t, hit


def _mp_fwd(cfg, ray_o, ray_d, noise, t0_prime):
    t, hit, _ = _march_loop(cfg, ray_o, ray_d, noise, t0_prime)
    return (t, hit), (ray_o, ray_d, noise, t, hit)


def _mp_bwd(cfg, res, cotangents):
    ray_o, ray_d, noise, t, hit = res
    ct_t, _ = cotangents
    o_bar, d_bar, noise_bar = _march_bwd_core(cfg, ray_o, ray_d, noise, t, hit, ct_t)
    return o_bar, d_bar, noise_bar, jnp.zeros_like(t)


march_primed.defvjp(_mp_fwd, _mp_bwd)


def march_with_stats(cfg: RenderConfig, ray_o, ray_d, noise, t0_prime=None):
    """Non-differentiable march that also reports per-pixel step counts
    (observability: step-count histograms in the bench harness).

    A primed config REQUIRES the prime map: silently marching unprimed
    under a cfg that says prime_ds=8 would report stats for a non-shipping
    algorithm (the hazard that confounded three measurement scripts when
    priming became the default — code-review round 5). Callers measuring
    the raw march deliberately must pin prime_ds=0 in their config."""
    if cfg.prime_ds and t0_prime is None:
        raise ValueError(
            f"march_with_stats: cfg primes (prime_ds={cfg.prime_ds}) but no "
            f"t0_prime was passed — stats would describe the UNPRIMED march "
            f"while the config ships the primed one. Pass the prime map "
            f"(ops.render.prime_map_jax) or pin prime_ds=0 to measure the "
            f"raw march deliberately."
        )
    return _march_loop(cfg, ray_o, ray_d, noise, t0_prime)

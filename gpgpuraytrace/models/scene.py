"""Scene parameter pytrees — the "model" of this framework.

The reference's tweakable state lived in per-frame D3D11 constant buffers and
(likely) WPF-editable variables (BASELINE.json:5 "per-frame constant buffers
→ sharded pytrees"). Here every scene quantity is a leaf of a JAX pytree:
jit-traceable (camera updates never recompile), shardable/replicable under a
``Mesh``, and directly optimizable (the ``fit`` loop takes gradients w.r.t.
these leaves; BASELINE.json:9).

Static compile-time facts (image size, march step counts, octave count) live
in ``RenderConfig``, a hashable frozen dataclass passed as a static argument.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


def _pytree_dataclass(cls):
    """Frozen dataclass registered as a pytree whose fields are all leaves."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    return jax.tree_util.register_dataclass(
        cls, data_fields=[f.name for f in dataclasses.fields(cls)],
        meta_fields=[],
    )

# Default march-chunk length for the kernel's chunked-early-exit march.
# Single source of truth: kernels/trace.py falls back to it, and
# RenderConfig validates against the same value when march_chunk=0 ("use
# the default"), so the divisibility check cannot be bypassed with 0.
MARCH_CHUNK_DEFAULT = 4


@_pytree_dataclass
class NoiseParams:
    """Terrain field parameters (the role of the reference's noise constants).

    ``amplitudes`` are the per-octave fBm weights — the primary learnable
    terrain parameters (BASELINE.json:9 "recover fBm amplitudes").
    """

    amplitudes: jnp.ndarray  # (num_octaves,) per-octave fBm amplitude
    lacunarity: jnp.ndarray  # scalar frequency multiplier between octaves
    height_scale: jnp.ndarray  # scalar terrain height scale
    height_offset: jnp.ndarray  # scalar terrain base height
    horizontal_scale: jnp.ndarray  # scalar ground-plane frequency
    seed: jnp.ndarray = dataclasses.field(
        default_factory=lambda: jnp.int32(7)
    )  # integer lattice seed (not differentiable)
    # Volumetric mode (RenderConfig.volumetric): 3D warp giving overhangs.
    warp_amplitude: jnp.ndarray = dataclasses.field(
        default_factory=lambda: jnp.float32(0.0)
    )  # world-units displacement amplitude
    warp_frequency: jnp.ndarray = dataclasses.field(
        default_factory=lambda: jnp.float32(0.25)
    )  # 1/world-units base frequency of the 3D warp


@_pytree_dataclass
class Camera:
    """Flythrough camera (the role of camerarays.hlsl's constant buffer).

    Differentiable w.r.t. ``position``, ``yaw``, ``pitch`` (BASELINE.json:9
    "recover ... camera pose").
    """

    position: jnp.ndarray  # (3,) world position
    yaw: jnp.ndarray  # scalar, radians, 0 = +z
    pitch: jnp.ndarray  # scalar, radians, positive looks up
    fov_y: jnp.ndarray  # scalar, vertical field of view in radians


@_pytree_dataclass
class Materials:
    """Lighting / material / atmosphere constants (tracescreen.hlsl's role)."""

    sun_dir: jnp.ndarray  # (3,) direction TOWARD the sun (normalized on use)
    sun_color: jnp.ndarray  # (3,)
    ambient_color: jnp.ndarray  # (3,)
    albedo_low: jnp.ndarray  # (3,) grass/dirt color at gentle slopes
    albedo_high: jnp.ndarray  # (3,) rock color at steep slopes
    snow_color: jnp.ndarray  # (3,) above snow_height
    snow_height: jnp.ndarray  # scalar
    fog_color: jnp.ndarray  # (3,)
    fog_density: jnp.ndarray  # scalar
    sky_zenith: jnp.ndarray  # (3,)
    sky_horizon: jnp.ndarray  # (3,)


@_pytree_dataclass
class Scene:
    """Full differentiable parameter set: params → image is a pure function."""

    noise: NoiseParams
    camera: Camera
    materials: Materials


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static (compile-time) render settings — hashable, passed static to jit.

    The march-loop structure mirrors the reference's sphere tracer
    (tracescreen.hlsl role, BASELINE.json:8 "adaptive step sphere-trace"):
    ``max_steps`` iterations of t += relax * f(p), with a screen-space-scaled
    hit epsilon.
    """

    height: int = 512
    width: int = 512
    max_steps: int = 128
    t_min: float = 0.05
    t_max: float = 200.0
    hit_eps: float = 1e-3  # hit when f(p) < hit_eps * t (screen-space scaled)
    step_relax: float | None = None  # march step factor: step = relax·f.
    # None (the default) resolves per mode in __post_init__: 1.0 for the
    # heightfield, 0.9 for volumetric — the defaults live here, not in any
    # one frontend, so a directly constructed RenderConfig(volumetric=True)
    # gets the volumetric value too. The heightfield is not an SDF, so any
    # relax can overstep — but an overstep lands inside the surface (f<0)
    # where the bracketed Newton polish recovers the exact root, so the
    # march tolerates relax ≈ 1. Against a 1024-step dense oracle at
    # 512²/6 octaves (scripts/relax_sweep.py), 1.0 has image error
    # statistically identical to 0.7 (0.12% vs 0.13% of pixels off by
    # >0.05, no silhouette dilation); 1.1 has 3.7× more off pixels. On
    # much rougher terrain (slow amplitude decay × large height_scale)
    # every relax skips ridges — lower this knob (and raise max_steps)
    # there. Frozen goldens pin 0.7 explicitly.
    num_octaves: int = 6
    use_pallas: bool | None = None  # fused Pallas kernel vs pure-XLA path.
    # None resolves from the platform in __post_init__: the kernel on the
    # GPU, the XLA path elsewhere. An explicit True off the GPU needs
    # interpret=True; the kernel wrapper raises otherwise.
    pallas_bwd: bool = True  # fused Pallas backward kernel vs XLA re-shade
    interpret: bool = False  # Pallas interpreter mode (CPU tests)
    march_mode: str = "chunked"  # "chunked": block-wide early exit checked
    # every march_chunk steps; "fixed": a plain max_steps loop with no exit
    # checks (the timing / dense-oracle instrument).
    volumetric: bool = False  # 3D-warped terrain volume (overhangs)
    warp_octaves: int = 2  # fBm octaves of the volumetric warp
    block_h: int = 8  # kernel block rows (power of two)
    block_w: int = 16  # kernel block columns (power of two): one program
    # marches block_h × block_w rays and exits when all are done. 8×16 at
    # 4 warps is one ray per thread; the block/warp/chunk sweep on the
    # H100 (PERF.md) found one ray per thread fastest, and 128-ray blocks
    # ahead of 256 (less of the block waits on its slowest ray).
    num_warps: int = 4  # warps per kernel program (Triton CompilerParams)
    newton_iters: int = 3  # bracketed-Newton polish iterations at hits.
    # Each inlines a full gradient field evaluation. Against the dense
    # oracle (scripts/relax_sweep.py --newton, 512²/6 oct): 3 is
    # quality-identical to 4 on every metric (off-px 355 vs 346 of 262k,
    # mean err 2.6e-4 vs 2.5e-4); 6 gains nothing over 4 (converged); 2
    # loosens the hit-t tail (t-err>0.05 pixels +27%, image metrics
    # unchanged) — a preview knob.
    march_chunk: int = 4  # steps between block-wide early-exit checks in
    # the kernel march (smaller = exit sooner, but more block reductions;
    # 4 led 8 and 16 in the sweep); 0 means MARCH_CHUNK_DEFAULT.
    march_eps_scale: float = 1.0  # >1 loosens the march's stop threshold to
    # march_eps_scale × hit_eps × t, with a post-polish residual check
    # re-imposing the strict verdict. Tangent-incidence pixels cannot be
    # Newton-polished and get rejected (~0.5% sky holes vs ground truth) —
    # a preview-quality speed knob, NOT the default.
    step_floor_t: float = 4e-3  # t-proportional march step floor:
    # step = max(relax·f, hit_eps, step_floor_t·t). Bounds the grazing-ray
    # crawl (steps can't shrink below ~a quarter pixel footprint of forward
    # progress at 512px) with *screen-space-bounded* error: an overstep
    # lands inside the surface (f<0), which the bracketed Newton polish
    # resolves to the exact root; only ~2-pixel-scale silhouette slivers can
    # be skipped (0 false hits / 5 hole px per 8K px vs a 1024-step dense
    # ground truth at 512²/6 octaves). 0 disables (the classic crawl;
    # frozen goldens use this).
    prime_ds: int | None = None  # depth-priming coarse prepass: first march
    # a (H/ds, W/ds) coarse pass, then start each full-res ray at
    # prime_margin × the minimum march distance of its 3×3 coarse
    # neighborhood (misses prime to t_max and skip the march entirely when
    # the whole neighborhood missed). Cuts executed march steps at the cost
    # of one coarse march (~1/ds² of the frame); oracle hole/off-pixel
    # counts stay flat. Not certified: a terrain feature thinner than the
    # coarse sampling that all 9 neighbors miss is skipped;
    # scripts/prime_trial.py quantifies exactly that against the dense
    # oracle.
    # None (the default) resolves in __post_init__: 8 when the config is
    # eligible (height/width divisible by 8 and at least 64 — so the
    # coarse image is ≥ 8×8), else 0; march_mode="fixed" resolves to 0.
    # Explicit 0 disables; an explicit ds validates strictly (raises on
    # indivisible height/width). Sharded row bands that 8 does not divide
    # use a smaller factor (ops/march.py:band_prime_cfg).
    prime_margin: float = 0.95  # multiplicative pull-back on the coarse
    # neighborhood min (smaller = more conservative start, more steps).
    supersample: int = 1  # SSAA factor: render at k× and box-downsample

    def __post_init__(self) -> None:
        # Resolve the per-mode march relax (see step_relax above). Done
        # first so repr(), hashing, and every validation below see the
        # concrete float; frozen dataclass, so object.__setattr__.
        if self.step_relax is None:
            object.__setattr__(
                self, "step_relax", 0.9 if self.volumetric else 1.0
            )
        # The one place the march path is chosen from the platform.
        if self.use_pallas is None:
            object.__setattr__(
                self, "use_pallas", jax.default_backend() == "gpu"
            )
        if self.march_mode not in ("chunked", "fixed"):
            raise ValueError(
                f"march_mode={self.march_mode!r} must be 'chunked' or 'fixed'"
            )
        for name in ("block_h", "block_w", "num_warps"):
            v = getattr(self, name)
            if v < 1 or v & (v - 1):
                raise ValueError(f"{name}={v} must be a power of two")
        # The kernel's chunked march runs in whole march_chunk blocks; a
        # chunk that does not divide max_steps would silently march up to
        # chunk-1 extra steps past max_steps (diverging from the XLA path).
        # march_chunk=0 means the default chunk, so the EFFECTIVE chunk is
        # validated. Configs that never run the chunked kernel march
        # (march_mode="fixed", the pure-XLA path) are not constrained.
        if self.march_chunk < 0:
            raise ValueError(f"march_chunk={self.march_chunk} must be >= 0")
        # The first polish iteration runs unconditionally in both paths;
        # 0 or negative would silently behave like 1.
        if self.newton_iters < 1:
            raise ValueError(
                f"newton_iters={self.newton_iters} must be >= 1 (the march "
                f"always runs one polish pass; use march_eps_scale for "
                f"preview-quality speed instead)"
            )
        effective_chunk = self.march_chunk or MARCH_CHUNK_DEFAULT
        chunked = self.use_pallas and self.march_mode == "chunked"
        if chunked and self.max_steps % effective_chunk != 0:
            raise ValueError(
                f"march_chunk={self.march_chunk} (effective "
                f"{effective_chunk}) must divide max_steps={self.max_steps} "
                f"(the kernel march runs whole chunks; a remainder would "
                f"exceed max_steps)"
            )
        if self.prime_ds is None:
            ds = 8
            eligible = (
                self.height % ds == 0
                and self.width % ds == 0
                and self.height >= 8 * ds
                and self.width >= 8 * ds
            )
            object.__setattr__(self, "prime_ds", ds if eligible else 0)
        if self.prime_ds and self.march_mode != "chunked":
            # "fixed" is the timing/oracle instrument and must march every
            # step. Resolve to off (not raise) so dataclasses.replace(cfg,
            # march_mode="fixed") from a resolved chunked config keeps
            # working — the idiom every oracle harness uses.
            object.__setattr__(self, "prime_ds", 0)
        if self.prime_ds:
            if self.prime_ds < 2:
                raise ValueError(
                    f"prime_ds={self.prime_ds} must be 0 (off) or >= 2"
                )
            if self.height % self.prime_ds or self.width % self.prime_ds:
                raise ValueError(
                    f"prime_ds={self.prime_ds} must divide height="
                    f"{self.height} and width={self.width} (the coarse "
                    f"prime image upsamples by integer repeat)"
                )
            if not (0.0 < self.prime_margin <= 1.0):
                raise ValueError(
                    f"prime_margin={self.prime_margin} must be in (0, 1]"
                )


def default_scene(num_octaves: int = 6, volumetric: bool = False) -> Scene:
    """A canonical terrain scene; also the anchor for the golden images.

    Amplitudes follow the classic fBm 1/2^i decay the reference uses
    (BASELINE.json:8 "6-octave fBm terrain"). With ``volumetric`` the scene
    gets a nonzero 3D warp (overhangs); render with
    ``RenderConfig(volumetric=True)``.
    """
    f = jnp.float32
    amps = jnp.asarray([0.5 ** i for i in range(num_octaves)], jnp.float32)
    noise = NoiseParams(
        amplitudes=amps,
        lacunarity=f(2.0),
        height_scale=f(6.0),
        height_offset=f(0.0),
        horizontal_scale=f(0.05),
        seed=jnp.int32(7),
        warp_amplitude=f(1.2 if volumetric else 0.0),
        warp_frequency=f(0.3),
    )
    camera = Camera(
        position=jnp.asarray([0.0, 8.0, -14.0], jnp.float32),
        yaw=f(0.0),
        pitch=f(-0.28),
        fov_y=f(1.0471976),  # 60 degrees
    )
    materials = Materials(
        sun_dir=jnp.asarray([0.45, 0.6, 0.25], jnp.float32),
        sun_color=jnp.asarray([1.0, 0.92, 0.78], jnp.float32),
        ambient_color=jnp.asarray([0.18, 0.22, 0.30], jnp.float32),
        albedo_low=jnp.asarray([0.22, 0.34, 0.14], jnp.float32),
        albedo_high=jnp.asarray([0.38, 0.34, 0.30], jnp.float32),
        snow_color=jnp.asarray([0.92, 0.94, 0.98], jnp.float32),
        snow_height=f(4.0),
        fog_color=jnp.asarray([0.62, 0.68, 0.80], jnp.float32),
        fog_density=f(0.012),
        sky_zenith=jnp.asarray([0.20, 0.38, 0.72], jnp.float32),
        sky_horizon=jnp.asarray([0.72, 0.80, 0.92], jnp.float32),
    )
    return Scene(noise=noise, camera=camera, materials=materials)

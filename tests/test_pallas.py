"""Pallas kernel (Triton route) vs pure-JAX reference, in interpreter mode
on CPU (SURVEY.md §5 kernel level; the compiled kernel's parity on the GPU
is a phase of chip_smoke.py — same code path minus ``interpret``)."""

import dataclasses

import jax
import numpy as np
import pytest

from gpgpuraytrace.kernels.trace import _render_pallas_raw, render_pallas
from gpgpuraytrace.models.scene import RenderConfig, default_scene
from gpgpuraytrace.ops.render import render_jax

# Block-aligned small size (8x16 blocks).
CFG = RenderConfig(
    height=64,
    width=128,
    max_steps=64,
    num_octaves=3,
    use_pallas=True,
    interpret=True,
)


@pytest.fixture(scope="module")
def scene():
    return default_scene(num_octaves=3)


@pytest.fixture(scope="module")
def pallas_out(scene):
    return _render_pallas_raw(scene, CFG)


def assert_mostly_close(a, b, atol, frac=0.999, msg=""):
    """Robust image comparison: at least ``frac`` of elements within atol.

    Grazing/silhouette rays are chaotic — a 1-ulp reorder can make a ray
    catch or skim a ridge, shifting its hit distance arbitrarily. Exact
    allclose is the wrong contract between two correct marchers; agreement
    everywhere except a vanishing fraction of contour pixels is the right one.
    """
    a, b = np.asarray(a), np.asarray(b)
    close = np.abs(a - b) <= atol
    got = close.mean()
    assert got >= frac, f"{msg}: only {100 * got:.3f}% within {atol} (need {100 * frac}%)"


def test_pallas_matches_pure_jax_image(scene, pallas_out):
    color, _, _ = pallas_out
    ref = render_jax(scene, dataclasses.replace(CFG, use_pallas=False))
    assert_mostly_close(color, ref, atol=2e-3, frac=0.999, msg="image")
    # And the bulk of the image is essentially exact.
    assert_mostly_close(color, ref, atol=1e-5, frac=0.99, msg="image-exact")


def test_pallas_checkpoint_t_hit_match(scene, pallas_out):
    from gpgpuraytrace.ops.camera import generate_rays
    from gpgpuraytrace.ops.march import march_primed
    from gpgpuraytrace.ops.render import prime_map_jax

    _, t_pal, hit_pal = pallas_out
    o, d = generate_rays(scene.camera, CFG.height, CFG.width)
    # CFG primes by default (round 5); the reference march must prime too.
    t0p = prime_map_jax(scene, CFG)
    t_ref, hit_ref = march_primed(CFG, o, d, scene.noise, t0p)
    agree = np.asarray(hit_pal) == np.asarray(hit_ref)
    assert agree.mean() > 0.995, f"hit masks differ on {100 * (1 - agree.mean()):.2f}% px"
    both_hit = np.asarray(hit_pal) & np.asarray(hit_ref)
    assert_mostly_close(
        np.asarray(t_pal)[both_hit],
        np.asarray(t_ref)[both_hit],
        atol=5e-2,
        frac=0.999,
        msg="hit t",
    )


def test_pallas_row_offset_band(scene):
    """A row band rendered with row0 != 0 equals that slice of the full frame
    (the tile-sharding contract used by parallel/sharded.py)."""
    color_full, _, _ = _render_pallas_raw(scene, CFG)
    band, _, _ = _render_pallas_raw(scene, CFG, row0=32.0, local_height=32)
    np.testing.assert_allclose(
        np.asarray(band), np.asarray(color_full)[32:64], rtol=1e-4, atol=1e-5
    )


def test_pallas_grad_matches_pure_jax(scene):
    """The custom-VJP backward (checkpointed path) must produce the same
    amplitude gradients as autodiff through the pure-JAX renderer."""
    import jax.numpy as jnp

    def loss_pallas(amps):
        s = dataclasses.replace(
            scene, noise=dataclasses.replace(scene.noise, amplitudes=amps)
        )
        img = render_pallas(s, CFG)
        return jnp.mean(img * img)

    def loss_jax(amps):
        s = dataclasses.replace(
            scene, noise=dataclasses.replace(scene.noise, amplitudes=amps)
        )
        img = render_jax(s, dataclasses.replace(CFG, use_pallas=False))
        return jnp.mean(img * img)

    amps = scene.noise.amplitudes
    g_pal = jax.grad(loss_pallas)(amps)
    g_ref = jax.grad(loss_jax)(amps)
    np.testing.assert_allclose(
        np.asarray(g_pal), np.asarray(g_ref), rtol=5e-3, atol=1e-5
    )


def test_pallas_bwd_kernel_full_scene_grads(scene):
    """The fused Pallas backward kernel must reproduce the XLA checkpoint
    backward on EVERY differentiable scene leaf (noise + camera + materials —
    the full chain through pack_scene, raygen, shade, and the implicit march
    channel)."""
    import jax.numpy as jnp

    from gpgpuraytrace.ops.fit import partition_scene

    leaves, merge = partition_scene(scene, trainable=lambda name: True)

    def make_loss(cfg):
        def loss(leaves):
            img = render_pallas(merge(leaves), cfg)
            return jnp.mean(img * jnp.cos(img))  # non-symmetric cotangent

        return loss

    g_kernel = jax.grad(make_loss(CFG))(leaves)
    g_xla = jax.grad(make_loss(dataclasses.replace(CFG, pallas_bwd=False)))(leaves)
    for gk, gx in zip(g_kernel, g_xla):
        # atol covers f32 op-order roundoff between the two implementations
        # on ill-conditioned (grazing, denominator-clamped) pixels.
        np.testing.assert_allclose(
            np.asarray(gk), np.asarray(gx), rtol=2e-4, atol=1e-6
        )


@pytest.mark.parametrize(
    "kw",
    [
        {"march_eps_scale": 4.0},
        {"step_floor_t": 0.0},
        {"step_relax": 0.7, "newton_iters": 4},  # the round-3 march regime
    ],
    ids=["loose_eps", "classic_no_floor", "relax07"],
)
def test_march_variants_match_baseline(scene, pallas_out, kw):
    """March variants (the loosened-eps preview knob; the classic crawl
    without a step floor; the conservative relax) must agree with the
    default except on a small silhouette-adjacent pixel fraction —
    different sample trajectories legitimately bracket grazing hits
    differently (see assert_mostly_close)."""
    base, _, _ = pallas_out
    var = _render_pallas_raw(scene, dataclasses.replace(CFG, **kw))[0]
    assert_mostly_close(base, var, atol=5e-2, frac=0.97, msg=f"variant {kw}")
    # Bulk of the image identical to strict tolerance.
    assert_mostly_close(base, var, atol=1e-3, frac=0.95, msg=f"variant-bulk {kw}")


def test_march_chunk_must_divide_max_steps():
    # A chunk that does not divide max_steps would silently march past
    # max_steps; RenderConfig rejects it at construction for the kernel.
    with pytest.raises(ValueError, match="march_chunk"):
        RenderConfig(max_steps=128, march_chunk=7, use_pallas=True)
    # march_chunk=0 means the default chunk (4); the effective chunk is
    # validated too, so 0 is not a back door around the check.
    with pytest.raises(ValueError, match="effective"):
        RenderConfig(max_steps=102, march_chunk=0, use_pallas=True)
    with pytest.raises(ValueError, match="march_chunk"):
        RenderConfig(march_chunk=-1)
    # Configs that never run the chunked kernel march are not subject to
    # the divisibility constraint — a pure-XLA render with --max-steps 100
    # is valid, as is a fixed-mode kernel march.
    RenderConfig(max_steps=100, use_pallas=False)
    RenderConfig(max_steps=100, march_mode="fixed", use_pallas=True)


def test_debug_steps_counter(scene, pallas_out):
    """In-kernel executed-step counter, one element per block: it must
    (a) not change the rendered outputs, (b) bound every lane's useful steps
    from above within one chunk, and (c) read exactly max_steps in fixed
    mode. This is the divergence-tax counter bench.py reports."""
    from gpgpuraytrace.kernels.trace import pallas_prime_map
    from gpgpuraytrace.ops.camera import generate_rays
    from gpgpuraytrace.ops.march import march_with_stats

    color_ref, t_ref2, hit_ref2 = pallas_out
    color, t, hit, steps = _render_pallas_raw(scene, CFG, debug_steps=True)
    np.testing.assert_array_equal(np.asarray(color), np.asarray(color_ref))
    np.testing.assert_array_equal(np.asarray(t), np.asarray(t_ref2))
    steps = np.asarray(steps)
    bh, bw = CFG.block_h, CFG.block_w
    grid_h, grid_w = CFG.height // bh, CFG.width // bw
    assert steps.shape == (grid_h, grid_w)
    chunk = CFG.march_chunk or 8
    assert (steps % chunk == 0).all() and (steps <= CFG.max_steps).all()

    # Lane-level cross-check: each block executed at least its own lanes'
    # max useful count (block-wide early exit can only overshoot by < 1
    # chunk, plus 1 step for the final hit-detection pass). The lane stats
    # march from the SAME prime map the kernel used (the kernel coarse
    # pass), or a coarse-pixel difference between implementations could
    # break the bound.
    t0p = pallas_prime_map(scene, CFG)
    o, d = generate_rays(scene.camera, CFG.height, CFG.width)
    _, _, lane = jax.jit(march_with_stats, static_argnums=0)(
        dataclasses.replace(CFG, use_pallas=False, interpret=False),
        o, d, scene.noise, t0p,
    )
    block_max = np.asarray(lane).reshape(grid_h, bh, grid_w, bw).max(axis=(1, 3))
    assert (steps >= block_max).all()
    assert (steps <= block_max + 2 * chunk).all()

    cfg_fixed = dataclasses.replace(CFG, march_mode="fixed")
    *_, sf = _render_pallas_raw(scene, cfg_fixed, debug_steps=True)
    assert (np.asarray(sf) == CFG.max_steps).all()

"""March unit tests against analytic fields (flat terrain = plane) with
closed-form hit distances (SURVEY.md §5), plus implicit-VJP correctness."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from gpgpuraytrace.models.scene import NoiseParams, RenderConfig
from gpgpuraytrace.ops.march import march, march_from_saved, march_with_stats


def _flat_noise(height=0.0):
    """Zero-amplitude noise → terrain is the plane y = height_offset."""
    return NoiseParams(
        amplitudes=jnp.zeros(1, jnp.float32),
        lacunarity=jnp.float32(2.0),
        height_scale=jnp.float32(1.0),
        height_offset=jnp.float32(height),
        horizontal_scale=jnp.float32(0.1),
    )


CFG = RenderConfig(height=8, width=8, max_steps=96, t_max=100.0, use_pallas=False)


def test_plane_hit_distance_exact():
    # Ray from (0, 5, 0) pointing down at 45°: plane y=0 hit at t = 5*sqrt(2).
    d = jnp.asarray([[0.0, -1.0, 1.0]]) / np.sqrt(2.0)
    o = jnp.asarray([[0.0, 5.0, 0.0]])
    t, hit = march(CFG, o, d, _flat_noise())
    assert bool(hit[0])
    np.testing.assert_allclose(float(t[0]), 5.0 * np.sqrt(2.0), rtol=1e-3)


def test_miss_upward_ray():
    d = jnp.asarray([[0.0, 1.0, 0.1]])
    d = d / jnp.linalg.norm(d)
    o = jnp.asarray([[0.0, 5.0, 0.0]])
    t, hit = march(CFG, o, d, _flat_noise())
    assert not bool(hit[0])
    np.testing.assert_allclose(float(t[0]), CFG.t_max, rtol=1e-5)


def test_march_batched_shapes():
    o = jnp.broadcast_to(jnp.asarray([0.0, 5.0, 0.0]), (4, 6, 3))
    dirs = jnp.broadcast_to(
        jnp.asarray([0.0, -1.0, 0.3]) / np.linalg.norm([0.0, -1.0, 0.3]), (4, 6, 3)
    )
    t, hit = march(CFG, o, dirs, _flat_noise())
    assert t.shape == (4, 6) and hit.shape == (4, 6)
    assert np.asarray(hit).all()


def test_march_with_stats_step_counts():
    o = jnp.asarray([[0.0, 5.0, 0.0]])
    d = jnp.asarray([[0.0, -1.0, 0.0]])
    t, hit, steps = march_with_stats(CFG, o, d, _flat_noise())
    assert bool(hit[0])
    # 0 steps is legitimate: the sky-envelope skip fast-forwards this ray
    # analytically to the envelope plane, which for a flat field IS the
    # surface — the first field evaluation already registers the hit.
    assert 0 <= int(steps[0]) <= CFG.max_steps

    # A ray entering below the envelope must still march normally.
    t2, hit2, steps2 = march_with_stats(CFG, o, d, _bumpy_noise(num_octaves=3))
    assert bool(hit2[0])
    assert 0 < int(steps2[0]) <= CFG.max_steps


def test_implicit_grad_plane_height_offset():
    """Plane at y = h0: t(h0) = sqrt(2)·(o_y - h0) ⇒ dt/dh0 = -sqrt(2)
    (raising the terrain brings the hit closer)."""
    o = jnp.asarray([[0.0, 5.0, 0.0]])
    d = jnp.asarray([[0.0, -1.0, 1.0]]) / np.sqrt(2.0)

    def t_of_h(h0):
        noise = _flat_noise(h0)
        t, _ = march(CFG, o, d, noise)
        return t[0]

    g = jax.grad(t_of_h)(jnp.float32(0.0))
    np.testing.assert_allclose(float(g), -np.sqrt(2.0), rtol=1e-3)


def test_implicit_grad_origin_height():
    """dt/do_y = -1/d_y = sqrt(2) for the 45° down ray on plane y=0."""
    d = jnp.asarray([[0.0, -1.0, 1.0]]) / np.sqrt(2.0)

    def t_of_oy(oy):
        o = jnp.stack([jnp.zeros(()), oy, jnp.zeros(())])[None]
        t, _ = march(CFG, o, d, _flat_noise())
        return t[0]

    g = jax.grad(t_of_oy)(jnp.float32(5.0))
    np.testing.assert_allclose(float(g), np.sqrt(2.0), rtol=1e-3)


def test_miss_pixels_have_zero_grad():
    d = jnp.asarray([[0.0, 1.0, 0.0]])  # straight up, never hits
    o = jnp.asarray([[0.0, 5.0, 0.0]])

    def t_of_h(h0):
        t, _ = march(CFG, o, d, _flat_noise(h0))
        return t[0]

    g = jax.grad(t_of_h)(jnp.float32(0.0))
    assert float(g) == 0.0


def _bumpy_noise(num_octaves=1, warp=0.0):
    """Nonzero-amplitude terrain (single-octave Perlin bumps), optional 3D
    warp — the 'analytic warped-bump' cases of SURVEY.md §5 (the sphere named
    there is inexpressible in a heightfield+warp field model; these replace
    it as the analytic/certified march references)."""
    return NoiseParams(
        amplitudes=jnp.asarray([0.8 / 2**i for i in range(num_octaves)], jnp.float32),
        lacunarity=jnp.float32(2.0),
        height_scale=jnp.float32(2.0),
        height_offset=jnp.float32(0.5),
        horizontal_scale=jnp.float32(0.25),
        warp_amplitude=jnp.float32(warp),
        warp_frequency=jnp.float32(0.25),
    )


def test_bumpy_lattice_column_hit_exact():
    """Closed form with a genuinely bumpy terrain: Perlin noise is exactly 0
    on its integer lattice, so along the vertical column x = z = 0 (lattice
    coordinates for horizontal_scale=0.25: 0 is an integer) every octave
    vanishes and the surface height is exactly height_offset. A straight-down
    ray from (0, 5, 0) must hit at t = 5 - height_offset = 4.5 even though
    the neighbouring terrain is full-amplitude bumps."""
    o = jnp.asarray([[0.0, 5.0, 0.0]])
    d = jnp.asarray([[0.0, -1.0, 0.0]])
    t, hit = march(CFG, o, d, _bumpy_noise(num_octaves=3))
    assert bool(hit[0])
    np.testing.assert_allclose(float(t[0]), 4.5, rtol=1e-3)


def _first_root_dense(f_of_t, t_min, t_max, n=20000, iters=60):
    """Certified ground-truth first crossing: dense scan for the first sign
    change, then bisection to ~1e-8. Returns (t_root, found)."""
    ts = np.linspace(t_min, t_max, n, dtype=np.float64)
    fs = np.asarray(jax.vmap(f_of_t)(jnp.asarray(ts, jnp.float32)), np.float64)
    sign = fs <= 0.0
    idx = np.argmax(sign)
    if not sign.any() or idx == 0:
        return None, False
    lo, hi = ts[idx - 1], ts[idx]
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        if float(f_of_t(jnp.float32(mid))) <= 0.0:
            hi = mid
        else:
            lo = mid
    return 0.5 * (lo + hi), True


def test_volumetric_warped_bump_march_vs_dense_ground_truth():
    """Warped-bump march correctness without a closed form: for a fan of rays
    through the full 3D-warped volumetric field, the march + Newton polish
    must land on the SAME first root that a 20k-sample dense scan + bisection
    certifies (and agree on hit/miss)."""
    from gpgpuraytrace.ops.field import field

    noise = _bumpy_noise(num_octaves=2, warp=0.6)
    cfg = dataclasses.replace(
        CFG, volumetric=True, step_relax=0.35, max_steps=256, t_max=60.0
    )
    o_np = np.asarray([0.0, 6.0, -8.0], np.float32)
    dirs = []
    for yaw in (-0.3, 0.0, 0.25):
        for pitch in (-0.5, -0.25):
            d = np.asarray(
                [np.sin(yaw), np.sin(pitch), np.cos(yaw) * np.cos(pitch)],
                np.float32,
            )
            dirs.append(d / np.linalg.norm(d))
    dirs = np.stack(dirs)
    o = jnp.broadcast_to(jnp.asarray(o_np), dirs.shape)
    t_m, hit_m = march(cfg, o, jnp.asarray(dirs), noise)

    for k in range(dirs.shape[0]):
        def f_of_t(t, d=jnp.asarray(dirs[k])):
            p = (jnp.asarray(o_np) + t * d)[None]
            return field(p, noise, True, cfg.warp_octaves)[0]

        t_ref, found = _first_root_dense(f_of_t, cfg.t_min, cfg.t_max)
        assert found == bool(hit_m[k]), f"ray {k}: hit/miss disagrees"
        if found:
            tk = float(t_m[k])
            tol = 4e-3 * t_ref + 1e-3
            if abs(tk - t_ref) <= tol:
                continue  # polished onto the certified first crossing
            # The march's hit semantic is SCREEN-SPACE: it flags f < eps·t
            # ("within ~a pixel footprint of the surface"), which a
            # sign-change oracle cannot see when the field grazes the ray
            # without crossing zero. Accept a flagged hit that stopped
            # BEFORE the certified root iff the field value there sits
            # inside the march's own hit band (a certified near-graze —
            # first observed on the round-5 terrain: f = 0.0042 at t = 21
            # vs band 0.021, true crossing at 25.06). Stopping AFTER t_ref
            # would mean the march skipped the real surface and stays a
            # failure.
            f_here = float(f_of_t(jnp.float32(tk)))
            from gpgpuraytrace.ops.march import _RESIDUAL_SLACK
            band = _RESIDUAL_SLACK * cfg.hit_eps * tk
            assert tk < t_ref and abs(f_here) <= band, (
                f"ray {k}: march t {tk:.4f} vs certified root {t_ref:.4f}, "
                f"f(t_march) = {f_here:.5f} vs graze band {band:.5f}"
            )


def test_march_from_saved_matches_march_grads():
    o = jnp.asarray([[0.0, 5.0, 0.0]])
    d = jnp.asarray([[0.0, -1.0, 1.0]]) / np.sqrt(2.0)
    noise = _flat_noise()
    t_saved, hit_saved = march(CFG, o, d, noise)

    def via_march(h0):
        t, _ = march(CFG, o, d, dataclasses.replace(noise, height_offset=h0))
        return t[0]

    def via_saved(h0):
        t, _ = march_from_saved(
            CFG, o, d, dataclasses.replace(noise, height_offset=h0), t_saved, hit_saved
        )
        return t[0]

    g1 = jax.grad(via_march)(jnp.float32(0.0))
    g2 = jax.grad(via_saved)(jnp.float32(0.0))
    np.testing.assert_allclose(float(g1), float(g2), rtol=1e-4)

"""3D noise and volumetric terrain tests: analytic noise3 derivatives vs
finite differences, volumetric render sanity, warp-amplitude gradients, and
Pallas parity of the volumetric kernel path."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from gpgpuraytrace.models.scene import RenderConfig, default_scene
from gpgpuraytrace.ops.noise import fbm3, noise3
from gpgpuraytrace.ops.render import render_jax

CFG = RenderConfig(
    height=32,
    width=64,
    max_steps=64,
    num_octaves=2,
    use_pallas=False,
    volumetric=True,
    step_relax=0.4,
)


def test_noise3_derivatives_match_fd():
    key = jax.random.PRNGKey(0)
    p = jax.random.uniform(key, (3, 256), minval=-6.0, maxval=6.0)
    x, y, z = p
    v, dx, dy, dz = noise3(x, y, z, 7)
    assert np.all(np.abs(np.asarray(v)) <= 1.0 + 1e-5)
    eps = 1e-3
    for axis, d_analytic in ((0, dx), (1, dy), (2, dz)):
        dp = jnp.zeros((3, 1)).at[axis].set(eps)
        vp = noise3(x + dp[0], y + dp[1], z + dp[2], 7)[0]
        vm = noise3(x - dp[0], y - dp[1], z - dp[2], 7)[0]
        np.testing.assert_allclose(
            np.asarray(d_analytic), np.asarray((vp - vm) / (2 * eps)), atol=3e-3
        )


def test_noise3_zero_at_lattice():
    ij = jnp.arange(-3, 4, dtype=jnp.float32)
    x, y, z = jnp.meshgrid(ij, ij, ij, indexing="ij")
    v, _, _, _ = noise3(x, y, z, 3)
    np.testing.assert_allclose(np.asarray(v), 0.0, atol=1e-6)


def test_fbm3_derivative_and_decay():
    x = jnp.linspace(-3, 3, 64)
    y = x + 0.5
    z = x - 0.3
    v1, d1x, _, _ = fbm3(x, y, z, 1, 2.0, 0.5, 7)
    v3, d3x, _, _ = fbm3(x, y, z, 3, 2.0, 0.5, 7)
    assert not np.allclose(np.asarray(v1), np.asarray(v3))
    eps = 1e-3
    vp = fbm3(x + eps, y, z, 3, 2.0, 0.5, 7)[0]
    vm = fbm3(x - eps, y, z, 3, 2.0, 0.5, 7)[0]
    np.testing.assert_allclose(
        np.asarray(d3x), np.asarray((vp - vm) / (2 * eps)), atol=1e-2
    )


def test_volumetric_render_differs_and_finite():
    scene_v = default_scene(2, volumetric=True)
    img_v = np.asarray(render_jax(scene_v, CFG))
    assert np.isfinite(img_v).all()
    img_h = np.asarray(
        render_jax(default_scene(2), dataclasses.replace(CFG, volumetric=False))
    )
    assert not np.allclose(img_v, img_h, atol=0.02)


def test_zero_warp_matches_heightfield():
    """warp_amplitude == 0 must reproduce the heightfield image exactly
    (modulo march-mode float noise)."""
    scene = default_scene(2, volumetric=False)  # warp_amplitude = 0
    img_v = np.asarray(render_jax(scene, CFG))
    img_h = np.asarray(
        render_jax(scene, dataclasses.replace(CFG, volumetric=False))
    )
    close = np.abs(img_v - img_h) < 1e-4
    assert close.mean() > 0.999


def test_warp_amplitude_gradient():
    """Per-pixel dt/d(warp_amplitude): implicit VJP vs finite differences on
    hit-stable pixels. (A whole-image loss gradient is FD-noise-dominated
    here — the warp's net pixel-loss gradient is ~1e-5 — so the honest check
    is at the hit-distance level, where the march VJP actually acts.)"""
    from gpgpuraytrace.ops.camera import generate_rays
    from gpgpuraytrace.ops.march import march

    scene = default_scene(2, volumetric=True)
    o, d = generate_rays(scene.camera, CFG.height, CFG.width)

    def t_of(theta):
        noise = dataclasses.replace(scene.noise, warp_amplitude=theta)
        return march(CFG, o, d, noise)

    from gpgpuraytrace.ops.field import field

    def residual(theta, t):
        noise = dataclasses.replace(scene.noise, warp_amplitude=theta)
        p = o + jnp.asarray(t)[..., None] * d
        return np.abs(np.asarray(field(p, noise, True, CFG.warp_octaves)))

    th0 = scene.noise.warp_amplitude
    eps = 2e-3
    tp, hp = t_of(th0 + eps)
    tm, hm = t_of(th0 - eps)
    t0, h0 = t_of(th0)
    # Restrict to converged transversal crossings (residual ≈ 0): that is the
    # set where the implicit function theorem applies; skim/proximity hits
    # (march stopped by the f < ε·t threshold without a true zero crossing)
    # genuinely have no IFT derivative and are excluded — they are ~1% of
    # hits here.
    converged = (
        (residual(th0 + eps, tp) < 1e-4)
        & (residual(th0 - eps, tm) < 1e-4)
        & (residual(th0, t0) < 1e-4)
    )
    stable = (
        np.asarray(hp)
        & np.asarray(hm)
        & np.asarray(h0)
        & (np.abs(np.asarray(tp) - np.asarray(tm)) < 0.05)
        & converged
    )
    assert stable.sum() > 100
    fd = (np.asarray(tp) - np.asarray(tm)) / (2 * eps)

    w = jnp.asarray(stable, jnp.float32)
    ad_sum = jax.grad(lambda th: jnp.sum(w * t_of(th)[0]))(th0)
    fd_sum = float(fd[stable].sum())
    assert np.isfinite(float(ad_sum)) and fd_sum != 0.0
    np.testing.assert_allclose(float(ad_sum), fd_sum, rtol=0.01)


def test_volumetric_pallas_matches_pure_jax():
    from gpgpuraytrace.kernels.trace import _render_pallas_raw
    from tests.test_pallas import assert_mostly_close

    cfg = dataclasses.replace(CFG, use_pallas=True, interpret=True)
    scene = default_scene(2, volumetric=True)
    color, _, _ = _render_pallas_raw(scene, cfg)
    ref = render_jax(scene, dataclasses.replace(cfg, use_pallas=False))
    assert_mostly_close(color, ref, atol=2e-3, frac=0.995, msg="volumetric image")


def test_volumetric_pallas_bwd_kernel_full_scene_grads():
    """Volumetric mode: the fused Pallas BACKWARD kernel must reproduce the
    XLA checkpoint backward on every differentiable leaf — in particular the
    WARP_AMP / WARP_FREQ packed channel (kernels/trace.py warp terms), which
    only exists under cfg.volumetric and is untested by the heightfield
    parity test in tests/test_pallas.py."""
    from gpgpuraytrace.kernels.trace import render_pallas
    from gpgpuraytrace.ops.fit import partition_scene

    cfg = dataclasses.replace(CFG, use_pallas=True, interpret=True)
    scene = default_scene(2, volumetric=True)
    leaves, merge = partition_scene(scene, trainable=lambda name: True)
    names = [
        p for p, _ in jax.tree_util.tree_flatten_with_path(scene)[0]
    ]  # sanity: warp leaves are in the trainable set
    assert any("warp_amplitude" in str(n) for n in names)

    def make_loss(c):
        def loss(leaves):
            img = render_pallas(merge(leaves), c)
            return jnp.mean(img * jnp.cos(img))

        return loss

    g_kernel = jax.grad(make_loss(cfg))(leaves)
    g_xla = jax.grad(make_loss(dataclasses.replace(cfg, pallas_bwd=False)))(leaves)
    for gk, gx in zip(g_kernel, g_xla):
        np.testing.assert_allclose(
            np.asarray(gk), np.asarray(gx), rtol=2e-4, atol=1e-6
        )

"""End-to-end render tests: config-1 (256², 1-octave, Lambert — driver
config BASELINE.json:7) sanity + frozen golden image (SURVEY.md §5)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from gpgpuraytrace.models.scene import RenderConfig, default_scene
from gpgpuraytrace.ops.render import render_jax, render_jit
from gpgpuraytrace.ops.shade import tonemap

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "config1_128.npy")

# The golden anchor pins the classic strict march (step_floor_t=0,
# step_relax=0.7, prime_ds=0 — the values the frozen image was rendered
# with) so the image stays stable across march-acceleration tuning; the
# production defaults are covered by the variant tests in test_pallas.py.
CFG1 = RenderConfig(
    height=128, width=128, max_steps=96, num_octaves=1, use_pallas=False,
    step_floor_t=0.0, step_relax=0.7, newton_iters=4, prime_ds=0,
)


@pytest.fixture(scope="module")
def config1_image():
    scene = default_scene(num_octaves=1)
    return np.asarray(render_jax(scene, CFG1))


def test_render_shape_and_finite(config1_image):
    assert config1_image.shape == (128, 128, 3)
    assert np.isfinite(config1_image).all()
    assert config1_image.min() >= 0.0


def test_render_has_sky_and_terrain(config1_image):
    # Top rows look up → sky (blue dominant); bottom rows hit terrain.
    top = config1_image[:8].mean(axis=(0, 1))
    assert top[2] > top[0], "sky should be blue-dominant"
    bottom = config1_image[-8:].mean(axis=(0, 1))
    assert not np.allclose(top, bottom, atol=0.05), "terrain differs from sky"


def test_render_deterministic(config1_image):
    again = np.asarray(render_jax(default_scene(num_octaves=1), CFG1))
    np.testing.assert_array_equal(config1_image, again)


def test_render_jit_matches_eager(config1_image):
    jitted = np.asarray(render_jit(default_scene(num_octaves=1), CFG1))
    # jit fusion reorders float ops; tiny per-pixel drift is expected.
    np.testing.assert_allclose(jitted, config1_image, rtol=1e-3, atol=5e-4)


def test_golden_image(config1_image):
    """Frozen stage-1 golden (the image-match anchor until the reference
    source materializes). Regenerate with scripts/make_golden.py."""
    if not os.path.exists(GOLDEN):
        pytest.skip("golden not generated yet")
    golden = np.load(GOLDEN)
    np.testing.assert_allclose(config1_image, golden, rtol=1e-3, atol=2e-3)


def test_tonemap_range(config1_image):
    out = np.asarray(tonemap(jnp.asarray(config1_image)))
    assert out.min() >= 0.0 and out.max() <= 1.0


def test_config2_fbm_render():
    """Config 2 (BASELINE.json:8): 6-octave fBm + fog/sky, small size."""
    cfg = RenderConfig(height=64, width=64, max_steps=128, num_octaves=6, use_pallas=False)
    img = np.asarray(render_jax(default_scene(num_octaves=6), cfg))
    assert img.shape == (64, 64, 3)
    assert np.isfinite(img).all()
    # 6-octave terrain must differ from 1-octave terrain.
    cfg1 = RenderConfig(height=64, width=64, max_steps=128, num_octaves=1, use_pallas=False)
    img1 = np.asarray(render_jax(default_scene(num_octaves=1), cfg1))
    assert not np.allclose(img, img1, atol=0.02)


def test_supersample_render():
    """SSAA: k× render + box downsample, differentiable and shape-correct."""
    import dataclasses

    cfg = RenderConfig(height=32, width=32, max_steps=48, num_octaves=1, use_pallas=False)
    cfg_ss = dataclasses.replace(cfg, supersample=2)
    from gpgpuraytrace.ops.render import render

    scene = default_scene(num_octaves=1)
    img = np.asarray(render(scene, cfg))
    img_ss = np.asarray(render(scene, cfg_ss))
    assert img_ss.shape == img.shape
    assert np.isfinite(img_ss).all()
    # SSAA output is close to the base render but not identical (edges).
    assert np.abs(img_ss - img).mean() < 0.05
    assert not np.array_equal(img_ss, img)

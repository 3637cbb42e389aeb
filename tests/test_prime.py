"""Depth-priming unit tests: the prime-map function's contract, the primed
march's agreement with the unprimed one, the primed path's gradients, and
the row-band rules (whole coarse rows) both prime paths enforce. The
quality claims live in scripts/prime_trial.py; these tests pin the
SEMANTICS on CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpgpuraytrace.models.scene import RenderConfig, default_scene
from gpgpuraytrace.ops.march import prime_from_coarse
from gpgpuraytrace.ops.render import prime_map_jax, render_jax

CFG = RenderConfig(
    height=64, width=128, max_steps=64, num_octaves=3, use_pallas=False,
    prime_ds=4, prime_margin=0.9,
)


def test_prime_from_coarse_contract():
    """Window-min, margin, all-miss→t_max, and upsample-by-repeat — checked
    against a hand-built coarse image (with the 1-row halo the callers
    render)."""
    cfg = CFG
    hc, wc = cfg.height // 4, cfg.width // 4
    t_c = np.full((hc + 2, wc), cfg.t_max, np.float32)  # +2 = halo rows
    t_c[5, 7] = 10.0   # one hit among misses (interior row 4 of the band)
    tp = np.asarray(prime_from_coarse(jnp.asarray(t_c), cfg))
    assert tp.shape == (cfg.height, cfg.width)
    # Fine pixels whose 3×3 coarse window contains the hit start at
    # margin × 10; rows 4±1 of the band → fine rows 12..24.
    assert np.isclose(tp[16, 28], 9.0)   # coarse (4,7) → fine block
    assert np.isclose(tp[12, 24], 9.0)   # window corner (3,6)
    # Outside the window: all nine neighbors missed → primed to t_max.
    assert tp[16, 60] == cfg.t_max
    assert tp[40, 28] == cfg.t_max
    # Upsample is integer repeat: the 4×4 fine block is constant.
    block = tp[16:20, 28:32]
    assert (block == block[0, 0]).all()


def test_primed_march_agrees_with_unprimed():
    """Priming is a march-start accelerator: hit verdicts and hit
    distances must agree with the unprimed march except on a small
    silhouette-adjacent fraction (the same contract as the march-variant
    parity tests)."""
    scene = default_scene(num_octaves=3)
    img_p = np.asarray(render_jax(scene, CFG))
    img_0 = np.asarray(render_jax(scene, dataclasses.replace(CFG, prime_ds=0)))
    close = np.abs(img_p - img_0) <= 2e-3
    assert close.mean() >= 0.995, f"primed vs unprimed: {close.mean():.4f}"


def test_primed_band_equals_full_frame():
    """The coarse halo row makes band-sharded priming bit-identical to
    full-frame (the sharded == unsharded contract)."""
    scene = default_scene(num_octaves=3)
    full = np.asarray(render_jax(scene, CFG))
    band = np.asarray(render_jax(scene, CFG, row0=16.0, local_height=32))
    np.testing.assert_array_equal(band, full[16:48])


def test_primed_gradients_match_fd():
    """AD through the primed path vs central finite differences on
    hit-stable pixels — the judged gradient contract, on the primed
    render."""
    from gpgpuraytrace.ops.fd_check import fd_check_scalar

    cfg = dataclasses.replace(
        CFG, height=48, width=64, max_steps=96, num_octaves=2, prime_ds=4
    )
    scene = default_scene(num_octaves=2)
    target = render_jax(
        dataclasses.replace(
            scene,
            noise=dataclasses.replace(
                scene.noise, amplitudes=scene.noise.amplitudes * 1.1
            ),
        ),
        cfg,
    )

    def get_scene(theta):
        amps = scene.noise.amplitudes.at[0].set(theta)
        return dataclasses.replace(
            scene, noise=dataclasses.replace(scene.noise, amplitudes=amps)
        )

    ad, fd = fd_check_scalar(
        get_scene, scene.noise.amplitudes[0], cfg, target, eps=3e-3,
        t_cap=0.03,
    )
    assert np.isfinite(ad) and np.isfinite(fd)
    assert abs(ad - fd) <= 5e-2 * max(abs(fd), 1e-5), f"ad={ad} fd={fd}"


def test_march_with_stats_requires_prime_map_when_primed():
    """A primed config must not silently march unprimed in the stats path
    (the measurement-confounding hazard code review caught when priming
    became the default)."""
    from gpgpuraytrace.ops.camera import generate_rays
    from gpgpuraytrace.ops.march import march_with_stats

    scene = default_scene(num_octaves=2)
    cfg = dataclasses.replace(CFG, use_pallas=False)
    o, d = generate_rays(scene.camera, cfg.height, cfg.width)
    with pytest.raises(ValueError, match="prime"):
        march_with_stats(cfg, o, d, scene.noise)


def test_primed_volumetric_agrees_with_unprimed():
    """Volumetric priming (3D-warped field, overhangs): same contract as
    the heightfield variant test — the suite's other volumetric configs
    are too small to auto-prime, so this is the only in-suite coverage of
    the primed volumetric march."""
    cfg = dataclasses.replace(CFG, volumetric=True, step_relax=None)
    scene = default_scene(num_octaves=3, volumetric=True)
    img_p = np.asarray(render_jax(scene, cfg))
    img_0 = np.asarray(render_jax(scene, dataclasses.replace(cfg, prime_ds=0)))
    d = np.abs(img_p - img_0)
    # The warped volumetric field flips more marginal pixels at this toy
    # scale (64×128, 64 steps, 16×32 coarse) than the heightfield — the
    # contract matches the cross-variant band of the march-variant tests;
    # shipping-scale quality is gated by the oracle harness + the
    # committed volumetric bounds in tests/test_quality.py.
    assert (d <= 2e-3).mean() >= 0.99, f"bulk: {(d <= 2e-3).mean():.4f}"
    assert (d <= 5e-2).mean() >= 0.995, f"tail: {(d <= 5e-2).mean():.4f}"


def test_primed_supersample_composes():
    """SSAA renders at k× inside render(); the carried prime_ds must stay
    valid at the scaled resolution and the downsample must see primed
    sub-pixels (smoke: shape + finiteness + sky/terrain structure)."""
    from gpgpuraytrace.ops.render import render

    cfg = dataclasses.replace(CFG, supersample=2)
    img = np.asarray(render(default_scene(num_octaves=3), cfg))
    assert img.shape == (CFG.height, CFG.width, 3)
    assert np.isfinite(img).all()
    top = img[:4].mean(axis=(0, 1))
    assert top[2] > top[0]  # sky stays blue-dominant


def _prime_paths():
    from gpgpuraytrace.kernels.trace import pallas_prime_map

    pcfg = dataclasses.replace(CFG, use_pallas=True, interpret=True)
    return {"xla": (prime_map_jax, CFG), "kernel": (pallas_prime_map, pcfg)}


@pytest.mark.parametrize("path", ["xla", "kernel"])
@pytest.mark.parametrize(
    "row0, local_height, match",
    [(0.0, 30, "local render height"), (2.0, 32, "first row")],
    ids=["band_height", "band_row0"],
)
def test_prime_band_must_be_whole_coarse_rows(path, row0, local_height, match):
    """Both prime paths reject a band whose height or first row is not a
    multiple of prime_ds (here 4) — the coarse grid would shift by a
    fraction of a coarse pixel and silently break band == full frame."""
    fn, cfg = _prime_paths()[path]
    with pytest.raises(ValueError, match=match):
        fn(default_scene(3), cfg, row0, local_height)


def test_band_prime_cfg_four_way_4k():
    """4K over four cards: 540-row bands, which the default prime_ds=8 does
    not divide — the band config primes at 4 (divides 540, 2160, 3840);
    bands that 8 divides keep 8; a band no factor divides turns priming
    off."""
    from gpgpuraytrace.ops.march import band_prime_cfg

    cfg = RenderConfig(height=2160, width=3840)
    assert cfg.prime_ds == 8
    band = band_prime_cfg(cfg, 2160 // 4)
    assert band.prime_ds == 4 and 540 % band.prime_ds == 0
    assert band_prime_cfg(cfg, 2160 // 2) is cfg  # 1080 % 8 == 0
    odd = RenderConfig(height=72 * 8, width=512)
    assert band_prime_cfg(odd, 9).prime_ds == 0

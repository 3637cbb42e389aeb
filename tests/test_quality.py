"""Shipping-default march-quality harness.

The march defaults (step_relax 1.0, newton_iters 3, step_floor_t 4e-3;
volumetric relax 0.9) were validated against dense oracles in sweeps
(scripts/relax_sweep.py) — but the frozen
goldens pin the *round-2* regime, so nothing in the suite previously failed
if a change degraded DEFAULT-path quality (Pallas-vs-XLA parity passes when
both are wrong together). These tests rebuild the oracle comparison
in-suite, at a CPU-feasible scale:

* a dense fixed-march ground truth (1024 steps, conservative relax, no step
  floor — the same oracle family as scripts/relax_sweep.py) is marched
  in-test with the SAME field, so the bounds survive intentional terrain
  changes (a new noise design re-anchors the oracle automatically);
* the DEFAULT config must stay inside hole-count and hit-distance-error
  bounds set at ~2× the round-5 measured values;
* a sensitivity companion (over-relaxed march) must VIOLATE the bound —
  proving the harness can actually fail (same pattern as
  test_rotation_guard_is_sensitive);
* a volumetric pair does the same at the 0.9 default.

Measured anchors (round 5, post hash-adoption terrain, this exact config):
heightfield 192²/4oct — default holes 4, t-off 352/36864; relax 1.6 →
1170, 2.0 → 7390 (on THIS terrain 1.4 only reads 397 — the thin-ridge
population at this toy scale shrank with the new hash, so the sensitivity
companion over-relaxes to 1.6 to keep a 3× margin over the bound).
Volumetric 128²/3oct — default holes 2, t-off 179/16384; relax 1.5 → 776;
the superseded 0.4 default reads 56 budget-exhaustion holes (bound 20 —
both failure directions stay guarded).
"""

import dataclasses

import jax
import numpy as np
import pytest

from gpgpuraytrace.models.scene import RenderConfig, default_scene
from gpgpuraytrace.ops.camera import generate_rays
from gpgpuraytrace.ops.march import march_with_stats

# Hit-distance error above this (world units) counts a pixel as "off".
T_ERR = 0.05

# Heightfield: default must stay under these; the sensitivity config must
# exceed T_OFF_MAX. Bounds ≈ 2× measured (holes get slack for seed drift).
HF = dict(size=192, octaves=4, holes_max=12, t_off_max=700)
VOL = dict(size=128, octaves=3, holes_max=20, t_off_max=400)


def _march(cfg, o, d, noise, scene=None):
    """March with the SHIPPING semantics: when cfg primes (the round-5
    default), build the prime map exactly as the render path does —
    otherwise the harness would silently gate the unprimed march while the
    product ships the primed one."""
    if cfg.prime_ds:
        from gpgpuraytrace.ops.render import prime_map_jax

        t0p = jax.jit(prime_map_jax, static_argnums=1)(scene, cfg)
        t, hit, _ = jax.jit(march_with_stats, static_argnums=0)(
            cfg, o, d, noise, t0p
        )
    else:
        t, hit, _ = jax.jit(march_with_stats, static_argnums=0)(
            cfg, o, d, noise
        )
    return np.asarray(t), np.asarray(hit)


def _quality(volumetric: bool, **overrides):
    """(holes, t_off): the variant config vs its own in-test dense oracle."""
    p = VOL if volumetric else HF
    n = p["size"]
    scene = default_scene(num_octaves=p["octaves"], volumetric=volumetric)
    o, d = generate_rays(scene.camera, n, n)
    base = dict(height=n, width=n, num_octaves=p["octaves"],
                use_pallas=False, volumetric=volumetric)
    gt_cfg = RenderConfig(
        **base,
        max_steps=512 if volumetric else 1024,
        step_relax=0.25 if volumetric else 0.35,
        step_floor_t=0.0,
        prime_ds=0,  # the oracle marches dense and unprimed, always
    )
    t_gt, hit_gt = _march(gt_cfg, o, d, scene.noise)
    cfg = RenderConfig(**base, max_steps=128, **overrides)
    t, hit = _march(cfg, o, d, scene.noise, scene=scene)
    holes = int((hit_gt & ~hit).sum())
    both = hit_gt & hit
    t_off = int((np.abs(t - t_gt)[both] > T_ERR).sum())
    return holes, t_off


@pytest.fixture(scope="module")
def hf_default():
    return _quality(volumetric=False)


@pytest.fixture(scope="module")
def vol_default():
    return _quality(volumetric=True)


def test_default_march_quality(hf_default):
    """The SHIPPING defaults (relax 1.0, newton 3, floor 4e-3 — resolved by
    RenderConfig itself) must track the dense oracle."""
    assert RenderConfig().step_relax == 1.0  # this test pins the defaults
    holes, t_off = hf_default
    assert holes <= HF["holes_max"], f"default config skips terrain: {holes}"
    assert t_off <= HF["t_off_max"], f"default hit distances drifted: {t_off}"


def test_quality_harness_is_sensitive(hf_default):
    """An over-relaxed march MUST violate the bound, or the harness guards
    nothing. relax 1.6 measured 3.3× the default's off-pixels (1170 vs
    352) on the round-5 terrain; 2.0 reads 21×."""
    _, t_off_bad = _quality(volumetric=False, step_relax=1.6)
    assert t_off_bad > HF["t_off_max"], (
        f"sensitivity check failed: relax 1.6 scored {t_off_bad} "
        f"<= bound {HF['t_off_max']} — the bound is too loose to detect "
        f"a real quality regression"
    )
    # And clearly worse than the default, at any bound.
    assert t_off_bad > 2 * hf_default[1] + 50


def test_volumetric_default_march_quality(vol_default):
    """Volumetric defaults (relax 0.9 via RenderConfig's per-mode
    resolution). Both failure directions are covered: over-relaxation blows
    t_off; the superseded too-small 0.4 blows HOLES (tiny steps exhaust the
    128-step budget on grazing rays — ~78 holes measured at 192²)."""
    assert RenderConfig(volumetric=True).step_relax == 0.9
    holes, t_off = vol_default
    assert holes <= VOL["holes_max"], f"volumetric budget exhaustion: {holes}"
    assert t_off <= VOL["t_off_max"], f"volumetric drift: {t_off}"


def test_volumetric_harness_is_sensitive(vol_default):
    """relax 1.5 reads 776 off-px vs the 179 default (4.3×); the opposite
    failure direction (0.4: tiny steps exhaust the budget, 56 holes vs
    bound 20) is covered by the holes bound in the default test."""
    _, t_off_bad = _quality(volumetric=True, step_relax=1.5)
    assert t_off_bad > VOL["t_off_max"], (
        f"volumetric sensitivity check failed: relax 1.5 scored {t_off_bad}"
    )
    assert t_off_bad > 3 * vol_default[1] + 50


def test_newton_default_quality(hf_default):
    """newton_iters=1 must measurably degrade hit-distance accuracy vs the
    shipping 3 (the knob's documented meaning), while 4 matches 3 — pinning
    'newton 3 is quality-identical to 4' from the round-4 sweep."""
    _, t_off_n1 = _quality(volumetric=False, newton_iters=1)
    _, t_off_n4 = _quality(volumetric=False, newton_iters=4)
    t_off_default = hf_default[1]
    assert t_off_n1 > 1.5 * t_off_default, (t_off_n1, t_off_default)
    assert abs(t_off_n4 - t_off_default) <= 0.25 * t_off_default + 20

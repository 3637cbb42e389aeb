"""RenderConfig validation and per-mode default resolution.

The measured-safe volumetric step_relax (0.9) must be the library default,
not a CLI special case — a directly-constructed RenderConfig(volumetric=True)
once inherited the heightfield 1.0, measured at 5.5× more off-pixels in
volumetric mode.
"""

import argparse

import pytest

from gpgpuraytrace.models.scene import RenderConfig


def test_step_relax_default_per_mode():
    assert RenderConfig().step_relax == 1.0
    assert RenderConfig(volumetric=True).step_relax == 0.9


def test_step_relax_explicit_override_preserved():
    assert RenderConfig(step_relax=0.7).step_relax == 0.7
    assert RenderConfig(volumetric=True, step_relax=0.5).step_relax == 0.5


def test_cli_config_matches_direct_construction():
    """The CLI must not re-introduce a frontend-only default."""
    from gpgpuraytrace.cli import _cfg_from_args

    for volumetric in (False, True):
        args = argparse.Namespace(
            size="64", max_steps=128, octaves=4, pallas=False,
            volumetric=volumetric, supersample=1,
        )
        cfg = _cfg_from_args(args)
        direct = RenderConfig(
            height=64, width=64, max_steps=128, num_octaves=4,
            use_pallas=False, volumetric=volumetric,
        )
        assert cfg.step_relax == direct.step_relax
        assert cfg == direct


def test_resolved_config_is_hashable_and_reprs_concrete():
    cfg = RenderConfig(volumetric=True)
    assert "step_relax=0.9" in repr(cfg)
    hash(cfg)  # static-arg use requires hashability post-resolution


def test_newton_iters_validated():
    with pytest.raises(ValueError, match="newton_iters"):
        RenderConfig(newton_iters=0)
    with pytest.raises(ValueError, match="newton_iters"):
        RenderConfig(newton_iters=-1)
    RenderConfig(newton_iters=1)  # the minimum is valid


def test_prime_ds_default_resolution():
    """Depth priming resolves like step_relax: None → the default where the
    config is eligible, 0 everywhere else."""
    assert RenderConfig().prime_ds == 8  # 512² chunked: eligible
    assert RenderConfig(volumetric=True).prime_ds == 8
    # The fixed-step instrument marches every step → resolves off.
    assert RenderConfig(march_mode="fixed").prime_ds == 0
    # Too small / indivisible → auto-off (no error on the default path).
    assert RenderConfig(height=48, width=64, max_steps=128).prime_ds == 0
    assert RenderConfig(height=100, width=100, max_steps=128).prime_ds == 0


def test_prime_ds_mode_replace_resolves_off():
    """dataclasses.replace(cfg, march_mode=...) from a resolved chunked
    config (the oracle-harness idiom) must not raise: the carried prime_ds
    resolves back to 0 for the non-chunked mode."""
    import dataclasses

    cfg = RenderConfig()
    assert cfg.prime_ds == 8
    gt = dataclasses.replace(cfg, march_mode="fixed", max_steps=1024)
    assert gt.prime_ds == 0


def test_prime_ds_explicit_validation():
    with pytest.raises(ValueError, match="prime_ds"):
        RenderConfig(prime_ds=1)
    with pytest.raises(ValueError, match="prime_ds"):
        RenderConfig(height=100, width=100, max_steps=128, prime_ds=8)
    with pytest.raises(ValueError, match="prime_margin"):
        RenderConfig(prime_margin=0.0)
    with pytest.raises(ValueError, match="prime_margin"):
        RenderConfig(prime_margin=1.2)
    assert RenderConfig(prime_ds=0).prime_ds == 0  # explicit off

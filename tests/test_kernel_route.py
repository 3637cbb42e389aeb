"""The GPU kernel's route (Pallas, Triton): interpret-mode parity at edge
shapes, the wrapper's padding and block grid, the platform choice, and a
cross-lowering of the kernels for CUDA (the Pallas → Triton lowering runs
on the CPU; only Triton's own compile needs the card)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpgpuraytrace.kernels.trace import _render_pallas_raw, render_pallas
from gpgpuraytrace.models.scene import RenderConfig, default_scene
from gpgpuraytrace.ops.render import render, render_jax
from gpgpuraytrace.utils import packing as pk
from tests.test_pallas import assert_mostly_close


@pytest.mark.parametrize(
    "h, w, vol",
    [(72, 200, False), (40, 96, False), (72, 72, True)],
    ids=["edge_blocks_primed", "edge_blocks_unprimed", "volumetric_edge"],
)
def test_kernel_matches_render_jax(h, w, vol):
    """Frames that are not whole blocks (72 and 200 are not multiples of
    8×32; 40 < 64 leaves priming off) match the XLA reference — the
    wrapper's padding and the padded lanes' masking at work."""
    cfg = RenderConfig(height=h, width=w, max_steps=48, num_octaves=3,
                       volumetric=vol, use_pallas=True, interpret=True)
    scene = default_scene(3, volumetric=vol)
    color, t, hit = _render_pallas_raw(scene, cfg)
    assert color.shape == (h, w, 3) and t.shape == (h, w) == hit.shape
    ref = render_jax(scene, dataclasses.replace(cfg, use_pallas=False))
    assert_mostly_close(color, ref, atol=2e-3, frac=0.999, msg="image")
    assert_mostly_close(color, ref, atol=1e-5, frac=0.99, msg="image-exact")


@pytest.mark.parametrize("block", [(8, 32), (16, 16)], ids=["8x32", "16x16"])
def test_block_grid_covers_frame(block):
    """One step counter per block of the ceil-divided grid; the padded
    lanes of the last row/column of blocks never march, so a block made
    only of padding would count zero steps."""
    bh, bw = block
    cfg = RenderConfig(height=24, width=40, max_steps=16, num_octaves=2,
                       block_h=bh, block_w=bw, use_pallas=True, interpret=True)
    *_, steps = _render_pallas_raw(default_scene(2), cfg, debug_steps=True)
    assert steps.shape == (-(-24 // bh), -(-40 // bw))
    assert (np.asarray(steps) % cfg.march_chunk == 0).all()


def test_pack_scene_pads_to_power_of_two():
    scene = default_scene(6)
    packed, seed = pk.pack_scene(scene, 512, 512)
    n = pk.AMPS + 6
    assert packed.shape == (64,) and seed.shape == (1,)
    np.testing.assert_array_equal(np.asarray(packed[n:]), 0.0)
    np.testing.assert_allclose(
        np.asarray(packed[pk.AMPS:n]), np.asarray(scene.noise.amplitudes)
    )
    assert int(seed[0]) == int(scene.noise.seed)


def test_render_config_chooses_xla_path_on_cpu():
    assert jax.default_backend() == "cpu"
    cfg = RenderConfig()
    assert cfg.use_pallas is False and cfg.interpret is False
    # The resolved value is part of the hashed config (AOT/jit cache keys).
    assert "use_pallas=False" in repr(cfg)


def test_kernel_request_off_gpu_raises_instead_of_interpreting():
    cfg = RenderConfig(height=16, width=32, max_steps=8, num_octaves=2,
                       use_pallas=True)
    with pytest.raises(ValueError, match="compile only for the GPU"):
        render(default_scene(2), cfg)


@pytest.mark.parametrize("field", ["block_h", "block_w", "num_warps"])
def test_block_config_must_be_powers_of_two(field):
    with pytest.raises(ValueError, match="power of two"):
        RenderConfig(**{field: 12})


@pytest.mark.parametrize("mode", ["lod", "compact"])
def test_removed_march_modes_are_rejected(mode):
    with pytest.raises(ValueError, match="march_mode"):
        RenderConfig(march_mode=mode)


@pytest.mark.parametrize("what", ["forward", "forward_backward"])
def test_kernels_lower_for_cuda(what, monkeypatch):
    """Cross-lower for CUDA: every primitive of both kernels has a Triton
    lowering and every in-kernel array is a power-of-two size. What this
    cannot see (Triton's compile, registers) is chip_smoke.py's job."""
    import gpgpuraytrace.kernels.trace as tr
    from gpgpuraytrace.ops.fit import partition_scene

    monkeypatch.setattr(tr, "_check_platform", lambda cfg: None)
    cfg = RenderConfig(height=64, width=96, max_steps=16, num_octaves=2,
                       use_pallas=True)
    scene = default_scene(2)
    if what == "forward":
        fn, args = (lambda s: tr._render_pallas_raw(s, cfg, debug_steps=True),
                    (scene,))
    else:
        leaves, merge = partition_scene(scene, trainable=lambda n: True)
        fn = jax.grad(lambda lv: jnp.mean(render_pallas(merge(lv), cfg) ** 2))
        args = (leaves,)
    exp = jax.export.export(
        jax.jit(fn), platforms=["cuda"],
        disabled_checks=[jax.export.DisabledSafetyCheck.custom_call(
            "__gpu$xla.gpu.triton")],
    )(*args)
    n_calls = exp.mlir_module().count("@__gpu$xla.gpu.triton")
    # forward: coarse prime pass + full pass; fwd+bwd adds the backward.
    assert n_calls == (2 if what == "forward" else 3)


@pytest.mark.gpu
def test_compiled_kernel_matches_reference(gpu_device):
    """The compiled kernel on the card (chip_smoke.py runs the full-size
    version of this check as its render phase)."""
    cfg = RenderConfig(height=128, width=128, num_octaves=4)
    assert cfg.use_pallas and not cfg.interpret
    scene = default_scene(4)
    img = render(scene, cfg)
    ref = render_jax(scene, dataclasses.replace(cfg, use_pallas=False))
    assert_mostly_close(img, ref, atol=2e-3, frac=0.999, msg="compiled")

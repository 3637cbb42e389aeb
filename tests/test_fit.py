"""Config-3 (BASELINE.json:9): the differentiable fit actually recovers
perturbed parameters, plus checkpoint round-trip and flythrough tests."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np

from gpgpuraytrace.models.scene import RenderConfig, default_scene
from gpgpuraytrace.ops.fit import fit, partition_scene, perturb_scene
from gpgpuraytrace.ops.render import render_jax

CFG = RenderConfig(height=48, width=64, max_steps=64, num_octaves=2, use_pallas=False)


def test_fit_recovers_amplitudes():
    target_scene = default_scene(num_octaves=2)
    target = render_jax(target_scene, CFG)
    bad = dataclasses.replace(
        target_scene,
        noise=dataclasses.replace(
            target_scene.noise,
            amplitudes=target_scene.noise.amplitudes * jnp.asarray([1.35, 0.7]),
        ),
    )
    fitted, losses = fit(
        bad,
        CFG,
        target,
        steps=120,
        learning_rate=1e-2,
        trainable=lambda n: n == "noise.amplitudes",
        log_every=0,
    )
    assert losses[-1] < 0.2 * losses[0], f"loss {losses[0]:.2e}->{losses[-1]:.2e}"
    err0 = np.abs(np.asarray(bad.noise.amplitudes - target_scene.noise.amplitudes))
    err1 = np.abs(np.asarray(fitted.noise.amplitudes - target_scene.noise.amplitudes))
    assert (err1 < err0).all(), f"amplitude error grew: {err0} -> {err1}"
    assert err1.max() < 0.5 * err0.max()


def test_fit_recovers_camera_pose():
    target_scene = default_scene(num_octaves=2)
    target = render_jax(target_scene, CFG)
    bad = dataclasses.replace(
        target_scene,
        camera=dataclasses.replace(
            target_scene.camera,
            yaw=target_scene.camera.yaw + 0.04,
            pitch=target_scene.camera.pitch - 0.02,
        ),
    )
    fitted, losses = fit(
        bad,
        CFG,
        target,
        steps=120,
        learning_rate=4e-3,
        trainable=lambda n: n in ("camera.yaw", "camera.pitch"),
        log_every=0,
    )
    assert losses[-1] < 0.3 * losses[0], f"loss {losses[0]:.2e}->{losses[-1]:.2e}"
    assert abs(float(fitted.camera.yaw - target_scene.camera.yaw)) < 0.02
    assert abs(float(fitted.camera.pitch - target_scene.camera.pitch)) < 0.02


def test_perturb_scene_changes_trainables():
    scene = default_scene(num_octaves=3)
    pert = perturb_scene(scene, jax.random.PRNGKey(1))
    assert not np.allclose(
        np.asarray(pert.noise.amplitudes), np.asarray(scene.noise.amplitudes)
    )
    assert float(pert.camera.yaw) != float(scene.camera.yaw)


def test_partition_scene_excludes_int_and_frozen():
    scene = default_scene(num_octaves=2)
    leaves, merge = partition_scene(scene)
    for leaf in leaves:
        assert jnp.issubdtype(leaf.dtype, jnp.floating)
    rebuilt = merge(leaves)
    assert int(rebuilt.noise.seed) == int(scene.noise.seed)
    np.testing.assert_array_equal(
        np.asarray(rebuilt.materials.sun_color), np.asarray(scene.materials.sun_color)
    )


def test_checkpoint_roundtrip(tmp_path):
    from gpgpuraytrace.utils.checkpoint import load_pytree, save_pytree

    scene = default_scene(num_octaves=3)
    path = os.path.join(tmp_path, "scene.npz")
    save_pytree(path, scene)
    other = perturb_scene(scene, jax.random.PRNGKey(3))
    restored = load_pytree(path, other)
    np.testing.assert_array_equal(
        np.asarray(restored.noise.amplitudes), np.asarray(scene.noise.amplitudes)
    )
    assert float(restored.camera.yaw) == float(scene.camera.yaw)
    assert int(restored.noise.seed) == int(scene.noise.seed)


def test_fit_kill_and_resume_is_exact(tmp_path):
    """Kill-and-resume: a fit checkpointed at step 6 and resumed for the
    remaining 6 steps lands on BITWISE the same parameters and losses as an
    uninterrupted 12-step run (SURVEY.md §6 resumability; the restored
    leaves/optimizer state are exact float32)."""
    small = dataclasses.replace(CFG, height=16, width=32, max_steps=16)
    target_scene = default_scene(num_octaves=2)
    target = render_jax(target_scene, small)
    bad = perturb_scene(target_scene, jax.random.PRNGKey(5), rel=0.2)
    path = os.path.join(tmp_path, "fit.npz")

    full, losses_full = fit(
        bad, small, target, steps=12, learning_rate=1e-2, log_every=0
    )
    # "Killed" run: stops at step 6, checkpoint written by save_every.
    fit(
        bad, small, target, steps=6, learning_rate=1e-2, log_every=0,
        save_path=path, save_every=6,
    )
    resumed, losses_resumed = fit(
        bad, small, target, steps=12, learning_rate=1e-2, log_every=0,
        save_path=path, save_every=6, resume=True,
    )
    assert losses_resumed == losses_full
    for a, b in zip(
        jax.tree_util.tree_leaves(resumed), jax.tree_util.tree_leaves(full)
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_fit_resume_without_checkpoint_starts_fresh(tmp_path):
    small = dataclasses.replace(CFG, height=16, width=32, max_steps=16)
    target_scene = default_scene(num_octaves=2)
    target = render_jax(target_scene, small)
    bad = perturb_scene(target_scene, jax.random.PRNGKey(5), rel=0.2)
    path = os.path.join(tmp_path, "missing.npz")
    _, losses = fit(
        bad, small, target, steps=3, learning_rate=1e-2, log_every=0,
        save_path=path, save_every=2, resume=True,
    )
    assert len(losses) == 3
    assert os.path.exists(path)


def test_flythrough_frames():
    from gpgpuraytrace.ops.flythrough import fly_frames

    scene = default_scene(num_octaves=2)
    cfg = dataclasses.replace(CFG, height=32, width=32, max_steps=32)
    frames = list(fly_frames(scene, cfg, num_frames=5, batch=2))
    assert [i for i, _ in frames] == [0, 1, 2, 3, 4]
    arr = np.stack([f for _, f in frames])
    assert arr.shape == (5, 32, 32, 3)
    assert np.isfinite(arr).all()
    # Camera moves → consecutive frames differ.
    assert not np.allclose(arr[0], arr[4], atol=1e-3)


def test_fit_steps_per_call_identical_trajectory():
    """Chunked driver loop (steps_per_call>1, lax.scan inside the dispatch)
    must produce the same losses and parameters as per-step dispatching —
    same math in the same order, only the launch granularity changes (the
    scan and loop programs may fuse/reassociate differently, so equality is
    to ~1e-4 relative, not bitwise). Covers a non-divisible tail chunk
    (7 steps in chunks of 3)."""
    small = dataclasses.replace(CFG, height=24, width=32, max_steps=32)
    target_scene = default_scene(num_octaves=2)
    target = render_jax(target_scene, small)
    bad = perturb_scene(target_scene, jax.random.PRNGKey(3), rel=0.1)

    fit1, losses1 = fit(bad, small, target, steps=7, learning_rate=1e-2,
                        log_every=0)
    fitk, lossesk = fit(bad, small, target, steps=7, learning_rate=1e-2,
                        log_every=0, steps_per_call=3)
    assert len(losses1) == len(lossesk) == 7
    np.testing.assert_allclose(losses1, lossesk, rtol=1e-4)
    # Params: tiny per-step reassociation differences are amplified through
    # 7 Adam updates on a silhouette-sensitive objective (measured ~1e-4
    # relative on CPU); a structural bug (stale target, dropped step, wrong
    # order) would show up at O(1), far above this tolerance.
    for a, b in zip(jax.tree_util.tree_leaves(fit1),
                    jax.tree_util.tree_leaves(fitk)):
        # atol is scaled to the optimizer, not the leaf: Adam moves each
        # leaf ~lr=1e-2 per step, so 1e-4 = 1% of ONE step's motion.
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-3, atol=1e-4
        )

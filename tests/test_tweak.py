"""Live tweak-variable subsystem (the reference's WPF tweak-UI / variable
hot-reload role, SURVEY.md §3.1): dotted-path overrides onto scene pytrees,
mtime-watched files, and the zero-recompile contract."""

import json

import jax
import numpy as np

from gpgpuraytrace.models.scene import RenderConfig, default_scene
from gpgpuraytrace.ops.render import render
from gpgpuraytrace.utils.tweak import (
    TweakWatcher,
    apply_tweaks,
    scene_variables,
    write_template,
)


def test_apply_tweaks_sets_leaves():
    scene = default_scene(num_octaves=2)
    scene2, rejected = apply_tweaks(
        scene,
        {
            "noise.height_scale": 9.5,
            "materials.sun_dir": [0.1, 0.9, 0.2],
            "camera.yaw": 0.4,
        },
    )
    assert rejected == []
    assert float(scene2.noise.height_scale) == 9.5
    np.testing.assert_allclose(np.asarray(scene2.materials.sun_dir), [0.1, 0.9, 0.2])
    assert float(scene2.camera.yaw) == np.float32(0.4)
    # untouched leaves survive
    np.testing.assert_allclose(
        np.asarray(scene2.noise.amplitudes), np.asarray(scene.noise.amplitudes)
    )


def test_apply_tweaks_rejects_bad_entries():
    scene = default_scene(num_octaves=2)
    scene2, rejected = apply_tweaks(
        scene,
        {
            "noise.no_such_leaf": 1.0,
            "materials.sun_dir": [1.0, 2.0],  # wrong shape
            "bogus": 3,
            "noise.height_offset": 1.25,  # valid — must still apply
        },
    )
    assert set(rejected) == {"noise.no_such_leaf", "materials.sun_dir", "bogus"}
    assert float(scene2.noise.height_offset) == 1.25


def test_template_roundtrip(tmp_path):
    scene = default_scene(num_octaves=3)
    path = tmp_path / "tweaks.json"
    write_template(str(path), scene)
    loaded = json.loads(path.read_text())
    assert loaded == scene_variables(scene)
    # The full template applies cleanly back onto the scene.
    scene2, rejected = apply_tweaks(scene, loaded)
    assert rejected == []
    for a, b in zip(jax.tree_util.tree_leaves(scene), jax.tree_util.tree_leaves(scene2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b))


def test_watcher_detects_change(tmp_path):
    path = tmp_path / "live.json"
    w = TweakWatcher(str(path))
    assert w.poll() is None  # missing file is fine
    path.write_text('{"noise.height_scale": 7.0}')
    assert w.poll() == {"noise.height_scale": 7.0}
    assert w.poll() is None  # unchanged → no re-read
    import os

    path.write_text('{"noise.height_scale": 8.0}')
    os.utime(path, (os.stat(path).st_atime, os.stat(path).st_mtime + 2))
    assert w.poll() == {"noise.height_scale": 8.0}
    # malformed JSON: skipped, retried after the next change
    path.write_text('{"broken"')
    os.utime(path, (os.stat(path).st_atime, os.stat(path).st_mtime + 4))
    assert w.poll() is None


def test_tweaked_scene_renders_without_recompile():
    """Tweaks are traced-arg changes: the same jitted executable must serve
    the tweaked scene (cache hit), and the image must actually change."""
    cfg = RenderConfig(height=16, width=32, max_steps=8, num_octaves=2, use_pallas=False)
    scene = default_scene(num_octaves=2)
    f = jax.jit(lambda s: render(s, cfg))
    img0 = f(scene)
    compiles0 = f._cache_size()
    scene2, _ = apply_tweaks(scene, {"noise.height_scale": 9.0, "camera.pitch": -0.5})
    img1 = f(scene2)
    assert f._cache_size() == compiles0, "tweak caused a recompile"
    assert not np.allclose(np.asarray(img0), np.asarray(img1))

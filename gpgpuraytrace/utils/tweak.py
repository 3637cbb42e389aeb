"""Live tweak variables: runtime scene-parameter editing without recompiles.

Parity target: the reference's WPF tweak UI and its shader variable system
(SURVEY.md §3.1 "WPF UI plumbing" and "Shader hot-reload / variable system"
rows) — a 2011 D3D11 app edited tweakables in a C# window and pushed them to
the GPU via constant buffers per frame. The headless equivalent here:
scene parameters are pytree leaves and *traced* jit arguments, so changing
one never recompiles; this module adds the interactive loop around that — a
watched JSON file of dotted-path overrides that a running ``fly`` (or any
driver loop) re-reads whenever it changes.

    # terminal 1
    python -m gpgpuraytrace.cli fly --frames 9999 --tweak live.json -o frames/
    # terminal 2: edit live.json; the next batch of frames picks it up
    {"noise.height_scale": 8.0, "materials.fog_density": 0.03,
     "materials.sun_dir": [0.2, 0.8, 0.1]}

No file watcher daemons, no UI toolkit: an mtime poll per frame batch (the
render dominates by orders of magnitude). Unknown names and malformed JSON
are reported and skipped — a live-editing loop must never crash the renderer
mid-flight.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import jax.numpy as jnp

from gpgpuraytrace.models.scene import Scene


def scene_variables(scene: Scene) -> dict[str, Any]:
    """Flatten a scene into {dotted.path: python value} — the full tweakable
    menu (every differentiable leaf plus the integer seed)."""
    out: dict[str, Any] = {}
    for group_name in ("noise", "camera", "materials"):
        group = getattr(scene, group_name)
        for f in dataclasses.fields(group):
            v = getattr(group, f.name)
            arr = jnp.asarray(v)
            out[f"{group_name}.{f.name}"] = (
                arr.tolist() if arr.ndim else arr.item()
            )
    return out


def write_template(path: str, scene: Scene) -> None:
    """Dump the current scene as an editable tweak file (the 'open the tweak
    window' moment: start from live values, edit, save)."""
    with open(path, "w") as f:
        json.dump(scene_variables(scene), f, indent=2, sort_keys=True)
        f.write("\n")


def apply_tweaks(scene: Scene, tweaks: dict[str, Any]) -> tuple[Scene, list[str]]:
    """Apply {dotted.path: value} overrides. Returns (scene, rejected_names).

    Values coerce to the leaf's existing dtype/shape; a mismatched shape or
    unknown name rejects that entry (reported, not raised).
    """
    rejected: list[str] = []
    groups: dict[str, dict[str, Any]] = {}
    for name, value in tweaks.items():
        parts = name.split(".")
        if len(parts) != 2 or parts[0] not in ("noise", "camera", "materials"):
            rejected.append(name)
            continue
        group_name, leaf_name = parts
        group = getattr(scene, group_name)
        if not hasattr(group, leaf_name):
            rejected.append(name)
            continue
        old = jnp.asarray(getattr(group, leaf_name))
        try:
            new = jnp.asarray(value, dtype=old.dtype).reshape(old.shape)
        except (TypeError, ValueError):
            rejected.append(name)
            continue
        groups.setdefault(group_name, {})[leaf_name] = new
    for group_name, updates in groups.items():
        scene = dataclasses.replace(
            scene,
            **{group_name: dataclasses.replace(getattr(scene, group_name), **updates)},
        )
    return scene, rejected


class TweakWatcher:
    """mtime-polling watcher over a tweak JSON file.

    ``poll()`` returns the parsed override dict when the file has (re)appeared
    or changed since the last poll, else None. Malformed JSON returns None
    and keeps the previous mtime so a half-saved file is retried on the next
    change. Missing file is fine — it can be created while the loop runs.
    """

    def __init__(self, path: str):
        self.path = path
        self._mtime: float | None = None

    def poll(self) -> dict[str, Any] | None:
        try:
            mtime = os.stat(self.path).st_mtime
        except OSError:
            return None
        if mtime == self._mtime:
            return None
        try:
            with open(self.path) as f:
                tweaks = json.load(f)
        except (OSError, json.JSONDecodeError):
            return None
        if not isinstance(tweaks, dict):
            return None
        self._mtime = mtime
        return tweaks

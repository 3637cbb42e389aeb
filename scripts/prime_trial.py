"""Depth-priming trial: coarse-prepass march-start priming (cfg.prime_ds)
vs the unprimed chunked march — speed (wall-ladder differencing) + quality
vs the 1024-step dense oracle, in one run.

Motivation: the march's cost is its executed steps. Priming attacks the
USEFUL step count: a (H/ds, W/ds) coarse march costs ~1/ds² of the frame, and
starting every fine ray at prime_margin × its 3×3 coarse-neighborhood
minimum skips the empty-space march entirely (all-miss neighborhoods skip
the fine march altogether). Not certified — features thinner than the
coarse sampling that all nine neighbors step over are lost; this harness
quantifies exactly that against the dense oracle, same contract as the
relax/newton sweeps (scripts/relax_sweep.py).

Usage: python scripts/prime_trial.py [--size 512] [--octaves 6]
       [--variants 4:0.8,4:0.9,8:0.9] [--volumetric] [--steps]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from gpgpuraytrace.models.scene import RenderConfig, default_scene
from gpgpuraytrace.kernels.trace import _render_pallas_raw

from gpgpuraytrace.utils.cache import enable_compile_cache

enable_compile_cache()


def time_forward(scene, cfg):
    """40→80-frame wall ladder: the slope cancels the fixed per-dispatch
    cost. The primed render's coarse pass runs inside the same jit — the
    ladder times the end-to-end frame including the prepass."""
    @jax.jit
    def run(salt, n):
        def body(i, acc):
            s = dataclasses.replace(scene, noise=dataclasses.replace(
                scene.noise,
                height_offset=scene.noise.height_offset
                + (salt + i.astype(jnp.float32)) * 1e-6))
            _, t, _ = _render_pallas_raw(s, cfg)
            return acc + t.sum()
        return jax.lax.fori_loop(0, n, body, jnp.float32(0.0))

    float(run(jnp.float32(900.0), 1))

    def timed(n, salt):
        t0 = time.perf_counter()
        float(run(jnp.float32(salt), n))
        return time.perf_counter() - t0

    from gpgpuraytrace.utils.timing import process_salt_base
    base = process_salt_base()
    timed(40, base + 800.0)  # warm
    t_40 = min(timed(40, base + 100.0 * r) for r in range(1, 3))
    t_80 = min(timed(80, base + 100.0 * r + 50.0) for r in range(1, 3))
    return max(t_80 - t_40, 1e-9) / 40.0


def exec_steps(scene, cfg):
    """Kernel-measured per-block executed steps/ray (the debug_steps
    counter; covers the FINE march only — the coarse pass's own steps are
    not in this number, its cost shows up in the wall ladder)."""
    out = _render_pallas_raw(scene, cfg, debug_steps=True)
    counts = np.asarray(out[3], np.float64)
    return float(counts.mean())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--octaves", type=int, default=6)
    ap.add_argument("--variants", type=str,
                    default="4:0.8,4:0.9,4:0.95,8:0.9")
    ap.add_argument("--volumetric", action="store_true")
    ap.add_argument("--rough", action="store_true",
                    help="the rough-terrain robustness case "
                    "(amplitude decay 0.65, height_scale 8) — the regime "
                    "where relax already mis-renders; priming must not "
                    "compound it")
    ap.add_argument("--steps", action="store_true",
                    help="also record the fine-march executed-steps counter")
    args = ap.parse_args()
    n = args.size
    scene = default_scene(num_octaves=args.octaves,
                          volumetric=args.volumetric)
    if args.rough:
        amps = jnp.asarray(
            [0.65 ** i for i in range(args.octaves)], jnp.float32
        )
        scene = dataclasses.replace(
            scene,
            noise=dataclasses.replace(
                scene.noise, amplitudes=amps,
                height_scale=jnp.float32(8.0),
            ),
        )
    base = dict(height=n, width=n, max_steps=128, num_octaves=args.octaves,
                use_pallas=True, volumetric=args.volumetric)

    gt_cfg = RenderConfig(**base | {"max_steps": 1024}, march_mode="fixed",
                          step_relax=0.2 if args.volumetric else 0.35,
                          step_floor_t=0.0)
    img_gt, t_gt, hit_gt = _render_pallas_raw(scene, gt_cfg)
    hit_gt = np.asarray(hit_gt)
    t_gt = np.asarray(t_gt)
    img_gt = np.asarray(img_gt)

    variants = [(0, 0.0)]
    for v in args.variants.split(","):
        if v:
            ds, margin = v.split(":")
            variants.append((int(ds), float(margin)))

    for ds, margin in variants:
        # ds=0 must PIN prime off: an empty kw would leave prime_ds=None,
        # which auto-resolves to the shipping default (8) since priming
        # became the default — the "unprimed baseline" would silently be
        # primed.
        kw = {"prime_ds": 0} if ds == 0 else {
            "prime_ds": ds, "prime_margin": margin}
        cfg = RenderConfig(**base, **kw)
        try:
            img, t, hit = _render_pallas_raw(scene, cfg)
            hit = np.asarray(hit)
            t = np.asarray(t)
            img = np.asarray(img)
            holes = int((hit_gt & ~hit).sum())
            false_hits = int((~hit_gt & hit).sum())
            both = hit_gt & hit
            terr = np.abs(t - t_gt)[both]
            derr = np.abs(img - img_gt)
            sec = time_forward(scene, cfg)
            rec = {
                "prime_ds": ds,
                "prime_margin": margin,
                "mrays_per_sec": round(n * n / sec / 1e6, 1),
                "ms_per_frame": round(sec * 1e3, 3),
                "holes_px": holes,
                "false_hit_px": false_hits,
                "t_err_gt_0.05_px": int((terr > 0.05).sum()),
                "img_mean_abs_err": round(float(derr.mean()), 6),
                "img_px_gt_0.05": int((derr.max(axis=-1) > 0.05).sum()),
                "hit_rate": round(float(hit.mean()), 4),
            }
            if args.steps:
                rec["exec_steps_per_ray"] = round(exec_steps(scene, cfg), 2)
            print(json.dumps(rec), flush=True)
        except Exception as e:  # noqa: BLE001
            print(json.dumps({"prime_ds": ds, "prime_margin": margin,
                              "error": f"{type(e).__name__}: {str(e)[:160]}"}),
                  flush=True)


if __name__ == "__main__":
    main()

"""step_relax over-relaxation sweep: speed (salted differencing) + quality
vs a dense ground truth, in one run.

Motivation: the march's cost is its executed steps, so one lever is
executing fewer steps per ray. ``step_relax`` scales each step by relax·f; the heightfield
is not an SDF so relax < 1 is conservative, but the march's bracketed
Newton polish RECOVERS oversteps (an overstep lands at f < 0, flags as a
hit, and the polish pulls it back to the exact root) — unlike the
march_eps_scale knob, whose premature hits get rejected and leave sky
holes. The failure mode of large relax is stepping clean over a thin ridge
(f dips negative and back between samples): that ray misses terrain it
should hit. This sweep quantifies exactly that against a 1024-step
fixed-mode dense march.

Usage: python scripts/relax_sweep.py [--size 512] [--octaves 6]
       [--relax 0.7,0.9,1.1,1.3]
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


def render_th(scene, cfg):
    return _render_pallas_raw(scene, cfg)


def time_forward(scene, cfg):
    """Ladder differencing: slope of wall(n=80) - wall(n=40) over 40 frames.

    Both endpoints carry the same single-dispatch overhead, so the slope is
    the per-frame cost.
    """
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

    # Process-unique fractional salt base (replay-cache + perturbation-
    # scale traps; utils/timing.py).
    from gpgpuraytrace.utils.timing import process_salt_base
    base = process_salt_base()
    timed(40, base + 800.0)  # warm
    t_40 = min(timed(40, base + 100.0 * r) for r in range(1, 3))
    t_80 = min(timed(80, base + 100.0 * r + 50.0) for r in range(1, 3))
    return max(t_80 - t_40, 1e-9) / 40.0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--octaves", type=int, default=6)
    ap.add_argument("--relax", type=str, default="0.7,0.8,0.9,1.0,1.2")
    ap.add_argument("--newton", type=str, default="",
                    help="sweep newton_iters at the FIRST --relax value "
                    "instead of sweeping relax")
    ap.add_argument("--volumetric", action="store_true")
    args = ap.parse_args()
    n = args.size
    scene = default_scene(num_octaves=args.octaves,
                          volumetric=args.volumetric)
    base = dict(height=n, width=n, max_steps=128, num_octaves=args.octaves,
                use_pallas=True, volumetric=args.volumetric)

    # Dense ground truth: 1024 fixed steps, conservative relax, no floor —
    # the same oracle the step_floor_t calibration used.
    gt_cfg = RenderConfig(**base | {"max_steps": 1024}, march_mode="fixed",
                          step_relax=0.2 if args.volumetric else 0.35,
                          step_floor_t=0.0)
    img_gt, t_gt, hit_gt = render_th(scene, gt_cfg)
    hit_gt = np.asarray(hit_gt)
    t_gt = np.asarray(t_gt)
    img_gt = np.asarray(img_gt)

    relaxes = [float(r) for r in args.relax.split(",") if r]
    if args.newton:
        combos = [(relaxes[0], int(k)) for k in args.newton.split(",") if k]
    else:
        combos = [(r, None) for r in relaxes]
    for relax, newton in combos:
        kw = {} if newton is None else {"newton_iters": newton}
        # prime_ds=0: this sweep calibrates step_relax/newton against the
        # dense oracle in isolation; since depth priming is the default the
        # candidates would otherwise auto-prime and
        # coarse-sampling misses would be attributed to relax values. The
        # relax×prime interaction is measured deliberately in
        # scripts/prime_trial.py.
        cfg = RenderConfig(**base, step_relax=relax, prime_ds=0, **kw)
        try:
            img, t, hit = render_th(scene, cfg)
            hit = np.asarray(hit)
            t = np.asarray(t)
            img = np.asarray(img)
            holes = int((hit_gt & ~hit).sum())       # GT hit, variant missed
            false_hits = int((~hit_gt & hit).sum())  # variant hit, GT missed
            both = hit_gt & hit
            terr = np.abs(t - t_gt)[both]
            derr = np.abs(img - img_gt)
            sec = time_forward(scene, cfg)
            print(json.dumps({
                "relax": relax,
                **({} if newton is None else {"newton_iters": newton}),
                "mrays_per_sec": round(n * n / sec / 1e6, 1),
                "ms_per_frame": round(sec * 1e3, 3),
                "holes_px": holes,
                "false_hit_px": false_hits,
                "t_err_gt_0.05_px": int((terr > 0.05).sum()),
                "t_err_p999": round(float(np.percentile(terr, 99.9)), 4)
                if terr.size else 0.0,
                "max_t_err_on_hits": round(float(terr.max()), 3)
                if terr.size else 0.0,
                "img_mean_abs_err": round(float(derr.mean()), 6),
                "img_px_gt_0.05": int((derr.max(axis=-1) > 0.05).sum()),
                "hit_rate": round(float(hit.mean()), 4),
            }), flush=True)
        except Exception as e:  # noqa: BLE001
            print(json.dumps({"relax": relax,
                              "error": f"{type(e).__name__}: {str(e)[:120]}"}),
                  flush=True)


if __name__ == "__main__":
    main()

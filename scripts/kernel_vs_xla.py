"""Hand-written kernel vs XLA's build of the plain version, on one GPU.

Times, end to end at one config (default 512²×6 octaves, max_steps 128):

* forward: ``render`` with the fused kernel vs the pure-XLA path;
* fwd+bwd over every float scene leaf: kernel forward + fused backward
  kernel, kernel forward + XLA checkpoint backward, and the pure-XLA path;
* ``--sweep``: the forward kernel over block shape, warps and march chunk
  (``BHxBWxWARPSxCHUNK`` items, comma-separated).

Variants that are compared are timed in interleaved rounds (one call of
each per round, ``--reps`` rounds, after two warm-up calls each), each call
ending in ``block_until_ready``; the median per variant is reported. Every
line names the card and its power limit. Needs a GPU; exits non-zero
without one.

    python scripts/kernel_vs_xla.py [--size 512] [--volumetric]
        [--block 8x16x4x8] [--sweep 8x16x4x8,4x32x4x8]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gpgpuraytrace.utils.cache import enable_compile_cache  # noqa: E402
from gpgpuraytrace.utils.timing import interleaved_ms  # noqa: E402



def parse_block(spec: str) -> dict:
    bh, bw, nw, ch = (int(v) for v in spec.split("x"))
    return dict(block_h=bh, block_w=bw, num_warps=nw, march_chunk=ch)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--octaves", type=int, default=6)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--volumetric", action="store_true")
    ap.add_argument("--block", default="",
                    help="BHxBWxWARPSxCHUNK for the kernel (default: config)")
    ap.add_argument("--sweep", default="",
                    help="comma-separated BHxBWxWARPSxCHUNK forward variants")
    ap.add_argument("--no-bwd", action="store_true")
    args = ap.parse_args()

    enable_compile_cache()
    if jax.devices()[0].platform != "gpu":
        print("kernel_vs_xla: no GPU found", file=sys.stderr)
        return 2
    from gpgpuraytrace.models.scene import RenderConfig, default_scene
    from gpgpuraytrace.ops.fit import partition_scene
    from gpgpuraytrace.ops.render import render

    tag = card()
    n = args.size
    base = RenderConfig(height=n, width=n, num_octaves=args.octaves,
                        volumetric=args.volumetric,
                        **(parse_block(args.block) if args.block else {}))
    assert base.use_pallas and not base.interpret
    scene = default_scene(args.octaves, volumetric=args.volumetric)
    desc = f"{n}x{n} oct={args.octaves} vol={args.volumetric}"

    def report(name, cfg, ms, first, extra=None):
        rec = {"card": tag, "config": desc, "variant": name,
               "ms": round(ms, 4), "mrays_per_s": round(n * n / ms / 1e3, 2),
               "first_call_s": round(first, 2),
               "block": [cfg.block_h, cfg.block_w], "num_warps": cfg.num_warps,
               "march_chunk": cfg.march_chunk}
        rec.update(extra or {})
        print(json.dumps(rec), flush=True)

    def fwd(cfg):
        return jax.jit(lambda s: render(s, cfg))

    xcfg = dataclasses.replace(base, use_pallas=False)
    variants = (("xla_fwd", xcfg), ("kernel_fwd", base))
    times = interleaved_ms([fwd(c) for _, c in variants], (scene,), args.reps)
    for (name, cfg), (ms, first) in zip(variants, times):
        report(name, cfg, ms, first)

    if not args.no_bwd:
        leaves, merge = partition_scene(scene, trainable=lambda name: True)

        def step(cfg):
            def loss(lv):
                img = render(merge(lv), cfg)
                return jnp.mean(img * img)
            return jax.jit(jax.value_and_grad(loss))

        variants = (
            ("xla_fwdbwd", xcfg),
            ("kernel_fwd+xla_ckpt_bwd", dataclasses.replace(base, pallas_bwd=False)),
            ("kernel_fwd+kernel_bwd", dataclasses.replace(base, pallas_bwd=True)),
        )
        times = interleaved_ms([step(c) for _, c in variants], (leaves,),
                               args.reps)
        for (name, cfg), (ms, first) in zip(variants, times):
            report(name, cfg, ms, first)

    if args.sweep:
        cfgs = [dataclasses.replace(base, **parse_block(spec))
                for spec in args.sweep.split(",")]
        times = interleaved_ms([fwd(c) for c in cfgs], (scene,), args.reps)
        for cfg, (ms, first) in zip(cfgs, times):
            report("sweep_fwd", cfg, ms, first)
    return 0


if __name__ == "__main__":
    sys.exit(main())

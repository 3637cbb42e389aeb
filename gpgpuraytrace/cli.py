"""CLI entry points: render / fit / fly / bench (SURVEY.md §3.3 `run/`).

Replaces the reference's WPF/Win32 shell (BASELINE.json:5 "C++/WPF engine
plumbing deleted") with headless commands writing PNG/NPY.

  python -m gpgpuraytrace.cli render --size 512 --octaves 6 -o frame.png
  python -m gpgpuraytrace.cli fit --size 128 --steps 100
  python -m gpgpuraytrace.cli fly --size 1920x1080 --frames 60 -o frames/
  python -m gpgpuraytrace.cli bench --size 512
"""

from __future__ import annotations

import argparse
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np


def _parse_size(s: str) -> tuple[int, int]:
    if "x" in s:
        w, h = s.split("x")
        return int(h), int(w)
    return int(s), int(s)


def _cfg_from_args(args) -> "RenderConfig":
    from gpgpuraytrace.models.scene import RenderConfig

    h, w = _parse_size(args.size)
    return RenderConfig(
        height=h,
        width=w,
        max_steps=args.max_steps,
        num_octaves=args.octaves,
        # None lets RenderConfig choose the path from the platform (the
        # fused kernel on the GPU, XLA elsewhere); --pallas on a platform
        # the kernel does not compile for raises when the kernel runs.
        use_pallas=args.pallas,
        volumetric=getattr(args, "volumetric", False),
        # step_relax and prime_ds stay at their None defaults: RenderConfig
        # resolves the per-mode relax (1.0 heightfield / 0.9 volumetric)
        # and the depth-prime eligibility itself, so every construction
        # path — CLI, library, scripts — agrees. --prime-ds overrides (0
        # disables, explicit ds validates strictly).
        supersample=getattr(args, "supersample", 1),
        prime_ds=getattr(args, "prime_ds", None),
        **(
            {"prime_margin": args.prime_margin}
            if getattr(args, "prime_margin", None) is not None
            else {}
        ),
    )


def _aot_dir() -> str:
    from gpgpuraytrace.utils.cache import cache_dir

    return cache_dir()


def cmd_render(args):
    from gpgpuraytrace.models.scene import default_scene
    from gpgpuraytrace.ops.render import render_jit
    from gpgpuraytrace.ops.shade import tonemap
    from gpgpuraytrace.utils.image import write_npy, write_png
    from gpgpuraytrace.utils.profiling import warn_if_rough

    cfg = _cfg_from_args(args)
    scene = default_scene(num_octaves=cfg.num_octaves, volumetric=cfg.volumetric)
    warn_if_rough(scene, cfg)
    t0 = time.perf_counter()
    aot_status = None
    if getattr(args, "aot_cache", False):
        # Opt-in AOT executable cache: restore the serialized compiled
        # program from the cache directory, skipping lowering AND compile
        # on a warm cache.
        from gpgpuraytrace.ops.render import render
        from gpgpuraytrace.utils.aot import load_or_compile

        compiled, aot_status = load_or_compile(
            jax.jit(lambda s: render(s, cfg)), (scene,),
            static_desc=repr(cfg),
            cache_dir=_aot_dir(),
        )
        render_fn = compiled
    else:
        render_fn = lambda s: render_jit(s, cfg)  # noqa: E731
    img = jax.block_until_ready(render_fn(scene))
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax.block_until_ready(render_fn(scene))
    frame_s = time.perf_counter() - t0
    out = np.asarray(tonemap(img))
    if args.out.endswith(".npy"):
        write_npy(args.out, out)
    else:
        write_png(args.out, out)
    rays = cfg.height * cfg.width / frame_s
    aot = f"  aot={aot_status}" if aot_status else ""
    print(
        f"rendered {cfg.width}x{cfg.height} ({cfg.num_octaves} octaves, "
        f"pallas={cfg.use_pallas}, {jax.default_backend()}) -> {args.out}  "
        f"compile {compile_s:.1f}s  frame {frame_s * 1e3:.2f}ms  "
        f"{rays / 1e6:.1f} Mrays/s (one warm frame, host clock)"
        f"{aot}"
    )


def cmd_fit(args):
    from gpgpuraytrace.models.scene import default_scene
    from gpgpuraytrace.ops.fit import fit, perturb_scene
    from gpgpuraytrace.ops.render import render_jit

    cfg = _cfg_from_args(args)
    target_scene = default_scene(num_octaves=cfg.num_octaves, volumetric=cfg.volumetric)
    target = jax.block_until_ready(render_jit(target_scene, cfg))
    scene0 = perturb_scene(target_scene, jax.random.PRNGKey(args.seed), rel=0.15)
    scene, losses = fit(
        scene0, cfg, target, steps=args.steps, learning_rate=args.lr,
        save_path=args.save, save_every=args.save_every, resume=args.resume,
        steps_per_call=args.steps_per_call,
        aot_cache=_aot_dir() if getattr(args, "aot_cache", False) else "",
    )
    print(
        f"fit: loss {losses[0]:.4e} -> {losses[-1]:.4e} over {len(losses)} steps"
    )
    amp_err = float(
        jnp.max(jnp.abs(scene.noise.amplitudes - target_scene.noise.amplitudes))
    )
    print(f"max |amplitude error| = {amp_err:.4f}")
    if args.out:
        np.savez(
            args.out,
            losses=np.asarray(losses),
            amplitudes=np.asarray(scene.noise.amplitudes),
        )


def cmd_fly(args):
    from gpgpuraytrace.models.scene import default_scene
    from gpgpuraytrace.ops.flythrough import fly_frames
    from gpgpuraytrace.utils.image import write_png
    from gpgpuraytrace.utils.tweak import TweakWatcher, apply_tweaks

    cfg = _cfg_from_args(args)
    scene = default_scene(num_octaves=cfg.num_octaves, volumetric=cfg.volumetric)
    from gpgpuraytrace.utils.profiling import warn_if_rough

    warn_if_rough(scene, cfg)
    # Live tweak variables (the reference's WPF tweak-UI role): edit the
    # watched JSON while the loop runs; params are traced args, so updates
    # apply on the next frame batch with zero recompilation.
    watcher = TweakWatcher(args.tweak) if args.tweak else None

    def on_batch(s):
        if watcher is None:
            return s
        tweaks = watcher.poll()
        if tweaks is None:
            return s
        s, rejected = apply_tweaks(s, tweaks)
        warn_if_rough(s, cfg)  # live edits can push the scene rough
        applied = [k for k in tweaks if k not in rejected]
        if applied:
            print(f"tweaks applied: {', '.join(applied)}")
        for name in rejected:
            print(f"tweak rejected (unknown name or bad shape): {name}")
        return s

    os.makedirs(args.out, exist_ok=True)
    ext = "rgb" if args.format == "rgb" else "png"
    level = args.encode_level
    t0 = time.perf_counter()
    n = 0
    # Prefer the native async writer (worker threads encode+write while the
    # accelerator renders the next batch); fall back to sync Python writes.
    writer = None
    try:
        from gpgpuraytrace.utils.native_io import AsyncFrameWriter

        writer = AsyncFrameWriter(num_threads=2, level=level)
    except Exception:
        pass
    try:
        for idx, frame in fly_frames(
            scene, cfg, args.frames, batch=args.batch, on_batch=on_batch,
            aot_cache=_aot_dir() if getattr(args, "aot_cache", False) else "",
        ):
            path = os.path.join(args.out, f"frame_{idx:04d}.{ext}")
            if writer is not None:
                writer.push(path, frame)  # uint8 straight from the device
            else:
                write_png(path, frame, level=level)
            n += 1
    finally:
        if writer is not None:
            writer.close()
    dt = time.perf_counter() - t0
    print(
        f"flythrough: {n} frames {cfg.width}x{cfg.height} in {dt:.1f}s "
        f"({n / dt:.2f} fps incl. IO, native={writer is not None}, "
        f"format={ext}" + (f" zlib={level}" if ext == "png" else "") + ")"
    )


def cmd_tweaks(args):
    from gpgpuraytrace.models.scene import default_scene
    from gpgpuraytrace.utils.tweak import write_template

    cfg = _cfg_from_args(args)
    scene = default_scene(num_octaves=cfg.num_octaves, volumetric=cfg.volumetric)
    write_template(args.out, scene)
    print(f"wrote tweak template -> {args.out} (edit while `fly --tweak {args.out}` runs)")


def cmd_bench(args):
    import bench as bench_mod  # repo-root bench harness

    result = bench_mod.run_bench(
        size=_parse_size(args.size), octaves=args.octaves, iters=args.iters
    )
    print(json.dumps(result))


def main(argv=None):
    p = argparse.ArgumentParser(prog="gpgpuraytrace")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument(
            "--cpu",
            action="store_true",
            help="force the CPU backend",
        )
        sp.add_argument("--size", default="512", help="N or WxH")
        sp.add_argument("--octaves", type=int, default=6)
        sp.add_argument("--max-steps", type=int, default=128)
        sp.add_argument(
            "--pallas",
            default=None,
            action=argparse.BooleanOptionalAction,
            help="force the fused kernel on/off (default: on for the GPU, "
            "the XLA path elsewhere)",
        )
        sp.add_argument("--supersample", type=int, default=1, help="SSAA factor")
        sp.add_argument(
            "--volumetric",
            action="store_true",
            help="3D-warped terrain volume (overhangs); uses a smaller march step",
        )
        sp.add_argument(
            "--aot-cache", action="store_true",
            help="serialize/restore the compiled executable in the compile "
            "cache directory (utils/aot.py)",
        )
        sp.add_argument(
            "--prime-ds", type=int, default=None,
            help="depth-priming coarse-prepass factor (default: auto — 8 "
            "when eligible; 0 disables; see RenderConfig.prime_ds)",
        )
        sp.add_argument(
            "--prime-margin", type=float, default=None,
            help="pull-back on the coarse neighborhood min (default 0.95)",
        )

    sp = sub.add_parser("render", help="render one frame")
    common(sp)
    sp.add_argument("-o", "--out", default="frame.png")
    sp.set_defaults(fn=cmd_render)

    sp = sub.add_parser("fit", help="recover params from a target image")
    common(sp)
    sp.add_argument("--steps", type=int, default=300)
    sp.add_argument("--lr", type=float, default=5e-3)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument(
        "--save", default="", metavar="PATH",
        help="checkpoint trainable params + optimizer state to PATH (.npz)",
    )
    sp.add_argument(
        "--save-every", type=int, default=25,
        help="checkpoint interval in steps (with --save)",
    )
    sp.add_argument(
        "--resume", action="store_true",
        help="resume from --save PATH if it exists (exact continuation)",
    )
    sp.add_argument(
        "--steps-per-call", type=int, default=1,
        help="optimizer steps per compiled dispatch (lax.scan chunk); "
        "identical trajectory, amortizes launch latency",
    )
    sp.add_argument("-o", "--out", default="")
    sp.set_defaults(fn=cmd_fit)

    sp = sub.add_parser("fly", help="animated flythrough frames")
    common(sp)
    sp.add_argument("--frames", type=int, default=60)
    sp.add_argument("--batch", type=int, default=4, help="temporal ray batch")
    sp.add_argument(
        "--tweak",
        default="",
        help="watched JSON file of live scene overrides "
        '(e.g. {"noise.height_scale": 8.0}); re-read whenever it changes',
    )
    sp.add_argument(
        "--encode-level", type=int, default=6, metavar="0-9",
        help="PNG zlib effort; lower is faster encode / larger files",
    )
    sp.add_argument(
        "--format", choices=["png", "rgb"], default="png",
        help="rgb = raw rgb24 frame dumps, no encoder "
        "(ffmpeg -f rawvideo -pix_fmt rgb24 -s WxH reads them)",
    )
    sp.add_argument("-o", "--out", default="frames")
    sp.set_defaults(fn=cmd_fly)

    sp = sub.add_parser(
        "tweaks", help="write an editable tweak-file template of the scene"
    )
    common(sp)
    sp.add_argument("-o", "--out", default="tweaks.json")
    sp.set_defaults(fn=cmd_tweaks)

    sp = sub.add_parser("bench", help="benchmark fwd+bwd rays/s")
    common(sp)
    sp.add_argument("--iters", type=int, default=20)
    sp.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    if getattr(args, "cpu", False):
        jax.config.update("jax_platforms", "cpu")
    from gpgpuraytrace.utils.cache import enable_compile_cache

    enable_compile_cache()
    args.fn(args)


if __name__ == "__main__":
    main()

"""Evidence for the grad-psum / backward-march overlap claim (BASELINE.json:5
"all-reduced and overlapped with the backward march"; SURVEY.md §8 hard-part 4
"needs profiling to confirm actual overlap").

Two kinds of evidence:

1. **Compiled-schedule analysis** — lower the sharded fwd+bwd step on an
   N-device mesh and inspect the optimized, scheduled HLO: count the
   all-reduce ops the per-leaf psum design produces, whether XLA emitted them
   as async start/done pairs, and how many compute ops are scheduled inside
   each start→done window (the overlap the latency-hiding scheduler actually
   committed to). This is the ground truth of what will execute on hardware
   of the same topology.

2. **Profiler trace** — optionally (``--trace DIR``) capture a
   ``jax.profiler`` trace of K sharded fit steps for TensorBoard/Perfetto
   inspection.

By default the mesh is N virtual CPU devices; the schedule analysis then
reflects the CPU backend's collective lowering (which may serialize) — the
JSON labels which backend produced the evidence. With ``--real`` on N GPUs
the same script reports the NCCL schedule. Either way the *per-leaf*
structure (many small all-reduces instead of one fused one, each eligible to
overlap) is verified from the HLO itself.

    python scripts/profile_overlap.py --devices 8
    python scripts/profile_overlap.py --devices 4 --real --trace traces/overlap
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def analyze_schedule(hlo_text: str) -> dict:
    """Parse an optimized HLO module: all-reduce ops, async pairs, and the
    number of compute ops scheduled inside each start→done window."""
    lines = hlo_text.splitlines()
    # Entry computation only (schedules are per-computation; collectives in
    # the main while-body appear inside their own computation too, so scan
    # every computation and aggregate).
    ar_start = re.compile(r"\ball-reduce-start\b")
    ar_done = re.compile(r"\ball-reduce-done\b")
    # Sync all-reduce lines look like `%all-reduce.1 = (f32[], f32[4]{0}, …)
    # all-reduce(…)` — the result type may be an arbitrary tuple, so match
    # the op name itself, not the type syntax.
    ar_sync = re.compile(r"= .*\ball-reduce\(")
    compute = re.compile(r"\b(fusion|convolution|dot|while|custom-call)\b")

    n_start = sum(1 for ln in lines if ar_start.search(ln))
    n_done = sum(1 for ln in lines if ar_done.search(ln))
    n_sync = sum(
        1 for ln in lines
        if ar_sync.search(ln) and "all-reduce-start" not in ln
    )

    # Payload accounting: total f32 elements flowing through every
    # all-reduce (tuple shapes like `f32[4]{0}` count 4). This is what
    # decides whether overlap can matter at all.
    payload = 0
    shape_re = re.compile(r"f32\[([0-9,]*)\]")
    for ln in lines:
        if (ar_sync.search(ln) or ar_start.search(ln)) and "get-tuple" not in ln:
            # Split at the op application (`all-reduce(` / `all-reduce-start(`)
            # — the result name itself is `%all-reduce.N`, so a bare split on
            # the op name would cut before the type tuple.
            lhs = re.split(r"all-reduce(?:-start)?\(", ln, maxsplit=1)[0]
            for dims in shape_re.findall(lhs):
                n = 1
                for d in filter(None, dims.split(",")):
                    n *= int(d)
                payload += n

    # Overlap windows: for each start line, count compute lines until the
    # matching done (textual schedule order == execution order in scheduled
    # HLO dumps).
    windows = []
    open_since = None
    n_compute_in_window = 0
    for ln in lines:
        if ar_start.search(ln):
            open_since = ln.strip()[:80]
            n_compute_in_window = 0
        elif open_since is not None and ar_done.search(ln):
            windows.append(n_compute_in_window)
            open_since = None
        elif open_since is not None and compute.search(ln):
            n_compute_in_window += 1
    return {
        "all_reduce_async_pairs": min(n_start, n_done),
        "all_reduce_sync": n_sync,
        "all_reduce_payload_f32": payload,
        "overlap_windows_compute_ops": windows,
        "any_overlap_scheduled": any(w > 0 for w in windows),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--octaves", type=int, default=6)
    ap.add_argument("--trace", default="", help="profiler trace output dir")
    ap.add_argument("--dump-hlo", default="", help="write scheduled HLO here")
    ap.add_argument(
        "--real", action="store_true",
        help="use the attached GPUs (needs >= --devices cards); default is "
        "N virtual CPU devices so the analysis never silently degrades to "
        "a 1-device mesh with zero collectives",
    )
    args = ap.parse_args()

    if not args.real:
        # Must happen BEFORE jax initializes a backend.
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.devices}"
        ).strip()

    import jax

    if not args.real:
        jax.config.update("jax_platforms", "cpu")
    if len(jax.devices()) < args.devices:
        raise SystemExit(
            f"need {args.devices} devices, have {len(jax.devices())} "
            f"({jax.default_backend()}); a 1-device mesh has no collectives "
            "to analyze — drop --real or lower --devices"
        )

    import jax.numpy as jnp

    from gpgpuraytrace.models.scene import RenderConfig, default_scene
    from gpgpuraytrace.ops.fit import partition_scene
    from gpgpuraytrace.parallel.mesh import make_mesh
    from gpgpuraytrace.parallel.sharded import (
        _sharded_loss_and_grad_body, shard_target,
    )

    backend = jax.default_backend()
    n = args.devices
    h = max(args.size // n * n, n * 8)
    # use_pallas resolves from the platform: the kernel on GPUs, XLA on CPU.
    cfg = RenderConfig(
        height=h, width=args.size, max_steps=64, num_octaves=args.octaves,
    )
    scene = default_scene(num_octaves=args.octaves)
    leaves, merge = partition_scene(scene, trainable=lambda name: True)
    mesh = make_mesh(jax.devices()[:n])
    body = _sharded_loss_and_grad_body(merge, cfg, mesh)
    target = shard_target(jnp.zeros((h, args.size, 3), jnp.float32), mesh)

    fn = jax.jit(body)
    lowered = fn.lower(leaves, target)
    compiled = lowered.compile()
    hlo = compiled.as_text()
    if args.dump_hlo:
        with open(args.dump_hlo, "w") as f:
            f.write(hlo)

    sched = analyze_schedule(hlo)
    n_leaves = len(leaves)

    # Marginal wall cost of the collective: time the step as compiled vs an
    # identical body with the psums deleted (grads left as device-local
    # partials — unsound for fitting, exact for timing the collective).
    import functools as ft
    import time

    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from gpgpuraytrace.ops.render import render as render_fn
    from gpgpuraytrace.parallel.mesh import TILE_AXIS

    local_h = cfg.height // mesh.shape[TILE_AXIS]
    inv_npix = 1.0 / (cfg.height * cfg.width * 3)

    @ft.partial(
        shard_map, mesh=mesh,
        in_specs=(P(), P(TILE_AXIS, None, None)),
        out_specs=(P(), P()), check_vma=False,
    )
    def body_nopsum(train_leaves, target_local):
        row0 = jax.lax.axis_index(TILE_AXIS).astype(jnp.float32) * local_h

        def local_loss(lv):
            img = render_fn(merge(lv), cfg, row0=row0, local_height=local_h)
            d = img - target_local
            return jnp.sum(d * d) * inv_npix

        return jax.value_and_grad(local_loss)(train_leaves)

    fn_nopsum = jax.jit(body_nopsum)

    def timed(f, reps=8):
        jax.block_until_ready(f(leaves, target))
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(reps):
                out = f(leaves, target)
            jax.block_until_ready(out)
            best = min(best, (time.perf_counter() - t0) / reps)
        return best

    t_psum = timed(fn)
    t_nop = timed(fn_nopsum)

    if args.trace:
        loss, grads = fn(leaves, target)  # warm outside the trace
        jax.block_until_ready(loss)
        with jax.profiler.trace(args.trace):
            for _ in range(4):
                loss, grads = fn(leaves, target)
            jax.block_until_ready((loss, grads))

    out = {
        "backend": backend,
        "mesh_devices": int(mesh.shape[next(iter(mesh.shape))]),
        "mesh_devices_requested": n,
        "frame": f"{args.size}x{h}",
        "trainable_leaves": n_leaves,
        **sched,
        "step_ms_with_psum": round(t_psum * 1e3, 3),
        "step_ms_without_psum": round(t_nop * 1e3, 3),
        "collective_marginal_ms": round((t_psum - t_nop) * 1e3, 3),
        "collective_share_pct": round(
            100.0 * max(t_psum - t_nop, 0.0) / t_psum, 2
        ),
        "note": (
            "per-leaf psum => one all-reduce per leaf, each independently "
            "schedulable; async start/done pairs with compute inside the "
            "window = overlap committed by the scheduler"
        ),
    }
    if args.trace:
        out["trace_dir"] = args.trace
    print(json.dumps(out))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""End-to-end check that the main path runs, and is right, on the GPU.

    python chip_smoke.py          # one card: render, fwd+bwd, fit, fly
    python chip_smoke.py --four   # four cards: the 4K sharded fwd+bwd step

One process drives everything. Phases, each a hard check (any failure
exits non-zero):

1. device  — jax.devices()[0] must be a GPU (no CPU fallback); prints the
   card's name and power limit, which prefix every later line;
2. render  — the default path (fused kernel) at 512²×6 octaves, heightfield
   and volumetric, against the plain-XLA reference ``render_jax``: image,
   (t, hit) checkpoint, and the image's own sanity (finite, blue sky on
   top, mean in 0.3–0.7);
3. grad    — fwd+bwd over every float scene leaf against the XLA
   checkpoint backward and against autodiff through ``render_jax``;
4. fit     — ~20 Adam steps at 512² through ``ops.fit.fit``; the loss falls;
5. fly     — 1080p batch-4 frames through the CLI's ``fly`` command,
   written as PNGs and validated;
6. (--four only, and nothing else) the 3840×2160 sharded fit step on a
   four-card 'tiles' mesh against the same step on one card.

``--parity`` runs phases 1–3 only (bench.py's same-run correctness gate).

The last stdout line is one JSON object: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import zlib

_REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gpgpuraytrace.utils.cache import enable_compile_cache  # noqa: E402
from gpgpuraytrace.utils.timing import interleaved_ms  # noqa: E402

# Kernel vs XLA reference on the card: the CPU contract
# (tests/test_pallas.py), 99.9% of pixels within 2e-3 and 99% within 1e-5.
# On the GPU the two sides are compiled by different compilers (Triton vs
# XLA), which contract multiply-adds into FMAs and order ops differently,
# and the march is chaotic at silhouettes, where a last-bit change can move
# a whole pixel; the path has no matrix product, so TF32 plays no part.
# The H100 still meets the CPU bounds with a wide margin (all pixels within
# 1e-4, >99.99% within 1e-5 at 512²×6), so they are not widened.
IMAGE_ATOL, IMAGE_FRAC = 2e-3, 0.999
BULK_ATOL, BULK_FRAC = 1e-5, 0.99
HIT_AGREE = 0.995
T_ATOL, T_FRAC = 5e-2, 0.999
# Gradients: the cross-implementation bound of __graft_entry__.py (the two
# marchers resolve marginal pixels differently, and each builds its own
# prime map); the same-forward bound where both sides share the kernel's
# checkpoint and differ only in the backward's implementation.
CROSS_RTOL, CROSS_ATOL_REL, CROSS_ATOL_MIN = 2.5e-2, 1e-3, 1e-5
SAME_RTOL, SAME_ATOL = 2e-3, 1e-6
# Four cards vs one: the same implementation on the same bands.
SHARD_RTOL, SHARD_ATOL = 2e-3, 1e-6


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def timed_ms(fns, *args, reps: int = 10) -> list[float]:
    """Median ms per fn, timed in interleaved rounds (utils/timing.py)."""
    return [ms for ms, _ in interleaved_ms(fns, args, reps)]


def frac_within(a, b, atol) -> float:
    return float((np.abs(np.asarray(a) - np.asarray(b)) <= atol).mean())


def compare_grads(got, ref, rtol, atol_rel, atol_min, what) -> float:
    """assert_allclose per leaf with a scale-aware atol; returns the worst
    |got - ref| / (atol + rtol |ref|) ratio (≤ 1 passes)."""
    worst = 0.0
    for k, (g, r) in enumerate(zip(got, ref)):
        g, r = np.asarray(g), np.asarray(r)
        atol = max(atol_min, atol_rel * float(np.max(np.abs(r)))) if r.size else atol_min
        ratio = float(np.max(np.abs(g - r) / (atol + rtol * np.abs(r))))
        worst = max(worst, ratio)
        check(ratio <= 1.0, f"{what}: leaf {k} off by {ratio:.2f}× its bound")
    return worst


def phase_render(say, volumetric: bool) -> None:
    from gpgpuraytrace.models.scene import RenderConfig, default_scene
    from gpgpuraytrace.ops.camera import generate_rays
    from gpgpuraytrace.ops.march import march_primed
    from gpgpuraytrace.ops.render import prime_map_jax, render, render_jax
    from gpgpuraytrace.ops.shade import tonemap
    from gpgpuraytrace.kernels.trace import _render_pallas_raw

    cfg = RenderConfig(volumetric=volumetric)  # 512², 6 octaves, 128 steps
    check(cfg.use_pallas and not cfg.interpret,
          "RenderConfig() did not choose the compiled kernel on the GPU")
    scene = default_scene(cfg.num_octaves, volumetric=volumetric)
    xcfg = dataclasses.replace(cfg, use_pallas=False)
    name = ("volumetric" if volumetric else "heightfield") + (
        f" {cfg.height}x{cfg.width}x{cfg.num_octaves}")

    render_k = jax.jit(lambda s: render(s, cfg))
    render_x = jax.jit(lambda s: render_jax(s, xcfg))
    img = jax.block_until_ready(render_k(scene))
    ref = render_x(scene)
    f_img = frac_within(img, ref, IMAGE_ATOL)
    f_bulk = frac_within(img, ref, BULK_ATOL)
    err = np.abs(np.asarray(img) - np.asarray(ref))
    say(f"render {name}: {100 * f_img:.4f}% px within {IMAGE_ATOL} "
        f"(need {100 * IMAGE_FRAC}%), {100 * f_bulk:.4f}% within {BULK_ATOL} "
        f"(need {100 * BULK_FRAC}%), 1e-4: {100 * frac_within(img, ref, 1e-4):.4f}%, "
        f"max err {err.max():.3e}, mean err {err.mean():.3e}")
    check(f_img >= IMAGE_FRAC and f_bulk >= BULK_FRAC,
          f"render {name}: kernel image differs from render_jax")

    _, t_k, hit_k = jax.jit(lambda s: _render_pallas_raw(s, cfg))(scene)

    def ref_ckpt(s):
        o, d = generate_rays(s.camera, cfg.height, cfg.width)
        return march_primed(xcfg, o, d, s.noise, prime_map_jax(s, xcfg))

    t_x, hit_x = jax.jit(ref_ckpt)(scene)
    hit_k, hit_x = np.asarray(hit_k), np.asarray(hit_x)
    agree = float((hit_k == hit_x).mean())
    both = hit_k & hit_x
    f_t = frac_within(np.asarray(t_k)[both], np.asarray(t_x)[both], T_ATOL)
    say(f"render {name} checkpoint: hit agree {100 * agree:.4f}% "
        f"(need {100 * HIT_AGREE}%), t within {T_ATOL} on {100 * f_t:.4f}% of "
        f"common hits (need {100 * T_FRAC}%)")
    check(agree >= HIT_AGREE and f_t >= T_FRAC,
          f"render {name}: (t, hit) checkpoint differs from the XLA march")

    tm = np.asarray(tonemap(img))
    top = tm[:8].reshape(-1, 3).mean(axis=0)
    check(bool(np.isfinite(np.asarray(img)).all()), f"{name}: non-finite pixels")
    check(top[2] > top[0] and top[2] > top[1], f"{name}: top rows not blue sky {top}")
    check(0.3 <= float(tm.mean()) <= 0.7, f"{name}: tonemapped mean {tm.mean():.3f}")
    say(f"render {name} image: finite, top-rows rgb {np.round(top, 3).tolist()}, "
        f"tonemapped mean {tm.mean():.4f}")

    ms_k, ms_x = timed_ms([render_k, render_x], scene)
    say(f"render {name} fwd: kernel {ms_k:.3f} ms, xla {ms_x:.3f} ms "
        f"(median of 10 interleaved rounds, host clock)")


def phase_grad(say) -> None:
    from gpgpuraytrace.models.scene import RenderConfig, default_scene
    from gpgpuraytrace.ops.fit import partition_scene
    from gpgpuraytrace.ops.render import render

    cfg = RenderConfig()
    scene = default_scene(cfg.num_octaves)
    leaves, merge = partition_scene(scene, trainable=lambda name: True)

    def step(c):
        def loss(lv):
            img = render(merge(lv), c)
            return jnp.mean(img * jnp.cos(img))  # non-symmetric cotangent
        return jax.jit(jax.value_and_grad(loss))

    other_bwd = dataclasses.replace(cfg, pallas_bwd=not cfg.pallas_bwd)
    xcfg = dataclasses.replace(cfg, use_pallas=False)
    step_k, step_o, step_x = step(cfg), step(other_bwd), step(xcfg)
    l_k, g_k = step_k(leaves)
    _, g_o = step_o(leaves)
    l_x, g_x = step_x(leaves)
    for g in (g_k, g_o, g_x):
        check(all(bool(jnp.all(jnp.isfinite(x))) for x in g), "non-finite grads")
    w_same = compare_grads(g_k, g_o, SAME_RTOL, 0.0, SAME_ATOL,
                           "kernel bwd vs XLA checkpoint bwd")
    say(f"grad kernel-bwd vs xla-ckpt-bwd ({len(g_k)} leaves, same "
        f"forward): worst {w_same:.3f} of bound rtol {SAME_RTOL} atol "
        f"{SAME_ATOL}")
    w_x = compare_grads(g_k, g_x, CROSS_RTOL, CROSS_ATOL_REL, CROSS_ATOL_MIN,
                        "kernel path vs render_jax autodiff")
    say(f"grad default path vs render_jax autodiff ({len(g_k)} leaves): worst "
        f"{w_x:.3f} of bound rtol {CROSS_RTOL} atol max({CROSS_ATOL_MIN}, "
        f"{CROSS_ATOL_REL}*leaf max); loss {float(l_k):.6f} vs {float(l_x):.6f}")
    check(abs(float(l_k) - float(l_x)) <= 1e-4 * abs(float(l_x)),
          "fwd+bwd loss differs from the XLA path")
    bwd = "kernel bwd" if cfg.pallas_bwd else "xla ckpt bwd"
    other = "xla ckpt bwd" if cfg.pallas_bwd else "kernel bwd"
    ms_k, ms_o, ms_x = timed_ms([step_k, step_o, step_x], leaves)
    say(f"fwd+bwd {cfg.height}x{cfg.width}x{cfg.num_octaves} all leaves: "
        f"default (kernel fwd + {bwd}) {ms_k:.3f} ms, kernel fwd + {other} "
        f"{ms_o:.3f} ms, xla {ms_x:.3f} ms (median of 10 interleaved "
        f"rounds, host clock)")


def phase_fit(say) -> None:
    from gpgpuraytrace.models.scene import RenderConfig, default_scene
    from gpgpuraytrace.ops.fit import fit, perturb_scene
    from gpgpuraytrace.ops.render import render_jit

    cfg = RenderConfig()
    target_scene = default_scene(cfg.num_octaves)
    target = jax.block_until_ready(render_jit(target_scene, cfg))
    scene0 = perturb_scene(target_scene, jax.random.PRNGKey(0), rel=0.15)
    t0 = time.perf_counter()
    _, losses = fit(scene0, cfg, target, steps=20, learning_rate=5e-3,
                    log_every=0)
    dt = time.perf_counter() - t0
    check(all(np.isfinite(losses)), "fit: non-finite loss")
    check(losses[-1] < losses[0], f"fit: loss did not fall {losses[0]} -> {losses[-1]}")
    say(f"fit {cfg.height}x{cfg.width}x{cfg.num_octaves} adam lr 5e-3: loss {losses[0]:.4e} -> {losses[-1]:.4e} "
        f"over {len(losses)} steps ({dt:.1f} s incl. compile)")


def _png_size(path: str) -> tuple[int, int]:
    with open(path, "rb") as f:
        data = f.read()
    check(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path}: not a PNG")
    check(data[12:16] == b"IHDR", f"{path}: no IHDR")
    w, h = struct.unpack(">II", data[16:24])
    # Inflate the image data to prove the stream is whole.
    pos, idat = 8, b""
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    raw = zlib.decompress(idat)
    check(len(raw) == h * (1 + 3 * w), f"{path}: truncated image data")
    return w, h


def phase_fly(say) -> None:
    from gpgpuraytrace import cli

    out = tempfile.mkdtemp(prefix=".smoke_fly_", dir=_REPO)
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["fly", "--size", "1920x1080", "--frames", "8",
                      "--batch", "4", "-o", out])
        log = buf.getvalue().strip()
        frames = sorted(os.listdir(out))
        check(len(frames) == 8, f"fly: wrote {len(frames)} of 8 frames")
        for name in frames:
            check(_png_size(os.path.join(out, name)) == (1920, 1080),
                  f"fly: {name} is not 1920x1080")
        say(f"fly 1920x1080 batch 4: {len(frames)} valid PNGs; cli: {log}")
    finally:
        shutil.rmtree(out, ignore_errors=True)


def phase_four(say, height: int = 2160, width: int = 3840) -> None:
    import optax

    from gpgpuraytrace.models.scene import RenderConfig, default_scene
    from gpgpuraytrace.ops.fit import partition_scene
    from gpgpuraytrace.ops.march import band_prime_cfg
    from gpgpuraytrace.parallel.mesh import make_mesh
    from gpgpuraytrace.parallel.sharded import make_sharded_fit_step, shard_target

    devs = jax.devices()
    check(len(devs) >= 4, f"--four needs 4 GPUs, found {len(devs)}")
    base = RenderConfig(height=height, width=width)
    # 2160/4 = 540-row bands, which prime_ds=8 does not divide; the sharded
    # path lowers the factor to one that does, and the one-card reference
    # must prime the same way to be the same step.
    band = height // 4
    cfg = band_prime_cfg(base, band)
    check(cfg.prime_ds and band % cfg.prime_ds == 0,
          f"{band}-row bands resolved to prime_ds={cfg.prime_ds}")
    leaves, merge = partition_scene(default_scene(cfg.num_octaves))
    # Adam, chained behind a transformation that keeps the gradients it is
    # given in its state — one compiled step yields loss, grads and update.
    keep = optax.GradientTransformation(
        init=lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        update=lambda g, state, params=None: (g, g),
    )
    tx = optax.chain(keep, optax.adam(5e-3))

    results = {}
    for n in (4, 1):
        mesh = make_mesh(devs[:n])
        target = shard_target(jnp.zeros((height, width, 3), jnp.float32), mesh)
        step = make_sharded_fit_step(cfg, mesh, merge, tx)
        opt_state = tx.init(leaves)
        new_leaves, new_state, loss = step(leaves, opt_state, target)
        (ms,) = timed_ms([step], leaves, opt_state, target, reps=3)
        results[n] = (float(loss), new_state[0], new_leaves, ms)
        say(f"{width}x{height} sharded fit step on {n} card(s): loss "
            f"{float(loss):.8f}, {ms:.2f} ms/step (median of 3, host clock), "
            f"prime_ds {cfg.prime_ds}")
    l4, g4, p4, ms4 = results[4]
    l1, g1, p1, ms1 = results[1]
    check(abs(l4 - l1) <= SHARD_RTOL * abs(l1), f"4-card loss {l4} != 1-card loss {l1}")
    w = compare_grads(g4, g1, SHARD_RTOL, 0.0, SHARD_ATOL, "4-card vs 1-card grads")
    w_p = compare_grads(p4, p1, SHARD_RTOL, 0.0, SHARD_ATOL, "4-card vs 1-card update")
    say(f"{width}x{height} sharded vs one card: loss rel diff "
        f"{abs(l4 - l1) / abs(l1):.2e}, grads worst {w:.3f} / updated leaves "
        f"worst {w_p:.3f} of bound rtol {SHARD_RTOL} atol {SHARD_ATOL}; step "
        f"{ms1:.2f} -> {ms4:.2f} ms ({ms1 / ms4:.2f}x on 4 cards)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--four", action="store_true",
                      help="run only the four-card 4K sharded phase")
    mode.add_argument("--parity", action="store_true",
                      help="run only the render and gradient parity phases")
    args = ap.parse_args()

    enable_compile_cache()
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (platform {devs[0].platform!r})",
              file=sys.stderr)
        return 1
    card = card_line()
    print(f"card: {card}", flush=True)

    def say(msg: str) -> None:
        print(f"[{card}] {msg}", flush=True)

    t_start = time.perf_counter()
    # The XLA reference runs at the highest matmul precision. The path has
    # no matrix product, so this only pins the reference's semantics; every
    # phase runs under it so that each program compiles once.
    precision = jax.default_matmul_precision("highest")
    try:
        with precision:
            if args.four:
                phase_four(say)
            else:
                phase_render(say, volumetric=False)
                phase_render(say, volumetric=True)
                phase_grad(say)
                if not args.parity:
                    phase_fit(say)
                    phase_fly(say)
    except SmokeFailure as e:
        say(f"FAILED: {e}")
        return 1
    say(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

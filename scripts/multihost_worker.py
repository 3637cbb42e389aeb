"""One process of a multi-process SPMD render/fit job (BASELINE.json:11).

Run directly on each host of a multi-host job, or locally via
``parallel.launch.launch_local_processes`` (CPU simulation). Asserts that
the sharded render matches the replicated scene on every process and runs
one sharded fit step with the cross-process grad psum.

Timed mode: set ``WORKER_TIME_K`` > 0 and each process also measures the
sharded fwd+bwd step at a work-dominated config (``WORKER_TIME_H/W/OCTAVES``,
default 512x512x3 — the same shape as bench.py --mesh) with the salted fori
differencing, and prints a ``TIMED {json}`` line. On CPU processes the
number is a localhost-collective step cost, not a device rate.

The worker runs on the CPU unless ``JAX_PLATFORMS`` names another platform
(e.g. ``cuda``); RenderConfig then picks the path for that platform.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import optax

from gpgpuraytrace.models.scene import RenderConfig, default_scene
from gpgpuraytrace.ops.fit import partition_scene
from gpgpuraytrace.parallel.launch import distributed_context
from gpgpuraytrace.parallel.mesh import make_mesh
from gpgpuraytrace.parallel.sharded import (
    make_sharded_fit_step,
    shard_target,
    sharded_render,
)


def main():
    with distributed_context(
        coordinator_address=os.environ.get("JAX_COORDINATOR_ADDRESS"),
        num_processes=int(os.environ.get("JAX_NUM_PROCESSES", "1")),
        process_id=int(os.environ.get("JAX_PROCESS_ID", "0")),
    ):
        n_dev = len(jax.devices())
        mesh = make_mesh()
        cfg = RenderConfig(
            height=8 * n_dev, width=128, max_steps=8, num_octaves=2, use_pallas=False
        )
        scene = default_scene(2)
        img = jax.block_until_ready(sharded_render(scene, cfg, mesh))

        target = shard_target(jnp.zeros((cfg.height, cfg.width, 3), jnp.float32), mesh)
        leaves, merge = partition_scene(scene)
        tx = optax.adam(1e-2)
        step = make_sharded_fit_step(cfg, mesh, merge, tx)
        leaves, _, loss = step(leaves, tx.init(leaves), target)
        jax.block_until_ready(loss)
        # Full-precision loss (hex) so the launcher/test can assert the
        # psum'd loss is IDENTICAL on every process, not just close.
        print(
            f"proc {jax.process_index()}/{jax.process_count()}: "
            f"{n_dev} devices, render {img.shape}, loss {float(loss):.6f} "
            f"losshex={float(loss).hex()}, OK"
        )

        time_k = int(os.environ.get("WORKER_TIME_K", "0"))
        if time_k > 0:
            _timed_step(mesh, time_k)


def _timed_step(mesh, K: int) -> None:
    """Salted-differencing timing of the sharded fwd+bwd step (same
    methodology as bench.py's children: one jitted fori_loop with a traced
    trip count, scalar VALUE fetch, (T(K)-T(1))/(K-1)). Every process runs
    the identical program in lockstep — the printed per-step time therefore
    includes the cross-process psum each step."""
    import json
    import time

    from gpgpuraytrace.parallel.sharded import (
        _sharded_loss_and_grad_body,
        shard_target,
    )

    h = int(os.environ.get("WORKER_TIME_H", "512"))
    w = int(os.environ.get("WORKER_TIME_W", "512"))
    octaves = int(os.environ.get("WORKER_TIME_OCTAVES", "3"))
    cfg = RenderConfig(
        height=h, width=w, max_steps=128, num_octaves=octaves,
    )
    scene = default_scene(num_octaves=octaves)
    leaves, merge = partition_scene(scene, trainable=lambda name: True)
    body = _sharded_loss_and_grad_body(merge, cfg, mesh)
    target = shard_target(jnp.zeros((h, w, 3), jnp.float32), mesh)

    # target is passed as an argument, not closed over: a jit closure may
    # not capture an array spanning non-addressable (other-process) devices.
    @jax.jit
    def run(leaves, target, nsteps, salt):
        def step(i, acc):
            eps = 1e-6 * (salt + i.astype(jnp.float32))
            loss, grads = body([leaf + eps for leaf in leaves], target)
            return acc + loss + sum(
                jnp.sum(g) for g in jax.tree_util.tree_leaves(grads)
            )
        return jax.lax.fori_loop(0, nsteps, step, jnp.float32(0.0))

    t0 = time.perf_counter()
    float(run(leaves, target, 1, jnp.float32(900.0)))
    compile_s = time.perf_counter() - t0
    float(run(leaves, target, K, jnp.float32(800.0)))  # warm

    def timed(nsteps, salt):
        t0 = time.perf_counter()
        float(run(leaves, target, nsteps, jnp.float32(salt)))
        return time.perf_counter() - t0

    # Salt base: must be IDENTICAL across the SPMD processes of one job
    # (divergent args under collectives would be garbage). The launcher
    # computes it once and passes it via WORKER_SALT_BASE; direct
    # invocation falls back to a job-wide derivation from the coordinator
    # address + a coarse time bucket (NOT pid — that differs per process).
    env_base = os.environ.get("WORKER_SALT_BASE")
    if env_base is not None:
        base = float(env_base)
    else:
        from gpgpuraytrace.utils.timing import job_salt_base

        base = job_salt_base(
            os.environ.get("JAX_COORDINATOR_ADDRESS", "local")
        )
    t_k = min(timed(K, base + 100.0 * r) for r in range(1, 3))
    t_1 = min(timed(1, base + 100.0 * r + 50.0) for r in range(1, 3))
    sec = max(t_k - t_1, 1e-9) / (K - 1)
    print("TIMED " + json.dumps({
        "process": jax.process_index(),
        "num_processes": jax.process_count(),
        "devices": len(jax.devices()),
        "config": f"{w}x{h}x{octaves}oct",
        "ms_per_step": round(sec * 1e3, 1),
        "rays_per_sec": round(h * w / sec),
        "compile_s": round(compile_s, 1),
        "backend": jax.default_backend(),
    }))


if __name__ == "__main__":
    main()

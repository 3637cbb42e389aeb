"""Multi-process / multi-host launch helpers (BASELINE.json:11).

On a multi-host job each host runs the SAME program; JAX joins the
processes via ``jax.distributed.initialize`` (coordinator address, process
count and process index — passed explicitly or from the environment). This
module provides:

* ``distributed_context()`` — bring-up/teardown for one process of an SPMD
  job (works single-process too, so code is identical on one host or many);
* ``launch_local_processes()`` — a single-machine N-process simulation of a
  multi-host job over the CPU backend, used to exercise the
  jax.distributed code path on one machine (``dryrun_multichip`` covers the
  single-process multi-device path; this covers multi-process).
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import sys

import jax


@contextlib.contextmanager
def distributed_context(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
):
    """Initialize jax.distributed for this process if configured; no-op for
    single-process runs. Use around the whole program:

        with distributed_context():
            mesh = make_mesh()
            ...
    """
    configured = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    initialized = False
    if configured and num_processes != 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
        initialized = True
    try:
        yield
    finally:
        if initialized:
            jax.distributed.shutdown()


def launch_local_processes(
    worker_script: str,
    num_processes: int = 2,
    devices_per_process: int = 4,
    port: int = 9776,
    timeout_s: int = 600,
    extra_env: dict | None = None,
) -> list[str]:
    """Spawn N local CPU processes running ``worker_script`` as one SPMD job.

    Each worker gets JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
    JAX_PROCESS_ID plus ``devices_per_process`` virtual CPU devices — the
    wiring each host of a multi-host job is given. Returns each
    process's stdout; raises on any nonzero exit.
    """
    procs = []
    for pid in range(num_processes):
        env = dict(os.environ)
        env.update(extra_env or {})
        env["JAX_COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
        env["JAX_NUM_PROCESSES"] = str(num_processes)
        env["JAX_PROCESS_ID"] = str(pid)
        env["XLA_FLAGS"] = (
            env.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={devices_per_process}"
        ).strip()
        procs.append(
            subprocess.Popen(
                [sys.executable, worker_script],
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
        )
    outputs = []
    failed = []
    for pid, proc in enumerate(procs):
        try:
            out, _ = proc.communicate(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
            failed.append((pid, "timeout", out))
            continue
        outputs.append(out)
        if proc.returncode != 0:
            failed.append((pid, proc.returncode, out))
    if failed:
        msgs = "\n".join(f"[p{pid} rc={rc}]\n{out[-2000:]}" for pid, rc, out in failed)
        raise RuntimeError(f"{len(failed)} worker(s) failed:\n{msgs}")
    return outputs

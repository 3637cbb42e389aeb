"""Timed 2-process × 4-device SPMD fwd+bwd step on the CPU.

Launches the multihost worker in timed mode over localhost (the wiring
jax.distributed uses across hosts, with gRPC over loopback standing in for
the network) and prints ONE JSON line with each process's measured sharded
fwd+bwd step cost.

What the number means: 2 processes × 4 virtual CPU devices time-slice the
host's cores, so the step cost is core-capped capacity + the full
multi-process SPMD machinery (per-step cross-process psum included) — an
upper bound on the machinery's cost, not a device or interconnect rate.

Usage: python scripts/multiproc_bench.py [--k 4] [--size 512] [--octaves 3]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gpgpuraytrace.parallel.launch import launch_local_processes
from gpgpuraytrace.utils.timing import process_salt_base

_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "multihost_worker.py")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--octaves", type=int, default=3)
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--devices-per-process", type=int, default=4)
    ap.add_argument("--timeout", type=int, default=1800)
    args = ap.parse_args()

    outputs = launch_local_processes(
        _WORKER,
        num_processes=args.processes,
        devices_per_process=args.devices_per_process,
        port=9791,
        timeout_s=args.timeout,
        extra_env={
            "XLA_FLAGS": "",
            "JAX_PLATFORMS": "cpu",
            # One small fractional salt base per job, shared by all its
            # SPMD processes (see multihost_worker._timed_step).
            "WORKER_SALT_BASE": str(process_salt_base()),
            "WORKER_TIME_K": str(args.k),
            "WORKER_TIME_H": str(args.size),
            "WORKER_TIME_W": str(args.size),
            "WORKER_TIME_OCTAVES": str(args.octaves),
        },
    )
    timed = []
    for out in outputs:
        m = re.search(r"TIMED (\{.*\})", out)
        if m:
            timed.append(json.loads(m.group(1)))
    if not timed:
        print(json.dumps({"error": "no TIMED lines",
                          "tails": [o[-400:] for o in outputs]}))
        sys.exit(1)
    cores = os.cpu_count() or 1
    print(json.dumps({
        "metric": f"multiprocess_spmd_fwd_bwd_"
                  f"{args.processes}proc_x{args.devices_per_process}dev",
        "per_process": timed,
        "ms_per_step": max(t["ms_per_step"] for t in timed),
        "physical_cores": cores,
        "note": "CPU processes on localhost gRPC; core-capped capacity "
                "— machinery upper bound, not a device measurement",
    }))


if __name__ == "__main__":
    main()

"""Timing helpers: interleaved A/B timing, and salts for the
salted-differencing timers (bench.py, scripts).

The benchmark times (T(K) − T(1)) / (K − 1) over runtime trip counts with
salted inputs; these helpers give each process (or each multi-process job)
its own small salt base. They stay until the benchmark moves to
warm-up + ``block_until_ready`` timing. The base must stay SMALL: it feeds
~1e-6-scaled scene perturbations, and an O(1) perturbation would change the
march work itself.
"""

from __future__ import annotations

import os
import statistics
import time


def interleaved_ms(fns, args: tuple, reps: int) -> list[tuple[float, float]]:
    """[(median ms, first-call seconds incl. compile)] per fn.

    Each fn is called twice to warm up, then once per round for ``reps``
    rounds, every call ending in ``block_until_ready``; interleaving the
    rounds makes slow drift of the device hit every fn alike.
    """
    import jax

    first = []
    for fn in fns:
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        first.append(time.perf_counter() - t0)
        jax.block_until_ready(fn(*args))
    ts = [[] for _ in fns]
    for _ in range(reps):
        for k, fn in enumerate(fns):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*args))
            ts[k].append(time.perf_counter() - t0)
    return [(statistics.median(t) * 1e3, f) for t, f in zip(ts, first)]


def process_salt_base() -> float:
    """Process-unique fraction on a ~1e-3 grid, in [0, 1).

    997 distinct streams; exactly representable in f32 next to the
    100–900 salt schedules the harnesses use (f32 resolution at 800 is
    ~6e-5). Derived from pid+time so two processes — or the same script
    run twice — never share a schedule.
    """
    return ((os.getpid() * 7919 + int(time.time() * 1e3)) % 997) / 997.0


def job_salt_base(job_key: str, bucket_s: int = 300) -> float:
    """Salt base shared by every process of ONE multi-process SPMD job but
    unique across jobs: derived from a job-wide key (e.g. the coordinator
    address) plus a coarse time bucket, NOT the pid (which differs per
    process — divergent salts under collectives would compute garbage).

    Caveat: processes launching astride a ``bucket_s`` boundary would
    disagree; launchers that can pass an explicit shared value (e.g.
    multiproc_bench via WORKER_SALT_BASE) should do so — this is the
    fallback for direct pod invocation.
    """
    h = 0
    for ch in job_key:
        h = (h * 131 + ord(ch)) % 1000003
    return ((h + int(time.time() / bucket_s)) % 997) / 997.0

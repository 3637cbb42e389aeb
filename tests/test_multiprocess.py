"""Multi-process SPMD path (SURVEY.md §5 distributed row; BASELINE.json:11):
launch_local_processes really runs a 2-process × 4-device job over
jax.distributed (the DCN-analogue wiring), and the psum'd loss is IDENTICAL
on every process.

This is the single test that executes parallel/launch.py +
scripts/multihost_worker.py end-to-end — the same code path a pod slice
runs, with localhost standing in for the coordinator/DCN fabric.
"""

import os
import re

import pytest

from gpgpuraytrace.parallel.launch import launch_local_processes

_WORKER = os.path.join(
    os.path.dirname(__file__), "..", "scripts", "multihost_worker.py"
)


@pytest.mark.slow
def test_two_process_spmd_identical_psum_loss():
    outputs = launch_local_processes(
        _WORKER,
        num_processes=2,
        devices_per_process=4,
        port=9781,
        timeout_s=420,
        # Workers must not inherit the 8-virtual-device XLA_FLAGS this test
        # session sets (they set their own count), nor the test JAX_PLATFORMS.
        extra_env={"XLA_FLAGS": "", "JAX_PLATFORMS": "cpu"},
    )
    assert len(outputs) == 2
    hexes = []
    for out in outputs:
        assert "OK" in out, out[-2000:]
        m = re.search(r"losshex=(\S+),", out)
        assert m, f"no losshex in worker output: {out[-2000:]}"
        hexes.append(m.group(1))
        assert "8 devices" in out  # 2 proc x 4 local = 8 global devices
    assert hexes[0] == hexes[1], f"psum'd loss differs across processes: {hexes}"

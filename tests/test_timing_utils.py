"""Unit tests for the measurement-discipline and AOT-cache helpers
(utils/timing.py, utils/aot.py) added in round 4."""

import numpy as np

from gpgpuraytrace.utils.timing import job_salt_base, process_salt_base


def test_process_salt_base_is_small_grid_fraction():
    b = process_salt_base()
    assert 0.0 <= b < 1.0
    # On the 1/997 grid (the f32-representability contract next to the
    # 100-900 salt schedules).
    assert abs(b * 997 - round(b * 997)) < 1e-9
    # Stable within a process (pid+ms quantized — two immediate calls may
    # differ by the ms, so just re-check the range contract).
    assert 0.0 <= process_salt_base() < 1.0


def test_job_salt_base_shared_and_distinct():
    # Same job key + same time bucket → identical on every process.
    assert job_salt_base("10.0.0.1:9781") == job_salt_base("10.0.0.1:9781")
    # Different jobs (coordinator) → different schedule (overwhelmingly).
    vals = {job_salt_base(f"10.0.0.{i}:97{i:02d}") for i in range(20)}
    assert len(vals) > 15
    for v in vals:
        assert 0.0 <= v < 1.0


def test_aot_cache_key_sensitivity():
    from gpgpuraytrace.utils.aot import _cache_key

    args = ([np.zeros((4,), np.float32)],)
    k1 = _cache_key("cfg-A", args)
    assert k1 == _cache_key("cfg-A", args)  # deterministic
    assert k1 != _cache_key("cfg-B", args)  # static config in the key
    # Arg structure/shape in the key.
    assert k1 != _cache_key("cfg-A", ([np.zeros((8,), np.float32)],))
    assert k1 != _cache_key("cfg-A", ([np.zeros((4,), np.int32)],))

"""The compile-cache location, and the chip tools' refusal to report
anything without a GPU."""

import json
import os
import subprocess
import sys

import jax

import bench
from gpgpuraytrace.utils import cache

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compile_cache_honours_environment(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(cache.ENV_VAR, str(tmp_path))
    assert cache.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; nothing is set in code.
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_fixed_checkout_path(monkeypatch):
    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        assert cache.enable_compile_cache() == os.path.join(_REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == cache.DEFAULT_DIR
        # The AOT cache shares the directory (utils/aot.py writes aot/).
        assert cache.cache_dir() == cache.DEFAULT_DIR
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_chip_smoke_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, os.path.join(_REPO, "chip_smoke.py")],
        capture_output=True, text=True, timeout=120, cwd=_REPO, env=env,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_bench_reports_no_rate_when_children_die(monkeypatch):
    monkeypatch.setattr(bench, "_run_parity", lambda: "fail: no GPU")
    monkeypatch.setattr(
        bench, "_run_child", lambda code, argv, timeout_s: (None, "crash: no GPU")
    )
    result = bench.run_bench()
    assert result["value"] is None and result["vs_baseline"] is None
    assert result["device"] is None and result["detail"] == {}
    assert "crash" in result["status"]["pallas"]
    text = json.dumps(result)
    assert "recorded" not in text and "fallback" not in text

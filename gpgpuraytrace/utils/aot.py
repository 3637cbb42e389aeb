"""AOT executable cache: serialize compiled XLA executables to disk and
restore them in a fresh process, skipping lowering AND compilation.

Why this exists: a cold CLI start pays lowering plus compile (or a
persistent-cache hit) every time; `jax.experimental.serialize_executable`
round-trips the compiled program, and a fresh process deserializes and runs
it bit-identically without lowering. This module wires that path behind an
opt-in flag: `cli render --aot-cache` / `BENCH_AOT=1 bench.py`. The cache
lives under ``aot/`` in the compile-cache directory (utils/cache.py).

Cache key: jax version + backend + device kind + a fingerprint of this
package's own source (ADVICE r4: without it, editing kernels/trace.py and
re-running with a warm cache would silently execute the STALE compiled
kernel — bench numbers and rendered images for code that no longer exists)
+ the static config repr + the dynamic-argument tree
structure/shapes/dtypes. Anything that changes the compiled program must be
in the key; scene VALUES are runtime arguments and deliberately are not.

Failure policy: best-effort for every failure Python can observe (stale
format after a jax upgrade, different device, corrupt file): those fall
back to the normal jit path and repopulate the cache. One caveat the
try/except CANNOT catch: an XLA:CPU executable is compiled for the build
host's exact ISA feature set, and running it on a host with fewer
features is a SIGILL, not an exception — so on the cpu backend the cache
key also hashes /proc/cpuinfo's feature flags (falling back to
platform.machine()), making a foreign-host restore a key miss instead of
a crash.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import platform

import jax


def _cpu_features() -> str:
    """Host ISA fingerprint for the cpu backend's cache key (see module
    docstring — a feature mismatch would SIGILL past any except block)."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    return hashlib.sha1(line.encode()).hexdigest()[:12]
    except OSError:
        pass
    return platform.machine()


_SOURCE_FINGERPRINT: str | None = None


def _source_fingerprint() -> str:
    """Digest of every tracked source file that can shape a compiled program
    (the package's .py files). Computed once per process; a source edit
    makes every AOT entry a key miss instead of a stale-executable hit."""
    global _SOURCE_FINGERPRINT
    if _SOURCE_FINGERPRINT is None:
        pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        h = hashlib.sha1()
        for dirpath, dirnames, filenames in sorted(os.walk(pkg_root)):
            dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
            for name in sorted(filenames):
                if name.endswith(".py"):
                    path = os.path.join(dirpath, name)
                    h.update(os.path.relpath(path, pkg_root).encode())
                    with open(path, "rb") as f:
                        h.update(f.read())
        _SOURCE_FINGERPRINT = h.hexdigest()[:16]
    return _SOURCE_FINGERPRINT


def _cache_key(static_desc: str, args) -> str:
    leaves, treedef = jax.tree_util.tree_flatten(args)
    shapes = [(jax.numpy.asarray(x).shape, str(jax.numpy.asarray(x).dtype))
              for x in leaves]
    dev = jax.devices()[0]
    backend = jax.default_backend()
    raw = "|".join([
        jax.__version__,
        backend,
        getattr(dev, "device_kind", str(dev)),
        _cpu_features() if backend == "cpu" else "",
        _source_fingerprint(),
        static_desc,
        str(treedef),
        str(shapes),
    ])
    return hashlib.sha1(raw.encode()).hexdigest()[:20]


def load_or_compile(jitted, args, static_desc: str, cache_dir: str):
    """Return (compiled_callable, status) for ``jitted`` at ``args``.

    ``jitted`` is a jax.jit-wrapped function; static arguments must be baked
    already (functools.partial / static_argnums closed over) so that
    ``jitted.lower(*args)`` and ``compiled(*args)`` agree on the signature.
    status is "aot-restored" (deserialized from disk, no lower/compile) or
    "compiled+saved" (normal path; the executable was serialized for next
    time) or "compiled (aot failed: …)".
    """
    from jax.experimental import serialize_executable as se

    key = _cache_key(static_desc, args)
    aot_dir = os.path.join(cache_dir, "aot")
    path = os.path.join(aot_dir, f"{key}.bin")
    trees = path + ".trees"
    if os.path.exists(path) and os.path.exists(trees):
        try:
            with open(path, "rb") as f:
                payload = f.read()
            with open(trees, "rb") as f:
                in_tree, out_tree = pickle.load(f)
            return se.deserialize_and_load(payload, in_tree, out_tree), \
                "aot-restored"
        except Exception as e:  # noqa: BLE001 — stale/corrupt → recompile
            note = f"stale aot cache ({type(e).__name__}); recompiling"
        else:  # pragma: no cover
            note = ""
    else:
        note = None
    compiled = jitted.lower(*args).compile()
    try:
        payload, in_tree, out_tree = se.serialize(compiled)
        os.makedirs(aot_dir, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(payload)
        os.replace(tmp, path)
        with open(trees + ".tmp", "wb") as f:
            pickle.dump((in_tree, out_tree), f)
        os.replace(trees + ".tmp", trees)
        status = "compiled+saved"
    except Exception as e:  # noqa: BLE001 — serialization is best-effort
        status = f"compiled (aot save failed: {type(e).__name__})"
    if note:
        status += f" [{note}]"
    return compiled, status

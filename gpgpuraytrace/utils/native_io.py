"""ctypes bindings for the native IO runtime (native/libframe_io.so).

The C++ side provides a fast PNG encoder and an asynchronous frame-writer
queue (worker threads encode+write while the accelerator renders the next
batch — the headless analogue of the reference's Present overlap). Builds
lazily via native/build.sh on first use; every caller falls back to the pure
Python encoder if the toolchain or zlib is unavailable.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_SO_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libframe_io.so"))

_lib = None
_lib_lock = threading.Lock()
_build_attempted = False
_ABI_VERSION = 2  # must match frio_abi_version() in frame_io.cc


def _build() -> bool:
    try:
        subprocess.run(
            ["sh", os.path.join(_NATIVE_DIR, "build.sh")],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return True
    except Exception:
        return False


def _abi_ok(lib) -> bool:
    try:
        lib.frio_abi_version.restype = ctypes.c_int
        return lib.frio_abi_version() == _ABI_VERSION
    except AttributeError:  # pre-versioning .so
        return False


def _load():
    global _lib, _build_attempted
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = None
        if os.path.exists(_SO_PATH):
            lib = ctypes.CDLL(_SO_PATH)
        if (lib is None or not _abi_ok(lib)) and not _build_attempted:
            # Missing, or a stale build of an older ABI: rebuild once
            # (mis-calling changed signatures would corrupt arguments).
            _build_attempted = True
            lib = None
            if _build() and os.path.exists(_SO_PATH):
                lib = ctypes.CDLL(_SO_PATH)
        if lib is None or not _abi_ok(lib):
            return None
        lib.frio_write_png.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.frio_write_png.restype = ctypes.c_int
        lib.frio_writer_create.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.frio_writer_create.restype = ctypes.c_void_p
        lib.frio_writer_push.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.frio_writer_destroy.argtypes = [ctypes.c_void_p]
        lib.frio_writer_destroy.restype = ctypes.c_int
        lib.frio_writer_written.argtypes = [ctypes.c_void_p]
        lib.frio_writer_written.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def write_png_native(path: str, rgb: np.ndarray, level: int = 6) -> bool:
    """Synchronous native frame write (PNG at zlib ``level``; raw bytes for
    a ``.rgb`` path). Returns False if unavailable/failed."""
    lib = _load()
    if lib is None:
        return False
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, c = rgb.shape
    assert c == 3
    ptr = rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    return lib.frio_write_png(path.encode(), ptr, h, w, level) == 0


class AsyncFrameWriter:
    """Background frame writer: push(path, rgb) returns immediately; worker
    threads encode and write. Use as a context manager; exit waits for the
    queue to drain and raises if any frame failed."""

    def __init__(self, num_threads: int = 2, level: int = 6):
        lib = _load()
        if lib is None:
            raise RuntimeError("native IO library unavailable")
        self._lib = lib
        self._handle = lib.frio_writer_create(num_threads, level)

    def push(self, path: str, rgb: np.ndarray) -> None:
        rgb = np.ascontiguousarray(rgb, np.uint8)
        h, w, c = rgb.shape
        assert c == 3
        ptr = rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        self._lib.frio_writer_push(self._handle, path.encode(), ptr, h, w)

    def written(self) -> int:
        return self._lib.frio_writer_written(self._handle)

    def close(self) -> int:
        if self._handle is None:
            return 0
        errs = self._lib.frio_writer_destroy(self._handle)
        self._handle = None
        return errs

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        errs = self.close()
        if errs and not exc[0]:
            raise RuntimeError(f"{errs} frames failed to write")

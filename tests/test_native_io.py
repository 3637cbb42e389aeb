"""Native IO runtime tests: PNG encoder exactness and the async writer.

Skipped when the C++ toolchain/zlib is unavailable (the pure-Python encoder
in utils/image.py is the always-available fallback and is tested via the
PNG roundtrip here too).
"""

import os
import struct
import zlib

import numpy as np
import pytest


def _decode_png(data: bytes) -> np.ndarray:
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    off, idat, shape = 8, b"", None
    while off < len(data):
        (ln,) = struct.unpack(">I", data[off : off + 4])
        tag = data[off + 4 : off + 8]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", data[off + 8 : off + 16])
            shape = (h, w)
        elif tag == b"IDAT":
            idat += data[off + 8 : off + 8 + ln]
        off += 12 + ln
    raw = zlib.decompress(idat)
    rows = np.frombuffer(raw, np.uint8).reshape(shape[0], shape[1] * 3 + 1)
    assert (rows[:, 0] == 0).all(), "only filter 0 supported"
    return rows[:, 1:].reshape(shape[0], shape[1], 3)


@pytest.fixture(scope="module")
def img():
    rng = np.random.default_rng(0)
    return rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)


def test_python_png_roundtrip(img, tmp_path):
    from gpgpuraytrace.utils.image import encode_png

    dec = _decode_png(encode_png(img))
    np.testing.assert_array_equal(dec, img)


def test_native_png_roundtrip(img, tmp_path):
    native_io = pytest.importorskip("gpgpuraytrace.utils.native_io")
    if not native_io.available():
        pytest.skip("native toolchain unavailable")
    path = os.path.join(tmp_path, "native.png")
    assert native_io.write_png_native(path, img)
    dec = _decode_png(open(path, "rb").read())
    np.testing.assert_array_equal(dec, img)


def test_async_writer(img, tmp_path):
    native_io = pytest.importorskip("gpgpuraytrace.utils.native_io")
    if not native_io.available():
        pytest.skip("native toolchain unavailable")
    paths = [os.path.join(tmp_path, f"f_{i:03d}.png") for i in range(12)]
    with native_io.AsyncFrameWriter(num_threads=3) as w:
        for p in paths:
            w.push(p, img)
    for p in paths:
        np.testing.assert_array_equal(_decode_png(open(p, "rb").read()), img)


def test_write_png_prefers_native_and_falls_back(img, tmp_path):
    from gpgpuraytrace.utils.image import write_png

    path = os.path.join(tmp_path, "any.png")
    write_png(path, img)
    np.testing.assert_array_equal(_decode_png(open(path, "rb").read()), img)


def test_encode_level_and_raw_mode(img, tmp_path):
    """VERDICT r4 item 6: zlib effort knob + encoder-free .rgb stream mode,
    decode-exact through both the native and Python writers."""
    from gpgpuraytrace.utils.image import write_png

    for level in (1, 6, 9):
        path = os.path.join(tmp_path, f"l{level}.png")
        write_png(path, img, level=level)
        np.testing.assert_array_equal(
            _decode_png(open(path, "rb").read()), img
        )
    raw_path = os.path.join(tmp_path, "frame.rgb")
    write_png(raw_path, img)
    back = np.fromfile(raw_path, np.uint8).reshape(img.shape)
    np.testing.assert_array_equal(back, img)
    assert os.path.getsize(raw_path) == img.size


def test_async_writer_level_and_rgb(img, tmp_path):
    native_io = pytest.importorskip("gpgpuraytrace.utils.native_io")
    if not native_io.available():
        pytest.skip("native toolchain unavailable")
    png = os.path.join(tmp_path, "a.png")
    rgb = os.path.join(tmp_path, "a.rgb")
    with native_io.AsyncFrameWriter(num_threads=2, level=1) as w:
        w.push(png, img)
        w.push(rgb, img)
    np.testing.assert_array_equal(_decode_png(open(png, "rb").read()), img)
    np.testing.assert_array_equal(
        np.fromfile(rgb, np.uint8).reshape(img.shape), img
    )

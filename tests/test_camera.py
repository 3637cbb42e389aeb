"""Camera raygen unit tests: canonical poses and FoV corners (SURVEY.md §5)."""

import jax.numpy as jnp
import numpy as np

from gpgpuraytrace.models.scene import Camera
from gpgpuraytrace.ops.camera import camera_basis, generate_rays


def _cam(yaw=0.0, pitch=0.0, fov=jnp.pi / 2):
    return Camera(
        position=jnp.zeros(3, jnp.float32),
        yaw=jnp.float32(yaw),
        pitch=jnp.float32(pitch),
        fov_y=jnp.float32(fov),
    )


def test_basis_axis_aligned():
    fwd, right, up = camera_basis(_cam())
    np.testing.assert_allclose(np.asarray(fwd), [0, 0, 1], atol=1e-6)
    np.testing.assert_allclose(np.asarray(right), [1, 0, 0], atol=1e-6)
    np.testing.assert_allclose(np.asarray(up), [0, 1, 0], atol=1e-6)


def test_basis_yaw_quarter_turn():
    fwd, right, _ = camera_basis(_cam(yaw=jnp.pi / 2))
    np.testing.assert_allclose(np.asarray(fwd), [1, 0, 0], atol=1e-6)
    np.testing.assert_allclose(np.asarray(right), [0, 0, -1], atol=1e-6)


def test_basis_orthonormal():
    fwd, right, up = camera_basis(_cam(yaw=0.7, pitch=0.3))
    for v in (fwd, right, up):
        np.testing.assert_allclose(np.linalg.norm(np.asarray(v)), 1.0, atol=1e-6)
    assert abs(float(jnp.dot(fwd, right))) < 1e-6
    assert abs(float(jnp.dot(fwd, up))) < 1e-6
    assert abs(float(jnp.dot(right, up))) < 1e-6


def test_center_ray_is_forward():
    cam = _cam(yaw=0.4, pitch=-0.2)
    _, dirs = generate_rays(cam, 64, 64)
    center = np.asarray(dirs[31:33, 31:33]).mean(axis=(0, 1))
    center /= np.linalg.norm(center)
    fwd, _, _ = camera_basis(cam)
    np.testing.assert_allclose(center, np.asarray(fwd), atol=1e-3)


def test_90deg_fov_vertical_extent():
    # With fov_y = 90°, the top-edge ray makes ~45° with forward (at pixel
    # centers, slightly less — (H-1)/H of the half-extent).
    h = w = 128
    _, dirs = generate_rays(_cam(fov=jnp.pi / 2), h, w)
    top_center = np.asarray(dirs[0, w // 2])
    expected_tan = (h - 1) / h  # pixel-center offset of the top row
    angle = np.arctan2(top_center[1], top_center[2])
    np.testing.assert_allclose(np.tan(angle), expected_tan, atol=2e-2)


def test_rays_normalized_and_origin_broadcast():
    cam = _cam()
    o, d = generate_rays(cam, 32, 48)
    assert o.shape == (32, 48, 3) and d.shape == (32, 48, 3)
    np.testing.assert_allclose(
        np.linalg.norm(np.asarray(d), axis=-1), 1.0, atol=1e-5
    )
    np.testing.assert_array_equal(np.asarray(o[5, 7]), np.asarray(cam.position))

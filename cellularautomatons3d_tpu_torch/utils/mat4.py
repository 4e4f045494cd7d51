"""4×4 matrix helpers with wgpu-matrix semantics (float32, WebGPU clip space).

The reference drives its camera with wgpu-matrix 2.5.0
(the reference app's libs/wgpu-matrix.module.js).  We reproduce the handful of
operations it uses — ``lookAt``, ``perspective`` (0..1 depth), ``translate``,
axis-angle ``rotate``, ``inverse``, ``multiply`` — bit-for-bit in float32 so
camera matrices (and therefore rays and reprojection) match the reference.

Matrices are numpy ``float32[4, 4]`` in **math convention**: ``m @ v``
transforms a column vector, translation lives in ``m[:3, 3]``.  wgpu-matrix
stores column-major flat arrays; use :func:`from_flat`/:func:`to_flat` to
cross that boundary (the shader's ``viewMat[3].xyz`` camera position is
``m[:3, 3]`` here: pathtraced_fragment_clustered.wgsl:812).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "identity",
    "look_at",
    "perspective",
    "translation",
    "translate",
    "axis_rotation",
    "rotate",
    "multiply",
    "inverse",
    "from_flat",
    "to_flat",
    "transform",
    "initial_view_matrix",
    "initial_projection_matrix",
    "FOV_DEGREES",
]

# The app always uses a 75° vertical FOV (main_pathtraced.js:495-497); the
# fragment shader additionally hard-codes the same angle (COT_HALF_FOV from
# 37.5°, pathtraced_fragment_clustered.wgsl:69).
FOV_DEGREES = 75.0

_f32 = np.float32


def identity() -> np.ndarray:
    return np.eye(4, dtype=_f32)


def from_flat(flat) -> np.ndarray:
    """Column-major 16-float (wgpu-matrix storage) → [4,4] math-convention."""
    return np.asarray(flat, dtype=_f32).reshape(4, 4).T.copy()


def to_flat(m: np.ndarray) -> np.ndarray:
    """[4,4] math-convention → column-major 16-float (wgpu-matrix storage)."""
    return np.asarray(m, dtype=_f32).T.reshape(-1).copy()


def look_at(eye, target, up) -> np.ndarray:
    """wgpu-matrix ``mat4.lookAt``: a **view** (world→camera) matrix
    (libs/wgpu-matrix.module.js:3339-3364).

    Note the reference *treats* the result as a camera-to-world matrix
    (cameraPos = viewMat[3].xyz); for its symmetric startup arguments the
    distinction collapses — see :func:`initial_view_matrix`.
    """
    eye = np.asarray(eye, dtype=_f32)
    target = np.asarray(target, dtype=_f32)
    up = np.asarray(up, dtype=_f32)
    z = eye - target
    z = z / _f32(np.linalg.norm(z))
    x = np.cross(up, z).astype(_f32)
    x = x / _f32(np.linalg.norm(x))
    y = np.cross(z, x).astype(_f32)
    y = y / _f32(np.linalg.norm(y))
    m = identity()
    m[0, :3] = x
    m[1, :3] = y
    m[2, :3] = z
    m[0, 3] = -np.dot(x, eye)
    m[1, 3] = -np.dot(y, eye)
    m[2, 3] = -np.dot(z, eye)
    return m


def perspective(fov_y_radians: float, aspect: float, z_near: float, z_far: float) -> np.ndarray:
    """wgpu-matrix ``mat4.perspective``: WebGPU 0..1 depth clip
    (libs/wgpu-matrix.module.js:3140-3167)."""
    f = _f32(np.tan(np.pi * 0.5 - 0.5 * fov_y_radians))
    m = np.zeros((4, 4), dtype=_f32)
    m[0, 0] = f / _f32(aspect)
    m[1, 1] = f
    m[3, 2] = _f32(-1.0)
    if np.isinf(z_far):
        m[2, 2] = _f32(-1.0)
        m[2, 3] = _f32(-z_near)
    else:
        range_inv = _f32(1.0) / (_f32(z_near) - _f32(z_far))
        m[2, 2] = _f32(z_far) * range_inv
        m[2, 3] = _f32(z_far) * _f32(z_near) * range_inv
    return m


def translation(v) -> np.ndarray:
    m = identity()
    m[:3, 3] = np.asarray(v, dtype=_f32)
    return m


def translate(m: np.ndarray, v) -> np.ndarray:
    """Post-multiplied (local-space) translate: ``m @ T(v)``
    (libs/wgpu-matrix.module.js:3400-3440)."""
    return (np.asarray(m, dtype=_f32) @ translation(v)).astype(_f32)


def axis_rotation(axis, angle_radians: float) -> np.ndarray:
    """wgpu-matrix ``mat4.axisRotation`` (Rodrigues, axis normalised)."""
    axis = np.asarray(axis, dtype=np.float64)
    n = np.linalg.norm(axis)
    x, y, z = (axis / n) if n > 0 else axis
    c = np.cos(angle_radians)
    s = np.sin(angle_radians)
    one_c = 1.0 - c
    m = identity()
    m[:3, :3] = np.array(
        [
            [x * x * one_c + c, x * y * one_c - z * s, x * z * one_c + y * s],
            [y * x * one_c + z * s, y * y * one_c + c, y * z * one_c - x * s],
            [z * x * one_c - y * s, z * y * one_c + x * s, z * z * one_c + c],
        ],
        dtype=_f32,
    )
    return m


def rotate(m: np.ndarray, axis, angle_radians: float) -> np.ndarray:
    """Post-multiplied (local-space) axis-angle rotate: ``m @ R``."""
    return (np.asarray(m, dtype=_f32) @ axis_rotation(axis, angle_radians)).astype(_f32)


def multiply(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (np.asarray(a, dtype=_f32) @ np.asarray(b, dtype=_f32)).astype(_f32)


def inverse(m: np.ndarray) -> np.ndarray:
    return np.linalg.inv(np.asarray(m, dtype=_f32)).astype(_f32)


def transform(m: np.ndarray, v) -> np.ndarray:
    """``m @ [v, 1]`` → length-4 vector."""
    v4 = np.ones(4, dtype=_f32)
    v4[:3] = np.asarray(v, dtype=_f32)[:3]
    return (np.asarray(m, dtype=_f32) @ v4).astype(_f32)


def initial_view_matrix() -> np.ndarray:
    """The app's startup camera matrix (main_pathtraced.js:207-213):
    ``lookAt((0,0,1), 0, (0,1,0))`` then ``translate(+1.75 z)``.

    lookAt is a *view* matrix but the app uses it as camera-to-world; with
    these symmetric arguments the net result is identity rotation with the
    camera at ``(0, 0, 0.75)`` — just outside the unit volume cube.
    """
    m = look_at(eye=(0.0, 0.0, 1.0), target=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0))
    return translate(m, (0.0, 0.0, 1.75))


def initial_projection_matrix(width: int, height: int) -> np.ndarray:
    """75° FOV, aspect from window size, near .01 / far 1000
    (main_pathtraced.js:495-501)."""
    return perspective(
        np.deg2rad(FOV_DEGREES), width / height, 0.01, 1000.0
    )

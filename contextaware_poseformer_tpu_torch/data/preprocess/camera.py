"""Camera models: quaternion world/camera transforms and the Human3.6M
distortion projection.

numpy re-statement of the vendored VideoPose3D camera math used on the
reference's live label-building path (H36M-Toolbox/common/camera.py:28-67,
common/quaternion.py:10-35; 3DHP copy ContextPose_mpi/common/camera.py:16-66).
jnp variants provided for in-graph use (streaming pipeline).

The port's copy of ``contextaware_poseformer_tpu/data/preprocess/camera.py``
(held to it by ``tests/test_torch_copies.py``).
"""

from __future__ import annotations

import numpy as np


def qrot(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Rotate vectors v by unit quaternions q (wxyz), batched."""
    assert q.shape[-1] == 4 and v.shape[-1] == 3
    qvec = q[..., 1:]
    uv = np.cross(qvec, v)
    uuv = np.cross(qvec, uv)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def qinverse(q: np.ndarray) -> np.ndarray:
    """Conjugate of a unit quaternion."""
    return np.concatenate([q[..., :1], -q[..., 1:]], axis=-1)


def world_to_camera(x: np.ndarray, r_quat: np.ndarray, t: np.ndarray) -> np.ndarray:
    rt = qinverse(np.asarray(r_quat, np.float64))
    rt = np.broadcast_to(rt, (*x.shape[:-1], 4))
    return qrot(rt, x - t)


def camera_to_world(x: np.ndarray, r_quat: np.ndarray, t: np.ndarray) -> np.ndarray:
    r = np.broadcast_to(np.asarray(r_quat, np.float64), (*x.shape[:-1], 4))
    return qrot(r, x) + t


def project_to_2d(x_cam: np.ndarray, camera_params: np.ndarray) -> np.ndarray:
    """H36M projection with radial (k1..k3) + tangential (p1,p2) distortion.

    x_cam: (..., 3) camera-space points; camera_params: (..., 9) packed as
    [fx, fy, cx, cy, k1, k2, k3, p1, p2] (camera.py:37-67).
    """
    x_cam = np.asarray(x_cam, np.float64)
    cp = np.asarray(camera_params, np.float64)
    while cp.ndim < x_cam.ndim:
        cp = cp[..., None, :]
    f, c, k, p = cp[..., :2], cp[..., 2:4], cp[..., 4:7], cp[..., 7:]

    xx = np.clip(x_cam[..., :2] / x_cam[..., 2:], -1.0, 1.0)
    r2 = np.sum(xx**2, axis=-1, keepdims=True)
    radial = 1.0 + np.sum(
        k * np.concatenate([r2, r2**2, r2**3], axis=-1), axis=-1, keepdims=True
    )
    tan = np.sum(p * xx, axis=-1, keepdims=True)
    xxx = xx * (radial + tan) + p * r2
    return f * xxx + c


def project_to_2d_linear(x_cam: np.ndarray, camera_params: np.ndarray) -> np.ndarray:
    """Distortion-free pinhole variant (camera.py:70+)."""
    x_cam = np.asarray(x_cam, np.float64)
    cp = np.asarray(camera_params, np.float64)
    while cp.ndim < x_cam.ndim:
        cp = cp[..., None, :]
    f, c = cp[..., :2], cp[..., 2:4]
    xx = np.clip(x_cam[..., :2] / x_cam[..., 2:], -1.0, 1.0)
    return f * xx + c

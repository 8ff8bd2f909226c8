"""Host-side transform math: quaternions, Slerp, keyframe interpolation.

Counterpart of the reference's rotation utilities (reference: Vector.h:60-85
Quaternion, :223-269 Slerp of Matrix33 via quaternions, :270-293 rotation
factories) and the per-object keyframe maps with linear/slerp interpolation
(Geometry.h:258-320).  All numpy — runs at scene-build/frame time.
"""

from __future__ import annotations

import bisect
import math

import numpy as np


def mat_to_quat(m: np.ndarray) -> np.ndarray:
    """3x3 rotation -> quaternion (w, x, y, z)."""
    m = np.asarray(m, np.float64)
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    if tr > 0:
        s = math.sqrt(tr + 1.0) * 2
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = math.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = math.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = math.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    q = np.array([w, x, y, z])
    return q / np.linalg.norm(q)


def quat_to_mat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def slerp_mat(m1: np.ndarray, m2: np.ndarray, t: float) -> np.ndarray:
    """Slerp between rotation matrices (reference: Slerp, Vector.h:223-269)."""
    q1 = mat_to_quat(m1)
    q2 = mat_to_quat(m2)
    d = float(np.dot(q1, q2))
    if d < 0:
        q2 = -q2
        d = -d
    if d > 0.9995:
        q = q1 + t * (q2 - q1)
    else:
        th = math.acos(min(1.0, d))
        q = (math.sin((1 - t) * th) * q1 + math.sin(t * th) * q2) / math.sin(th)
    return quat_to_mat(q)


def rotation_x(a):
    c, s = math.cos(a), math.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float64)


def rotation_y(a):
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)


def rotation_z(a):
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float64)


def _interp_map(keys, values, frame, lerp):
    """The reference's keyframe-map semantics (Geometry.h:258-276):
    upper_bound clamping at both ends, linear blend between brackets."""
    idx = bisect.bisect_right(keys, frame)
    if idx >= len(keys):
        return values[-1]
    if idx == 0:
        return values[0]
    f0, f1 = keys[idx - 1], keys[idx]
    t = (frame - f0) / (f1 - f0)
    return lerp(values[idx - 1], values[idx], t)


def interpolate_keyframes(keyframes: dict, frame: float):
    """keyframes: {frame: {'translation': (3,), 'rotation': 3x3|None,
    'scale': float}} -> (translation, rotation, scale) at `frame`."""
    keys = sorted(keyframes)
    tr = _interp_map(
        keys, [np.asarray(keyframes[k].get('translation', (0, 0, 0)),
                          np.float64) for k in keys],
        frame, lambda a, b, t: (1 - t) * a + t * b)
    rots = [np.asarray(keyframes[k]['rotation'], np.float64)
            if keyframes[k].get('rotation') is not None else np.eye(3)
            for k in keys]
    rot = _interp_map(keys, rots, frame, slerp_mat)
    sc = _interp_map(keys, [float(keyframes[k].get('scale', 1.0))
                            for k in keys],
                     frame, lambda a, b, t: (1 - t) * a + t * b)
    return tr, rot, sc

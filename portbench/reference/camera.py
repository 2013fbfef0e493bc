"""Pinhole camera (frozen copy of the port's ``render/camera.py`` and of the
camera helpers of ``render/slabs.py``): rays are ``dir00 + (px + jx)
du + (py + jy) dv``, host numpy."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _normalize(v):
    v = np.asarray(v, np.float32)
    return v / np.linalg.norm(v)


@dataclass
class Camera:
    pos: np.ndarray
    dir00: np.ndarray
    dir_du: np.ndarray
    dir_dv: np.ndarray

    @staticmethod
    def look_at(from_, at, up, fovy_degrees: float, width: int,
                height: int) -> "Camera":
        from_ = np.asarray(from_, np.float32)
        at = np.asarray(at, np.float32)
        up = np.asarray(up, np.float32)
        if np.allclose(at, from_):
            vz = np.array([0, 0, 1], np.float32)
        else:
            vz = -_normalize(at - from_)
        vx = np.cross(up, vz)
        if float(vx @ vx) < 1e-8:
            vx = np.array([0, 1, 0], np.float32)
        else:
            vx = _normalize(vx)
        vy = _normalize(np.cross(vz, vx))
        if abs(float(vz @ _normalize(up))) >= 1e-6:
            vx = _normalize(np.cross(up, vz))
            vy = _normalize(np.cross(vz, vx))
        focal = float(np.linalg.norm(at - from_))
        eps = max(np.max(np.abs(from_)), np.max(np.abs(vx))) / (1 << 21)
        focal = max(focal, eps)
        aspect = width / float(height)
        screen_h = 2.0 * np.tan(np.radians(fovy_degrees) / 2) * focal
        vertical = screen_h * vy
        horizontal = screen_h * aspect * vx
        lower_left = -focal * vz - 0.5 * vertical - 0.5 * horizontal
        return Camera(
            pos=from_.astype(np.float32),
            dir00=lower_left.astype(np.float32),
            dir_du=(horizontal / width).astype(np.float32),
            dir_dv=(vertical / height).astype(np.float32),
        )


def principal_axis(direction) -> int:
    return int(np.argmax(np.abs(np.asarray(direction))))


def permute_camera(camera, axis: int):
    """Camera vectors from world (x, y, z) to the grid (z, y, x) frame."""
    other = [a for a in (2, 1, 0) if a != axis]
    perm = (axis, *other)

    def p(v):
        v = np.asarray(v)
        return np.asarray([v[perm[0]], v[perm[1]], v[perm[2]]], np.float32)

    return p(camera.pos), p(camera.dir00), p(camera.dir_du), p(camera.dir_dv)


def separable_mapping(camera, axis: int, atol: float = 1e-5):
    """None if the camera is not separable along ``axis``, else
    (swapped,)."""
    _, _, du_p, dv_p = permute_camera(camera, axis)
    if abs(du_p[0]) >= atol or abs(dv_p[0]) >= atol:
        return None
    if abs(du_p[1]) < atol and abs(dv_p[2]) < atol:
        return (False,)
    if abs(du_p[2]) < atol and abs(dv_p[1]) < atol:
        return (True,)
    return None


def camera_to_voxel(camera, voxel_from_world):
    m = np.asarray(voxel_from_world, np.float64)
    a = m[:, :3]
    b = m[:, 3]
    return Camera(
        pos=(a @ np.asarray(camera.pos, np.float64) + b).astype(np.float32),
        dir00=(a @ np.asarray(camera.dir00, np.float64)).astype(np.float32),
        dir_du=(a @ np.asarray(camera.dir_du, np.float64)).astype(np.float32),
        dir_dv=(a @ np.asarray(camera.dir_dv, np.float64)).astype(np.float32),
    )

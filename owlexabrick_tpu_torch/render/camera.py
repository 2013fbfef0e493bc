"""Pinhole camera matching the reference's viewer camera semantics
(glutViewer/Camera.cpp:84-120, glutViewer/OWLViewer.cpp:81-109): rays
are ``dir = dir00 + (px+jx)*du + (py+jy)*dv`` with dir00 the direction
to the screen's lower-left corner.  Host numpy, like the JAX package's
``render/camera.py``, so both packages derive bit-identical vectors."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _normalize(v):
    v = np.asarray(v, np.float32)
    return v / np.linalg.norm(v)


@dataclass
class Camera:
    pos: np.ndarray  # lens center
    dir00: np.ndarray  # direction to lower-left screen corner
    dir_du: np.ndarray  # per-pixel step along screen x
    dir_dv: np.ndarray  # per-pixel step along screen y

    @staticmethod
    def look_at(from_, at, up, fovy_degrees: float, width: int,
                height: int) -> "Camera":
        from_ = np.asarray(from_, np.float32)
        at = np.asarray(at, np.float32)
        up = np.asarray(up, np.float32)

        # right-handed frame, view along -vz (Camera.cpp:94-120)
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
        # forceUpFrame (Camera.cpp:84-92)
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

    def rays(self, width: int, height: int, jitter=None):
        """Generate (origin, direction) for every pixel (host numpy).

        ``jitter``: (H, W, 2) in [0,1) intra-pixel offsets (0.5 center
        default).  Returns origins (H*W, 3), normalized dirs (H*W, 3) in
        row-major pixel order (y-major, x fastest) like the reference's
        pixelIdx = x + w*y.
        """
        px, py = np.meshgrid(np.arange(width), np.arange(height))
        if jitter is None:
            jx = jy = 0.5
        else:
            jx = jitter[..., 0]
            jy = jitter[..., 1]
        d = (
            self.dir00[None, None]
            + (px + jx)[..., None] * self.dir_du[None, None]
            + (py + jy)[..., None] * self.dir_dv[None, None]
        )
        d = d / np.linalg.norm(d, axis=-1, keepdims=True)
        o = np.broadcast_to(self.pos, d.shape)
        return (
            o.reshape(-1, 3).astype(np.float32),
            d.reshape(-1, 3).astype(np.float32),
        )

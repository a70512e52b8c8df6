"""Synthetic multi-camera scene generator with ground truth.

Stand-in for the paper's JAAD / DukeMTMC footage (Section 2.1): each camera
produces a stream of uint8 frames containing moving rectangular "pedestrians"
over a textured static background, with per-frame ground-truth bounding boxes.

Scene dynamics follow the paper's clustering: simple / medium / complex map to
increasing object counts and texture energy, which mechanistically yields the
paper's size ordering (complex frames deflate-compress worse, i.e. are larger
on the wire) and its accuracy ordering (complex scenes lose more F1 under
quality degradation because small/overlapping objects blur together).

Deterministic given (camera_id, seed): every benchmark is reproducible.
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np

__all__ = ["SceneDynamics", "CameraConfig", "SyntheticCamera", "DYNAMICS"]

DYNAMICS = ("simple", "medium", "complex")


@dataclasses.dataclass(frozen=True)
class SceneDynamics:
    name: str
    num_objects: tuple[int, int]      # inclusive range
    obj_size: tuple[int, int]         # min/max box side, pixels
    texture_amp: float                # background texture energy
    speed: float                      # px/frame


_DYNAMICS = {
    "simple": SceneDynamics("simple", (1, 2), (14, 26), 6.0, 1.5),
    "medium": SceneDynamics("medium", (3, 5), (12, 22), 12.0, 2.5),
    "complex": SceneDynamics("complex", (5, 8), (10, 20), 18.0, 3.5),
}


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    camera_id: str = "cam0"
    height: int = 144
    width: int = 256
    channels: int = 3
    dynamics: str = "complex"
    fps: float = 5.0
    noise_sigma: float = 2.0
    seed: int = 0


class SyntheticCamera:
    """Streaming frame source.  ``next_frame()`` -> (timestamp, frame, boxes)."""

    def __init__(self, config: CameraConfig):
        self.config = config
        self.dyn = _DYNAMICS[config.dynamics]
        # stable across processes (Python's str hash is salted)
        cam_hash = zlib.crc32(config.camera_id.encode()) & 0x7FFFFFFF
        self._rng = np.random.default_rng(
            np.random.SeedSequence([config.seed, cam_hash]))
        self._t = 0
        self.background = self._make_background()
        self._spawn_movers()

    def _spawn_movers(self) -> None:
        """Roll a mover population for the CURRENT dynamics regime."""
        config = self.config
        n = int(self._rng.integers(self.dyn.num_objects[0], self.dyn.num_objects[1] + 1))
        h, w = config.height, config.width
        self._pos = self._rng.uniform([0, 0], [h - 1, w - 1], size=(n, 2))
        ang = self._rng.uniform(0, 2 * np.pi, size=n)
        self._vel = np.stack([np.sin(ang), np.cos(ang)], -1) * self.dyn.speed
        self._sizes = self._rng.integers(self.dyn.obj_size[0], self.dyn.obj_size[1] + 1,
                                         size=(n, 2))
        # pedestrians are taller than wide
        self._sizes[:, 0] = (self._sizes[:, 0] * 1.8).astype(self._sizes.dtype)
        self._shades = self._rng.integers(150, 255, size=(n, config.channels))

    def set_dynamics(self, dynamics: str) -> None:
        """Mid-stream scene regime change (workload shift): the mover
        population re-rolls under the new regime while the background, the
        frame clock, and the rng stream all carry over -- the scripted
        analogue of a quiet corridor turning into a rush-hour crowd, which
        is exactly the shift that makes characterization tables stale
        (scenario event ``SceneShift``).  Deterministic given the camera's
        seed and the stream position at which it is called."""
        self.dyn = _DYNAMICS[dynamics]
        self.config = dataclasses.replace(self.config, dynamics=dynamics)
        self._spawn_movers()

    # -- scene pieces -----------------------------------------------------------
    def _make_background(self) -> np.ndarray:
        c = self.config
        rng = self._rng
        # smooth low-frequency texture: sum of a few 2-D cosines + mild noise
        yy, xx = np.mgrid[0:c.height, 0:c.width].astype(np.float32)
        bg = np.full((c.height, c.width), 90.0, np.float32)
        for _ in range(4):
            fy, fx = rng.uniform(0.005, 0.05, 2)
            ph = rng.uniform(0, 2 * np.pi)
            bg += self.dyn.texture_amp * np.cos(2 * np.pi * (fy * yy + fx * xx) + ph)
        bg += rng.normal(0, self.dyn.texture_amp * 0.3, bg.shape)
        bg = np.clip(bg, 0, 255)
        if c.channels == 1:
            return bg.astype(np.uint8)
        chan = [np.clip(bg * s, 0, 255) for s in (1.0, 0.96, 0.92)[: c.channels]]
        return np.stack(chan, -1).astype(np.uint8)

    def _step_objects(self) -> None:
        h, w = self.config.height, self.config.width
        self._pos += self._vel
        for d, lim in ((0, h - 1), (1, w - 1)):
            low = self._pos[:, d] < 0
            high = self._pos[:, d] > lim
            self._vel[low | high, d] *= -1
            self._pos[low, d] *= -1
            self._pos[high, d] = 2 * lim - self._pos[high, d]

    # -- the stream ---------------------------------------------------------------
    def next_frame(self) -> tuple[float, np.ndarray, np.ndarray]:
        """Returns (timestamp_s, uint8 frame [H,W,C], boxes [N,4] y0x0y1x1)."""
        c = self.config
        self._step_objects()
        frame = self.background.astype(np.float32).copy()
        boxes = []
        h, w = c.height, c.width
        for (py, px), (sy, sx), shade in zip(self._pos, self._sizes, self._shades):
            y0 = int(np.clip(py - sy / 2, 0, h - 1)); y1 = int(np.clip(py + sy / 2, 1, h))
            x0 = int(np.clip(px - sx / 2, 0, w - 1)); x1 = int(np.clip(px + sx / 2, 1, w))
            if y1 - y0 < 2 or x1 - x0 < 2:
                continue
            if c.channels == 1:
                frame[y0:y1, x0:x1] = shade[0]
            else:
                frame[y0:y1, x0:x1, :] = shade[None, None, :]
            boxes.append((y0, x0, y1, x1))
        frame += self._rng.normal(0, c.noise_sigma, frame.shape)
        frame = np.clip(frame, 0, 255).astype(np.uint8)
        ts = self._t / c.fps
        self._t += 1
        return ts, frame, np.asarray(boxes, np.float32).reshape(-1, 4)

    def stream(self, n: int):
        for _ in range(n):
            yield self.next_frame()

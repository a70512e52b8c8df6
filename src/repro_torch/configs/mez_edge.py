"""The paper's own deployment configuration: the Mez IoT-Edge testbed
(Section 2.1) -- 5 IoT camera nodes, one edge server, 802.11ac, plus the
controller targets used in Section 5 (100 ms latency, 95% normalized F1).

This is not an LM architecture; it parameterizes the Mez substrate
(channel, cameras, controller) for the reproduction benchmarks.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MezEdgeConfig:
    num_cameras: int = 5
    fps: float = 5.0
    distance_m: float = 6.0
    latency_target: float = 0.100        # seconds (p95)
    accuracy_target: float = 0.95        # normalized F1
    frame_height: int = 144
    frame_width: int = 256
    log_capacity: int = 2048             # ~7 min at 5 fps (paper Section 4.3)
    feedback_window: int = 8
    fetch_window: int = 2
    characterization_clip: int = 32
    seed: int = 7


CONFIG = MezEdgeConfig()

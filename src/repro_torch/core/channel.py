"""Simulated 802.11ac wireless channel, calibrated to the paper's testbed.

The paper (Section 2) characterizes per-frame transfer latency from IoT camera
nodes to the Edge server over 802.11ac as a function of (1) the number of peer
nodes transmitting concurrently, (2) frame size, (3) frame rate, and (4) node
distance from the AP.  Key empirical facts we calibrate against:

  * Latency is ~linear in frame size (paper Fig. 5).
  * ONE_Lat for JAAD-simple (610 kB) is 32.09 ms  -> ~153 Mbps effective.
  * FIVE_Lat/ONE_Lat inflation is 4.6x-8.8x (paper Table 1): contention cost
    is super-linear in the number of active transmitters (CSMA/CA backoff).
  * 15 fps vs 5 fps costs ~1.02x at 5 nodes; 12 m vs 6 m costs ~1.06x
    (paper Table 2): both secondary effects.

The model:  p95(n, size, fps, dist) =
    J * [ oh*(1 + e*(n-1)) + size/rate * contention(n, size, fps, dist) ]

with contention(n, size) = 1 + (c1*(n-1) + c2*(n-1)^2) * (size/size_ref)^g,
J = exp(-sigma^2/2 + 1.645*sigma) the log-normal p95/mean factor.  The
(size/size_ref)^g term captures load-dependent queueing: at 5 nodes x 5 fps,
large frames push the offered load past channel capacity, so their contention
ratio is higher (paper Table 1: 4.6x at 610 kB vs 8.4x at 1740 kB).  Constants
below were least-squares fit to all 12 points of paper Table 1 (max rel. error
<10%) and validated against Table 2's node sweep.

This module is plain Python/NumPy (host-side substrate, like the real network
stack): the controller and everything TPU-facing treat it as an opaque latency
source.  All randomness is seeded -> bit-reproducible experiments.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = ["ChannelConfig", "WirelessChannel", "calibrated_channel"]


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    """Parameters of the contention model (defaults calibrated to the paper)."""

    # Effective single-node mean goodput, bytes/second (fit to Table 1 with
    # the p95 factor J divided out).
    base_rate: float = 3.809e7
    # Fixed per-frame overhead (MAC/queueing/gRPC), seconds, and its per-peer
    # scaling factor e: oh(n) = base_overhead * (1 + e*(n-1)).
    base_overhead: float = 8.237e-3
    overhead_peer: float = 1.0
    # Contention: 1 + (c1*(n-1) + c2*(n-1)^2) * (size/size_ref)^gamma.
    c1: float = 0.347
    c2: float = 0.204
    gamma: float = 0.962
    size_ref: float = 970e3
    # Per-frame-rate load inflation: multiplies the *peer* contention terms.
    # At 15 fps (3x the 5 fps baseline) and n=5 the paper sees only ~1.02x:
    # the channel is already saturated, so the knee is mostly in n, not fps.
    fps_ref: float = 5.0
    fps_coeff: float = 0.02
    # Distance factor: rate falloff per meter beyond the 6 m reference.
    # 12 m vs 6 m -> ~1.06x latency (Table 2): (1 + 0.011*6) ~ 1.066.
    dist_ref: float = 6.0
    dist_coeff: float = 0.011
    # Log-normal jitter sigma (the tail that makes p95 interesting).
    jitter_sigma: float = 0.18
    # External-interference multiplier (paper Section 2.2: "additional
    # external interference effects... worsen the latency").  1.0 = none.
    interference: float = 1.0
    # Workload scale: multiplies payload sizes before the latency law.  The
    # synthetic scenes compress to ~90 kB while the paper's footage is
    # 610-1740 kB; size_scale maps our wire sizes onto the paper's regime
    # (jaad ~ 10.8x, dukemtmc ~ 19.3x) so contention effects reproduce
    # quantitatively.  Also used for the NATS 1 MB message-limit check.
    size_scale: float = 1.0


class WirelessChannel:
    """A shared 802.11ac channel with CSMA/CA-style contention.

    One instance models the single collision domain around the AP.  Nodes
    register as transmitters; per-frame latency depends on how many peers are
    actively transmitting (paper Fig. 4) plus seeded jitter.

    Thread-safe for the broker layer: state mutation is limited to the
    ``active`` set and the RNG, guarded by the GIL-atomic operations used.
    """

    def __init__(self, config: ChannelConfig | None = None, *, seed: int = 0):
        self.config = config or ChannelConfig()
        self._rng = np.random.default_rng(seed)
        self._active: set[str] = set()
        self._clock: float = 0.0  # simulated seconds

    # -- transmitter registry -------------------------------------------------
    def activate(self, node_id: str) -> None:
        self._active.add(node_id)

    def deactivate(self, node_id: str) -> None:
        self._active.discard(node_id)

    @property
    def num_active(self) -> int:
        return max(1, len(self._active))

    def set_interference(self, factor: float) -> None:
        """Set the external-interference multiplier in place (paper
        Section 2.2).  The scenario harness scripts this over virtual time
        (spikes, ramps); the config stays an immutable value object --
        mutation is a whole-config replace, so captured references to the
        old config stay coherent."""
        if factor <= 0:
            raise ValueError(f"interference factor must be > 0, got {factor}")
        self.config = dataclasses.replace(self.config, interference=factor)

    # -- the latency law -------------------------------------------------------
    def contention(self, n: int, size_bytes: float, fps: float) -> float:
        c = self.config
        peers = max(0, n - 1)
        load = 1.0 + c.fps_coeff * (fps / c.fps_ref - 1.0)
        size_term = (max(size_bytes, 1.0) / c.size_ref) ** c.gamma
        return 1.0 + (c.c1 * peers + c.c2 * peers * peers) * size_term * load

    def mean_latency(
        self,
        size_bytes: float,
        *,
        n: int | None = None,
        fps: float = 5.0,
        distance_m: float = 6.0,
    ) -> float:
        """Deterministic mean per-frame latency in seconds (no jitter)."""
        n = self.num_active if n is None else n
        c = self.config
        size_bytes = size_bytes * c.size_scale
        dist_factor = 1.0 + c.dist_coeff * max(0.0, distance_m - c.dist_ref)
        oh = c.base_overhead * (1.0 + c.overhead_peer * (n - 1))
        xfer = (size_bytes / c.base_rate) * self.contention(n, size_bytes, fps)
        return (oh + xfer) * dist_factor * c.interference

    def scaled_bytes(self, size_bytes: float) -> float:
        """Payload size in workload-equivalent bytes (for message limits)."""
        return size_bytes * self.config.size_scale

    def transfer(
        self,
        size_bytes: float,
        *,
        n: int | None = None,
        fps: float = 5.0,
        distance_m: float = 6.0,
    ) -> float:
        """Sample one frame-transfer latency (seconds), with jitter."""
        mean = self.mean_latency(size_bytes, n=n, fps=fps, distance_m=distance_m)
        sigma = self.config.jitter_sigma
        # Log-normal with median = mean/exp(sigma^2/2) so E[latency] ~= mean.
        jitter = self._rng.lognormal(mean=-0.5 * sigma * sigma, sigma=sigma)
        latency = mean * jitter
        self._clock += latency
        return latency

    def p95_latency(
        self,
        size_bytes: float,
        *,
        n: int | None = None,
        fps: float = 5.0,
        distance_m: float = 6.0,
    ) -> float:
        """Analytic 95th-percentile latency (paper reports p95 everywhere)."""
        mean = self.mean_latency(size_bytes, n=n, fps=fps, distance_m=distance_m)
        sigma = self.config.jitter_sigma
        z95 = 1.6448536269514722
        return mean * math.exp(-0.5 * sigma * sigma + z95 * sigma)

    # -- the controller's sensor ----------------------------------------------
    def regression_points(
        self, sizes: np.ndarray, *, n: int, fps: float = 5.0, distance_m: float = 6.0
    ) -> np.ndarray:
        """Mean latencies for an array of sizes (used to fit the paper's
        linear regression model of latency on frame size)."""
        return np.asarray(
            [self.mean_latency(float(s), n=n, fps=fps, distance_m=distance_m) for s in sizes]
        )


# Median wire size of a complex-dynamics synthetic frame (the workload-scale
# reference); paper Size_med for complex scenes: JAAD 970 kB, DukeMTMC 1740 kB.
SYNTHETIC_COMPLEX_WIRE = 90e3
WORKLOAD_SCALES = {
    None: 1.0,
    "jaad": 970e3 / SYNTHETIC_COMPLEX_WIRE,
    "dukemtmc": 1740e3 / SYNTHETIC_COMPLEX_WIRE,
}


def calibrated_channel(*, seed: int = 0, interference: float = 1.0,
                       workload: str | None = None) -> WirelessChannel:
    """The paper-calibrated channel (Section 2.1 testbed).

    ``workload``: None (raw sizes), "jaad", or "dukemtmc" -- maps synthetic
    wire sizes onto the paper dataset's size regime.
    """
    cfg = dataclasses.replace(ChannelConfig(), interference=interference,
                              size_scale=WORKLOAD_SCALES[workload])
    return WirelessChannel(cfg, seed=seed)

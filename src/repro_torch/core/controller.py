"""The Mez network latency controller (paper Section 4.2, Algorithm 1).

Two implementations with identical control law:

``LatencyController``  -- host-side, lives next to the CamBroker (the paper's
                          deployment: a microservice on the IoT camera node).
``controller_step``    -- tensor ops on the device, batched over a leading
                          lane (camera) axis in the fleet form
                          (``fleet_controller_step``, ``fused_fleet_tick``).

``ControllerTables`` are tensor inputs of the step: padded to a fixed
``capacity`` with an ``n_valid`` row count, so a freshly characterized table
(``grid_engine.refresh_tables``) swaps into the live buffers with no change
of shape (``swap_tables``, ``fleet_swap_tables``).  That closes the online
re-characterization loop: ``Session.update_qos`` re-runs the batched sweep
and the very next step consumes the new tables.

Control law (Algorithm 1):

    nominal   = Regression^-1(latency_target)              # bytes
    error     = latency_sampled - latency_target           # seconds
    size      = nominal + K1 * error + K2 * integral(error)
    accuracy, knob = Table.query(size)                     # BST + hash lookups
    if accuracy >= accuracy_target: apply knob
    else: report infeasible (application decides: relax or fail)

K1, K2 < 0: positive latency error shrinks the requested size.  Gains are
auto-scaled from the regression slope so they are expressed in natural units
("how many bytes does one second of error buy").
"""

from __future__ import annotations

import dataclasses
from collections import deque
from collections.abc import Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.characterization import (CharacterizationTable,
                                               LatencyRegression)
from repro_torch.core.drift import (DriftConfig, DriftParams, DriftState,
                                    drift_init, drift_update)
from repro_torch.core.knobs import KnobSetting
from repro_torch.device import resolve_device

__all__ = ["ControllerConfig", "ControlDecision", "LatencyController",
           "ControllerTables", "ControllerState", "controller_init",
           "controller_step", "swap_tables", "ControllerParams", "StepAux",
           "stack_tables", "stack_params", "fleet_controller_init",
           "fleet_controller_step", "fleet_swap_tables", "FusedTickAux",
           "fused_fleet_tick", "FleetTickResult", "FleetController"]


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    latency_target: float            # seconds (paper: 100 ms)
    accuracy_target: float           # normalized F1 floor (paper: 0.95-0.96)
    error_threshold: float = 0.010   # seconds; inside the band = no action
    alpha_p: float = 0.8             # K1 = -alpha_p / slope
    alpha_i: float = 0.25            # K2 = -alpha_i / slope
    integral_clip: float = 1.0       # anti-windup, seconds*samples
    relax: bool = True               # also act when latency is far BELOW target
                                     # (paper's Alg. 1 is one-sided; relaxation
                                     # restores quality after interference ends)


@dataclasses.dataclass(frozen=True)
class ControlDecision:
    feasible: bool
    setting: KnobSetting | None
    setting_index: int
    predicted_accuracy: float
    requested_size: float
    error: float
    acted: bool


class LatencyController:
    """Host-side PI controller (one per IoT camera node; no central control,
    so camera nodes scale independently -- paper Section 4.2)."""

    def __init__(self, config: ControllerConfig, table: CharacterizationTable,
                 regression: LatencyRegression):
        self.config = config
        self.table = table
        self.regression = regression
        self.integral = 0.0
        self.k1 = -config.alpha_p / max(regression.slope, 1e-12)
        self.k2 = -config.alpha_i / max(regression.slope, 1e-12)
        self._nominal = regression.invert(config.latency_target)
        # Algorithm 1: the starting operating point is the nominal size the
        # regression model predicts for the latency target (not full quality).
        _, idx = self.table.query_size(
            float(np.clip(self._nominal, self.table.sizes_sorted[0],
                          self.table.sizes_sorted[-1])))
        self._current = int(idx)

    def set_target(self, latency_target: float, accuracy_target: float) -> None:
        """The CamBroker's internal SetTarget API (paper Fig. 9).

        Runtime retarget: callable mid-stream (v2 ``update_qos``).  Besides
        resetting the integral, the operating point is re-seeded from the new
        target's nominal size so the renegotiated bounds take effect on the
        very next fetch -- within one control interval -- instead of waiting
        for the error signal to walk the old setting over.
        """
        self.config = dataclasses.replace(
            self.config, latency_target=latency_target,
            accuracy_target=accuracy_target)
        self._nominal = self.regression.invert(latency_target)
        self.integral = 0.0
        _, idx = self.table.query_size(
            float(np.clip(self._nominal, self.table.sizes_sorted[0],
                          self.table.sizes_sorted[-1])))
        self._current = int(idx)

    def swap_table(self, table: CharacterizationTable) -> None:
        """Hot-swap a freshly characterized table (online
        re-characterization).  Unlike ``set_target`` this keeps the PI
        state: the integral carries over (network conditions did not reset
        just because the tables did) and only the operating point is
        re-seeded into the new table's size axis."""
        self.table = table
        _, idx = table.query_size(
            float(np.clip(self._nominal, table.sizes_sorted[0],
                          table.sizes_sorted[-1])))
        self._current = int(idx)

    def update(self, latency_sampled: float,
               budget_scale: float = 1.0) -> ControlDecision:
        """One PI step.  ``budget_scale`` caps the nominal operating size
        (fleet admission control's per-tenant degradation knob; 1.0 -- the
        single-tenant case -- is exact, so decisions are unchanged)."""
        cfg = self.config
        nominal = self._nominal * budget_scale
        error = latency_sampled - cfg.latency_target
        act = error > cfg.error_threshold or (
            cfg.relax and error < -cfg.error_threshold)
        if not act:
            # inside the band: hold the current setting
            idx = self._current
            acc = float(self.table.acc_by_setting[idx]) if idx >= 0 else 0.0
            return ControlDecision(idx >= 0, self.table.setting_for(idx) if idx >= 0
                                   else None, idx, acc, nominal, error, False)
        self.integral = float(np.clip(self.integral + error,
                                      -cfg.integral_clip, cfg.integral_clip))
        size = nominal + self.k1 * error + self.k2 * self.integral
        size = float(np.clip(size, self.table.sizes_sorted[0],
                             self.table.sizes_sorted[-1]))
        accuracy, idx = self.table.query_size(size)
        if accuracy >= cfg.accuracy_target and idx >= 0:
            self._current = idx
            return ControlDecision(True, self.table.setting_for(idx), idx,
                                   accuracy, size, error, True)
        # Paper: "If the application requested latency and accuracy are
        # infeasible, the application is notified.  At this point, the
        # application has to decide whether to continue operation with
        # relaxed latency/accuracy requirements, or notify the system
        # operator of failure."  We notify (feasible=False) AND return the
        # best-accuracy setting within the size budget so a subscriber that
        # chooses "continue relaxed" degrades gracefully instead of
        # reverting to raw frames.
        if idx >= 0:
            self._current = idx
        return ControlDecision(False,
                               self.table.setting_for(idx) if idx >= 0 else None,
                               idx, accuracy, size, error, True)

    @property
    def current_setting(self) -> KnobSetting | None:
        return self.table.setting_for(self._current) if self._current >= 0 else None


# =============================================================================
# Controller on the device
# =============================================================================


def _stack_fields(items, fields, cls):
    return cls(*(torch.stack([getattr(x, f) for x in items]) for f in fields))


@dataclasses.dataclass
class ControllerTables:
    """Characterization tables as device tensors (sorted by size).

    ``from_table(capacity=)`` pads the row axis to a fixed size
    (``sizes_sorted`` with +inf so ``searchsorted`` never lands in the
    padding) and records the live row count in ``n_valid``; tables of any
    kept-set size then share one shape, which is what makes online
    re-characterization a buffer write.  Stacked tables carry a leading
    lane axis on every field.
    """
    sizes_sorted: torch.Tensor   # f32[..., capacity], +inf beyond n_valid
    best_acc: torch.Tensor       # f32[..., capacity]
    best_idx: torch.Tensor       # i32[..., capacity], -1 beyond n_valid
    n_valid: torch.Tensor        # i32[...], live rows
    codes: torch.Tensor          # i32[..., capacity, 5] knob codes per
    #                              SETTING index (resolution, colorspace,
    #                              blur, artifact, diff) -- what the fused
    #                              fleet tick gathers so the host rebuilds a
    #                              KnobSetting without touching the table

    FIELDS = ("sizes_sorted", "best_acc", "best_idx", "n_valid", "codes")

    @classmethod
    def from_arrays(cls, sizes_sorted, best_acc, best_idx, *, codes=None,
                    capacity: int | None = None,
                    device: "str | torch.device | None" = None
                    ) -> "ControllerTables":
        """Padded device tables from the sorted host arrays of one table
        (``codes``: knob codes of its settings, [n_settings, 5])."""
        dev = resolve_device(device)
        sizes = np.asarray(sizes_sorted, np.float32)
        n = sizes.shape[0]
        cap = n if capacity is None else int(capacity)
        if cap < n:
            raise ValueError(f"capacity {cap} < {n} characterized settings")
        pad = cap - n
        full = np.zeros((cap, 5), np.int32)
        if codes is not None and len(codes):
            full[:len(codes)] = codes
        return cls(
            torch.as_tensor(np.concatenate(
                [sizes, np.full(pad, np.inf, np.float32)])).to(dev),
            torch.as_tensor(np.concatenate(
                [np.asarray(best_acc, np.float32),
                 np.zeros(pad, np.float32)])).to(dev),
            torch.as_tensor(np.concatenate(
                [np.asarray(best_idx, np.int32),
                 np.full(pad, -1, np.int32)])).to(dev),
            torch.tensor(n, dtype=torch.int32, device=dev),
            torch.as_tensor(full).to(dev))

    @classmethod
    def from_table(cls, table: CharacterizationTable, *,
                   capacity: int | None = None,
                   device: "str | torch.device | None" = None
                   ) -> "ControllerTables":
        a = table.as_arrays()
        codes = [(s.resolution, s.colorspace, s.blur, s.artifact, s.diff)
                 for s in table.settings]
        return cls.from_arrays(a["sizes_sorted"], a["best_acc"],
                               a["best_idx"], codes=codes, capacity=capacity,
                               device=device)


def swap_tables(live: ControllerTables | None,
                fresh: ControllerTables) -> ControllerTables:
    """Hot-swap refreshed tables into a running consumer.

    With matching shapes the fresh values are copied into the live buffers
    (in place: a consumer holding the live tensors sees the new values);
    otherwise (capacity changed) the fresh tables replace them.
    """
    if live is None:
        return fresh
    pairs = [(getattr(live, f), getattr(fresh, f))
             for f in ControllerTables.FIELDS]
    if any(a.shape != b.shape or a.dtype != b.dtype or a.device != b.device
           for a, b in pairs):
        return fresh
    for a, b in pairs:
        a.copy_(b)
    return live


@dataclasses.dataclass
class ControllerState:
    integral: torch.Tensor       # f32[N]
    current_idx: torch.Tensor    # i32[N]
    feasible: torch.Tensor       # bool[N]
    last_error: torch.Tensor     # f32[N]


@dataclasses.dataclass
class ControllerParams:
    """The control-law constants of Algorithm 1 as tensors.

    For one camera every field is a 0-d tensor; ``stack_params`` stacks N
    of them into ``[N]`` lanes.  The gains are precomputed host-side in
    float64 (``k1``/``k2``/``nominal``) exactly as ``LatencyController``
    does, then rounded once to f32, so the fleet step follows the host law.
    """
    latency_target: torch.Tensor    # f32
    accuracy_target: torch.Tensor   # f32
    error_threshold: torch.Tensor   # f32
    k1: torch.Tensor                # f32, -alpha_p / slope (bytes per second)
    k2: torch.Tensor                # f32, -alpha_i / slope
    nominal: torch.Tensor           # f32, Regression^-1(latency_target), bytes
    integral_clip: torch.Tensor     # f32
    relax: torch.Tensor             # bool
    # multi-tenant axes: admission control reallocates the shared wire
    # budget by writing these values
    budget_scale: torch.Tensor      # f32, cap on nominal (1.0 = full budget)
    tier: torch.Tensor              # i32, tenant SLO preemption priority

    FIELDS = ("latency_target", "accuracy_target", "error_threshold", "k1",
              "k2", "nominal", "integral_clip", "relax", "budget_scale",
              "tier")

    @classmethod
    def _make(cls, device, *, relax: bool, tier: int, **f32):
        dev = resolve_device(device)
        vals = {k: torch.tensor(v, dtype=torch.float32, device=dev)
                for k, v in f32.items()}
        return cls(relax=torch.tensor(bool(relax), device=dev),
                   tier=torch.tensor(int(tier), dtype=torch.int32,
                                     device=dev), **vals)

    @classmethod
    def from_scalars(cls, *, latency_target: float, accuracy_target: float,
                     slope: float, intercept: float,
                     error_threshold: float = 0.010, alpha_p: float = 0.8,
                     alpha_i: float = 0.25, integral_clip: float = 1.0,
                     relax: bool = True, budget_scale: float = 1.0,
                     tier: int = 0,
                     device: "str | torch.device | None" = None
                     ) -> "ControllerParams":
        k1 = -alpha_p / max(slope, 1e-12)
        k2 = -alpha_i / max(slope, 1e-12)
        nominal = max(0.0, (latency_target - intercept) / max(slope, 1e-12))
        return cls._make(device, relax=relax, tier=tier,
                         latency_target=latency_target,
                         accuracy_target=accuracy_target,
                         error_threshold=error_threshold, k1=k1, k2=k2,
                         nominal=nominal, integral_clip=integral_clip,
                         budget_scale=budget_scale)

    @classmethod
    def from_controller(cls, host: "LatencyController", *,
                        budget_scale: float = 1.0, tier: int = 0,
                        device: "str | torch.device | None" = None
                        ) -> "ControllerParams":
        """Mirror a live host controller's law (gains/nominal copied from
        the float64 host state, so fleet decisions track host decisions).
        ``budget_scale``/``tier`` carry the owning subscription's admission
        cap and SLO class."""
        cfg = host.config
        return cls._make(device, relax=cfg.relax, tier=tier,
                         latency_target=cfg.latency_target,
                         accuracy_target=cfg.accuracy_target,
                         error_threshold=cfg.error_threshold, k1=host.k1,
                         k2=host.k2, nominal=host._nominal,
                         integral_clip=cfg.integral_clip,
                         budget_scale=budget_scale)


@dataclasses.dataclass
class StepAux:
    """Per-step decision detail (everything ``CamBroker.fetch`` needs to act
    on a decision without re-running the host control law)."""
    idx: torch.Tensor             # i32, chosen setting (-1 = none / raw frames)
    feasible: torch.Tensor        # bool, accuracy floor met at the size budget
    acted: torch.Tensor           # bool, outside the error band this step
    error: torch.Tensor           # f32, latency error (seconds)
    requested_size: torch.Tensor  # f32, PI output (bytes), nominal when holding
    accuracy: torch.Tensor        # f32, best accuracy at the size budget


def _gather_rows(table: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """table[lane, pos[lane]] for [N, cap] tables and [N] positions."""
    return table.gather(-1, pos.long()[:, None])[:, 0]


def _controller_step_core(state: ControllerState, latency: torch.Tensor,
                          tables: ControllerTables,
                          params: ControllerParams, *,
                          best_effort: bool = False
                          ) -> tuple[ControllerState, StepAux]:
    """One PI update for N lanes (every tensor has a leading lane axis).

    ``best_effort`` selects the infeasible-step semantics: False keeps the
    raw contract (knob index -> -1, consumer falls back to raw frames);
    True mirrors the host ``LatencyController`` (serve the best-accuracy
    setting within budget, notify via the feasible flag) -- what the
    fleet-backed broker path uses.
    """
    lat = latency.to(torch.float32)
    error = lat - params.latency_target
    act = (error > params.error_threshold) | (
        params.relax & (error < -params.error_threshold))

    new_integral = torch.clamp(state.integral + error,
                               -params.integral_clip, params.integral_clip)
    integral = torch.where(act, new_integral, state.integral)

    nominal = params.nominal * params.budget_scale
    size = nominal + params.k1 * error + params.k2 * integral
    # clip into the LIVE size range (padding rows carry +inf)
    hi = _gather_rows(tables.sizes_sorted, tables.n_valid - 1)
    size = torch.clamp(size, tables.sizes_sorted[:, 0], hi)
    pos = torch.searchsorted(tables.sizes_sorted, size[:, None],
                             right=True)[:, 0] - 1
    pos = torch.clamp(pos, torch.zeros_like(pos), (tables.n_valid - 1).long())
    accuracy = _gather_rows(tables.best_acc, pos)
    idx = _gather_rows(tables.best_idx, pos)

    ok = accuracy >= params.accuracy_target
    if best_effort:
        # host semantics: _current moves to the best-effort setting even on
        # an infeasible step (idx >= 0 guard matches the host's)
        chosen = torch.where(idx >= 0, idx, state.current_idx)
    else:
        chosen = torch.where(ok, idx, -1)
    new_idx = torch.where(act, chosen, state.current_idx).to(torch.int32)
    new_state = ControllerState(
        integral=integral,
        current_idx=new_idx,
        feasible=torch.where(act, ok, state.feasible),
        last_error=error,
    )
    # decision-shaped feasibility mirrors the host: an acted step reports
    # whether the floor was met, a hold reports whether a live setting is
    # being served (the STATE keeps the sticky flag)
    aux = StepAux(idx=new_idx,
                  feasible=torch.where(act, ok, new_idx >= 0),
                  acted=act, error=error,
                  requested_size=torch.where(act, size, nominal),
                  accuracy=accuracy)
    return new_state, aux


def _lanes(x, fields, cls):
    """One unstacked record as a 1-lane stack."""
    return cls(*(getattr(x, f)[None] for f in fields))


_STATE_FIELDS = ("integral", "current_idx", "feasible", "last_error")


def controller_init(tables: ControllerTables, *,
                    start_idx: int | None = None) -> ControllerState:
    """Initial state of one camera (unstacked tables): the highest-fidelity
    characterized setting, or an explicit ``start_idx``."""
    dev = tables.sizes_sorted.device
    start = (tables.best_idx[tables.n_valid.long() - 1] if start_idx is None
             else torch.tensor(start_idx, device=dev))
    return ControllerState(
        integral=torch.zeros((), dtype=torch.float32, device=dev),
        current_idx=start.to(torch.int32),
        feasible=torch.ones((), dtype=torch.bool, device=dev),
        last_error=torch.zeros((), dtype=torch.float32, device=dev),
    )


def controller_step(state: ControllerState, latency_sampled: float,
                    tables: ControllerTables, *,
                    latency_target: float, accuracy_target: float,
                    slope: float, intercept: float,
                    error_threshold: float = 0.010, alpha_p: float = 0.8,
                    alpha_i: float = 0.25, integral_clip: float = 1.0,
                    relax: bool = True
                    ) -> tuple[ControllerState, torch.Tensor]:
    """One PI update of one camera (unstacked tables and state).  Returns
    (new_state, knob_index): an i32 scalar indexing the characterized
    settings, -1 when no feasible setting exists (the consumer falls back to
    the highest-fidelity payload and flags infeasibility, matching the
    paper's "notify the application" semantics)."""
    dev = tables.sizes_sorted.device
    params = ControllerParams.from_scalars(
        latency_target=latency_target, accuracy_target=accuracy_target,
        slope=slope, intercept=intercept, error_threshold=error_threshold,
        alpha_p=alpha_p, alpha_i=alpha_i, integral_clip=integral_clip,
        relax=relax, device=dev)
    lat = torch.as_tensor(latency_sampled, dtype=torch.float32,
                          device=dev)[None]
    new_state, _ = _controller_step_core(
        _lanes(state, _STATE_FIELDS, ControllerState), lat,
        _lanes(tables, ControllerTables.FIELDS, ControllerTables),
        _lanes(params, ControllerParams.FIELDS, ControllerParams))
    new_state = ControllerState(*(getattr(new_state, f)[0]
                                  for f in _STATE_FIELDS))
    return new_state, new_state.current_idx


# =============================================================================
# Fleet control plane: all cameras of a session in one batched step
# =============================================================================


def stack_tables(tables: "Sequence[ControllerTables]") -> ControllerTables:
    """Stack per-camera tables along a leading fleet axis.

    Every table must share one capacity (``ControllerTables.from_table``
    with a common ``capacity=``); per-camera ``n_valid`` row counts may
    differ freely -- that is what makes a per-camera hot-swap free.
    """
    caps = {t.sizes_sorted.shape[-1] for t in tables}
    if len(caps) != 1:
        raise ValueError(f"stack_tables needs one shared capacity, got {caps}")
    return _stack_fields(tables, ControllerTables.FIELDS, ControllerTables)


def stack_params(params: "Sequence[ControllerParams]") -> ControllerParams:
    """Stack per-camera control-law params along a leading fleet axis."""
    return _stack_fields(params, ControllerParams.FIELDS, ControllerParams)


def fleet_controller_init(tables: ControllerTables, *,
                          start_idx=None) -> ControllerState:
    """Stacked initial state for a fleet of N cameras (tables stacked along
    the leading axis).  ``start_idx`` seeds per-camera operating points
    ([N]); default is each camera's highest-fidelity setting."""
    n = tables.sizes_sorted.shape[0]
    dev = tables.sizes_sorted.device
    if start_idx is None:
        start = _gather_rows(tables.best_idx, tables.n_valid - 1)
    else:
        start = torch.as_tensor(np.asarray(start_idx)).to(dev)
    return ControllerState(
        integral=torch.zeros(n, dtype=torch.float32, device=dev),
        current_idx=start.to(torch.int32),
        feasible=torch.ones(n, dtype=torch.bool, device=dev),
        last_error=torch.zeros(n, dtype=torch.float32, device=dev),
    )


def fleet_controller_step(states: ControllerState, latencies: torch.Tensor,
                          tables: ControllerTables, params: ControllerParams
                          ) -> tuple[ControllerState, StepAux]:
    """One PI update for a WHOLE fleet, batched over the leading camera
    axis, with host (best-effort) infeasible semantics -- the broker's
    contract is the paper's "notify the application AND keep serving the
    best-accuracy setting within budget"."""
    return _controller_step_core(states, latencies, tables, params,
                                 best_effort=True)


def fleet_swap_tables(live: ControllerTables, index,
                      fresh: ControllerTables) -> ControllerTables:
    """Hot-swap a SUBSET of per-camera tables inside a stacked fleet.

    ``index`` is an int (one camera) or int sequence; ``fresh`` is one
    table (capacity matching the stack) or a stack of ``len(index)`` tables.
    Shapes are unchanged.  Capacity mismatch is an error (grow the stack
    deliberately via ``FleetController`` instead)."""
    cap_live = live.sizes_sorted.shape[-1]
    cap_fresh = fresh.sizes_sorted.shape[-1]
    if cap_live != cap_fresh:
        raise ValueError(f"fleet_swap_tables: capacity mismatch "
                         f"(stack {cap_live}, fresh {cap_fresh})")
    idx = torch.as_tensor(np.atleast_1d(np.asarray(index, np.int64)),
                          device=live.sizes_sorted.device)
    out = []
    for f in ControllerTables.FIELDS:
        leaf_live, leaf_fresh = getattr(live, f), getattr(fresh, f)
        if leaf_fresh.ndim == leaf_live.ndim - 1:      # single row
            leaf_fresh = leaf_fresh[None]
        leaf = leaf_live.clone()
        leaf[idx] = leaf_fresh.to(leaf.device)
        out.append(leaf)
    return ControllerTables(*out)


def _set_lane(record, fields, i: int, row):
    """``record`` with lane ``i`` of every field replaced by ``row``'s."""
    out = []
    for f in fields:
        leaf = getattr(record, f).clone()
        leaf[i] = getattr(row, f)
        out.append(leaf)
    return type(record)(*out)


# =============================================================================
# Fused fleet tick: drift + control + decision application in one call
# =============================================================================


@dataclasses.dataclass
class FusedTickAux:
    """Everything the host needs from one fused tick: the per-lane
    controller decision detail, the chosen setting's knob codes (so
    ``KnobSetting`` is rebuilt without touching the Python table), and the
    drift fire-set."""
    step: StepAux              # per-lane controller decision detail
    codes: torch.Tensor        # i32[N, 5], chosen setting's knob codes
    #                            (-1 rows when no live setting is served)
    fired: torch.Tensor        # bool[N], drift lane fired this tick
    score: torch.Tensor        # f32[N], drift windowed score

    def to_host(self) -> "FusedTickAux":
        """The same record with NumPy fields, in two device->host copies
        (one integer block, one float block)."""
        s = self.step
        ints = torch.cat([s.idx[:, None].to(torch.int32),
                          s.feasible[:, None].to(torch.int32),
                          s.acted[:, None].to(torch.int32),
                          self.fired[:, None].to(torch.int32),
                          self.codes.to(torch.int32)], dim=1).cpu().numpy()
        flts = torch.stack([s.error, s.requested_size, s.accuracy,
                            self.score], dim=1).cpu().numpy()
        step = StepAux(idx=ints[:, 0], feasible=ints[:, 1].astype(bool),
                       acted=ints[:, 2].astype(bool), error=flts[:, 0],
                       requested_size=flts[:, 1], accuracy=flts[:, 2])
        return FusedTickAux(step=step, codes=ints[:, 4:],
                            fired=ints[:, 3].astype(bool), score=flts[:, 3])


def fused_fleet_tick(ctrl_states: ControllerState, drift_states: DriftState,
                     latencies: torch.Tensor, drift_errs: torch.Tensor,
                     drift_valid: torch.Tensor, tables: ControllerTables,
                     params: ControllerParams, drift_params: DriftParams
                     ) -> tuple[ControllerState, DriftState, FusedTickAux]:
    """The whole fleet's per-poll control plane in one call: drift tick +
    PI step + decision->knob-code application, batched over the leading
    camera axis.  Built on the same cores as the unfused path
    (``drift_update`` then ``fleet_controller_step``), so fused decisions
    equal the separate steps lane by lane.  The drift observation is the
    residual the host aggregated at the END of the previous poll; a fire is
    reported in the aux for the host to act on (recharacterize + table swap
    + re-tick)."""
    new_drift, fired, score = drift_update(drift_states, drift_errs,
                                           drift_valid, drift_params)
    new_ctrl, aux = fleet_controller_step(ctrl_states, latencies, tables,
                                          params)
    cap = tables.codes.shape[1]
    safe = torch.clamp(aux.idx, 0, cap - 1).long()
    codes = tables.codes.gather(1, safe[:, None, None].expand(-1, 1, 5))[:, 0]
    codes = torch.where(aux.idx[:, None] >= 0, codes, -1)
    return new_ctrl, new_drift, FusedTickAux(step=aux, codes=codes,
                                             fired=fired, score=score)


class FleetTickResult(Mapping):
    """Lazy ``camera_id -> ControlDecision`` view over one fused tick.

    ``poll_subscription`` only materializes decisions for the cameras it
    actually fetches this poll (O(fetched), not O(N)); iterating the
    mapping (the dict-compat ``FleetController.decide`` path) materializes
    every lane.  ``setting`` is rebuilt from the tick's gathered knob codes
    -- ``KnobSetting`` is a frozen value type, so this equals the host
    table's ``setting_for(idx)`` bit for bit.
    """

    __slots__ = ("fired_cams", "_cam_ids", "_lane", "_aux", "_cache")

    def __init__(self, cam_ids, lane_map, aux_host, fired_cams):
        self._cam_ids = cam_ids
        self._lane = lane_map
        self._aux = aux_host            # FusedTickAux.to_host() record
        self._cache: dict[int, ControlDecision] = {}
        self.fired_cams = fired_cams    # drift fire-set, lane order

    def _materialize(self, i: int) -> ControlDecision:
        d = self._cache.get(i)
        if d is None:
            a = self._aux
            idx = int(a.step.idx[i])
            setting = (KnobSetting(*(int(c) for c in a.codes[i]))
                       if idx >= 0 else None)
            d = ControlDecision(
                feasible=bool(a.step.feasible[i]), setting=setting,
                setting_index=idx,
                predicted_accuracy=float(a.step.accuracy[i]),
                requested_size=float(a.step.requested_size[i]),
                error=float(a.step.error[i]), acted=bool(a.step.acted[i]))
            self._cache[i] = d
        return d

    def get(self, cid, default=None):
        i = self._lane.get(cid)
        return default if i is None else self._materialize(i)

    def __getitem__(self, cid) -> ControlDecision:
        i = self._lane.get(cid)
        if i is None:
            raise KeyError(cid)
        return self._materialize(i)

    def __iter__(self):
        return iter(self._cam_ids)

    def __len__(self) -> int:
        return len(self._cam_ids)


class FleetController:
    """Host-side orchestrator: N per-camera control planes as ONE
    ``fused_fleet_tick`` (PI step + drift tick + decision application) on
    ``device`` (default ``"cuda"``).

    Built over live ``CamBroker``-like objects (anything carrying
    ``camera_id``, ``controller``, ``table_version``, ``qos_version``); the
    brokers' host controllers stay the source of truth for tables, targets
    and law constants, while the PI *state* (integral, operating point)
    lives here on the device.  ``sync()`` diffs the brokers' version
    counters and hot-swaps changed lanes (tables via ``fleet_swap_tables``,
    targets via a params-row write) without changing any shape; only a
    table that outgrows the shared capacity rebuilds the stack.
    """

    HISTORY_LIMIT = 4096

    def __init__(self, cams, *, capacity: int | None = None,
                 record_history: bool = False, tier: int = 0,
                 device: "str | torch.device | None" = None):
        cams = list(cams)
        self.device = resolve_device(device)
        # multi-tenant axes: the owning subscription's SLO class rides as a
        # per-lane i32 field, and admission control caps the fleet's wire
        # budget by writing the per-lane budget_scale (set_budget_scale)
        self._tier = int(tier)
        self._budget_scale = 1.0
        if not cams:
            raise ValueError("FleetController needs at least one camera")
        for cam in cams:
            if cam.controller is None:
                raise ValueError(
                    f"camera {cam.camera_id!r} has no controller installed")
        self._cams = cams
        self.cam_ids = [c.camera_id for c in cams]
        self.lane_of = {cid: i for i, cid in enumerate(self.cam_ids)}
        need = max(len(c.controller.table.settings) for c in cams)
        self.capacity = max(need, capacity or 0)
        self.record_history = record_history
        self.history: "deque" = deque(maxlen=self.HISTORY_LIMIT)
        self.n_lanes = len(cams)
        # drift lanes: a bound DriftMonitor's state rides in the fused tick;
        # without one, a window-1 placeholder holds forever (valid=False,
        # count pinned at 0 < min_samples, so it can never fire)
        self._drift = None
        self._drift_state = drift_init(self.n_lanes, 1, device=self.device)
        self._drift_params = DriftParams.from_config(
            DriftConfig(window=1), self.n_lanes, device=self.device)
        self._pre_state = None
        # the (lanes, capacity) layouts the tick has run on: see cache_size
        self._layouts: set[tuple[int, ...]] = set()
        self._build_stack()

    # -- stack assembly ------------------------------------------------------
    def _build_stack(self) -> None:
        dev = self.device
        self.tables = stack_tables([
            ControllerTables.from_table(c.controller.table,
                                        capacity=self.capacity, device=dev)
            for c in self._cams])
        self.params = stack_params([
            ControllerParams.from_controller(c.controller,
                                             budget_scale=self._budget_scale,
                                             tier=self._tier, device=dev)
            for c in self._cams])
        start = np.asarray([c.controller._current for c in self._cams],
                           np.int32)
        state = fleet_controller_init(self.tables, start_idx=start)
        self.state = ControllerState(
            integral=torch.tensor([c.controller.integral for c in self._cams],
                                  dtype=torch.float32, device=dev),
            current_idx=state.current_idx,
            feasible=state.feasible,
            last_error=state.last_error)
        self._table_versions = [c.table_version for c in self._cams]
        self._qos_versions = [c.qos_version for c in self._cams]
        self._targets = np.asarray(
            [c.controller.config.latency_target for c in self._cams],
            np.float32)

    def attach_drift(self, monitor) -> None:
        """Fuse a ``DriftMonitor``'s per-poll tick into this fleet's tick.
        The monitor must share this fleet's lane order and device; its
        state/params ride as tick inputs, and post-tick lanes flow back via
        ``monitor.absorb_fused``."""
        if list(monitor.cam_ids) != self.cam_ids:
            raise ValueError("drift monitor lane order != fleet lane order")
        if monitor.device != self.device:
            raise ValueError(f"drift monitor on {monitor.device}, fleet on "
                             f"{self.device}")
        monitor.bind_fused(self)
        self._drift = monitor
        self._drift_params = monitor.params

    def _drift_inputs(self, errs, valid):
        """(state, errs, valid) for the tick."""
        if self._drift is None:
            return (self._drift_state,
                    np.zeros(self.n_lanes, np.float32),
                    np.zeros(self.n_lanes, bool))
        if errs is None:
            errs = np.zeros(self.n_lanes, np.float32)
            valid = np.zeros(self.n_lanes, bool)
        return self._drift.state, errs, valid

    def cache_size(self) -> int:
        """How many table layouts (lanes x capacity) the fused tick has run
        on: 0 before the first tick, 1 while every swap, retarget and
        budget write kept the shapes, one more for each rebuild to another
        capacity.  The counterpart of the JAX tick's compiled-variant
        count, which the same events move (this port compiles nothing)."""
        return len(self._layouts)

    @property
    def budget_scale(self) -> float:
        """The admission-control cap currently applied to every lane."""
        return self._budget_scale

    def set_budget_scale(self, scale: float) -> None:
        """Fleet-level wire-budget reallocation (admission control's
        degradation knob): cap every lane's nominal operating size at
        ``scale`` x the regression nominal.  A value write -- shapes don't
        change."""
        s = float(np.float32(scale))
        if not 0.0 < s <= 1.0:
            raise ValueError(f"budget_scale must be in (0, 1], got {scale}")
        if s == self._budget_scale:
            return
        self._budget_scale = s
        self.params.budget_scale = torch.full_like(self.params.budget_scale,
                                                   s)

    def __len__(self) -> int:
        return len(self._cams)

    def export_lane(self, camera_id: str) -> tuple[float, int]:
        """Write one lane's live PI state back into the camera's host
        controller and return it.

        In fleet mode the stacked lanes -- not the host fields -- own the
        live integral/operating point, so a camera leaving this fleet must
        carry its lane state out through the host controller: a receiving
        fleet's ``_build_stack`` seeds from exactly these fields."""
        i = self.lane_of[camera_id]
        ctl = self._cams[i].controller
        integral = float(self.state.integral[i])
        current = int(self.state.current_idx[i])
        ctl.integral = integral
        ctl._current = current
        return integral, current

    # -- live reconfiguration ------------------------------------------------
    def sync(self) -> tuple[list[int], list[int]]:
        """Fold per-camera retargets / table refreshes into the stack.

        Called at the top of every tick; O(N) integer compares when nothing
        changed.  A retarget rewrites the camera's params lane and mirrors
        the host's state reset (integral, re-seeded operating point); a
        table refresh hot-swaps the camera's table lane and re-seeds the
        operating point while the integral carries over -- exactly the
        host-side ``set_target`` / ``swap_table`` contracts.

        Returns ``(table_swapped, retargeted)`` lane indices -- the exact
        set of lanes rewritten this sync (empty when nothing changed).
        """
        table_swapped = [cam.table_version != self._table_versions[i]
                         for i, cam in enumerate(self._cams)]
        retargeted = [cam.qos_version != self._qos_versions[i]
                      for i, cam in enumerate(self._cams)]
        need = max(len(c.controller.table.settings) for c in self._cams)
        if need > self.capacity:
            # at least one refreshed table outgrew the shared padding: grow
            # to the whole fleet's requirement at once and rebuild the
            # stack.  The fleet lanes, not the (stale in fleet mode) host
            # fields, own the live PI state, so it is carried across the
            # rebuild; changed lanes re-seed below.
            self.capacity = need
            state = self.state
            self._build_stack()
            self.state = state
        else:
            for i, cam in enumerate(self._cams):
                ctl = cam.controller
                if table_swapped[i]:
                    fresh = ControllerTables.from_table(
                        ctl.table, capacity=self.capacity, device=self.device)
                    self.tables = fleet_swap_tables(self.tables, i, fresh)
                    self._table_versions[i] = cam.table_version
                if retargeted[i]:
                    self.params = _set_lane(
                        self.params, ControllerParams.FIELDS, i,
                        ControllerParams.from_controller(
                            ctl, budget_scale=self._budget_scale,
                            tier=self._tier, device=self.device))
                    self._qos_versions[i] = cam.qos_version
                    self._targets[i] = ctl.config.latency_target
        for i, cam in enumerate(self._cams):
            if not (table_swapped[i] or retargeted[i]):
                continue
            ctl = cam.controller
            # mirror the host contracts: both paths re-seed the operating
            # point; only a RETARGET resets the integral (``set_target``)
            # -- a bare table swap carries it (``swap_table``: the network
            # didn't reset with the tables)
            integral = self.state.integral
            if retargeted[i]:
                integral = integral.clone()
                integral[i] = ctl.integral
            current = self.state.current_idx.clone()
            current[i] = ctl._current
            self.state = ControllerState(
                integral=integral, current_idx=current,
                feasible=self.state.feasible,
                last_error=self.state.last_error)
        return ([i for i, s in enumerate(table_swapped) if s],
                [i for i, r in enumerate(retargeted) if r])

    # -- the fused fleet tick ------------------------------------------------
    def _dispatch(self, lat_eff, drift_errs, drift_valid):
        """Run the one fused tick and absorb its state."""
        dstate, derrs, dvalid = self._drift_inputs(drift_errs, drift_valid)
        dev = self.device
        self._layouts.add(tuple(self.tables.sizes_sorted.shape))
        new_ctrl, new_drift, aux = fused_fleet_tick(
            self.state, dstate, torch.as_tensor(lat_eff).to(dev),
            torch.as_tensor(np.asarray(derrs, np.float32)).to(dev),
            torch.as_tensor(np.asarray(dvalid, bool)).to(dev),
            self.tables, self.params, self._drift_params)
        self.state = new_ctrl
        aux = aux.to_host()
        fired_cams: list[str] = []
        if self._drift is not None:
            fired_cams = self._drift.absorb_fused(new_drift, aux.fired,
                                                  aux.score)
        return aux, fired_cams

    # mezlint: poll-path
    def tick(self, lat, valid, drift_errs=None, drift_valid=None, *,
             record: bool = True) -> FleetTickResult:
        """One fused control+drift tick for the whole fleet.

        ``lat``/``valid`` are lane-ordered arrays: observed p95 latency
        (seconds) and whether the lane actually has samples this poll.
        Invalid lanes are fed their own latency target (zero error ->
        in-band hold, state untouched), so one tick still covers every
        camera.  ``drift_errs``/``drift_valid`` feed the fused drift tick
        when a monitor is attached (None -> no drift observation this
        poll).

        Returns a lazy :class:`FleetTickResult`; its ``fired_cams`` lists
        the drift lanes that crossed ``hi`` this tick, in lane order.  The
        host recharacterizes those, then calls :meth:`retick` to re-decide
        against the refreshed tables.
        """
        self.sync()
        lat = np.asarray(lat, np.float32)
        valid = np.asarray(valid, bool)
        lat_eff = np.where(valid, lat, self._targets)
        self._pre_state = self.state
        aux, fired_cams = self._dispatch(lat_eff, drift_errs, drift_valid)
        self._last_lat_eff = lat_eff
        if record and self.record_history:
            self.history.append({
                "lat": lat_eff.tolist(), "fed": valid.tolist(),
                "idx": aux.step.idx.tolist(),
                "acted": aux.step.acted.tolist(),
                "feasible": aux.step.feasible.tolist(),
                "table_versions": list(self._table_versions),
            })
        return FleetTickResult(self.cam_ids, self.lane_of, aux, fired_cams)

    def retick(self) -> FleetTickResult:
        """Re-decide the tick just taken, against freshly swapped tables.

        Restores the pre-tick controller state, folds the host-side
        refreshes in via ``sync()`` (which re-seeds the swapped lanes,
        mirroring the unfused refresh-before-decide ordering), and re-runs
        the tick with a no-op drift observation: fired lanes were cleared
        and disarmed by the first tick (cannot refire on an empty window)
        and rearmed lanes are already armed, so the drift state is provably
        unchanged.
        """
        if self._pre_state is None:
            raise RuntimeError("retick() without a preceding tick()")
        self.state = self._pre_state
        self.sync()
        aux, _ = self._dispatch(self._last_lat_eff, None, None)
        if self.record_history and self.history:
            row = self.history[-1]
            row["idx"] = aux.step.idx.tolist()
            row["acted"] = aux.step.acted.tolist()
            row["feasible"] = aux.step.feasible.tolist()
            row["table_versions"] = list(self._table_versions)
        return FleetTickResult(self.cam_ids, self.lane_of, aux, [])

    def decide(self, feedback) -> dict[str, ControlDecision]:
        """Dict-compat wrapper over :meth:`tick`.

        ``feedback`` maps camera_id -> observed p95 latency (seconds), or
        None for cameras with no samples yet.  Returns one host-shaped
        ``ControlDecision`` per camera (every lane materialized).
        """
        n = self.n_lanes
        lat = np.zeros(n, np.float32)
        valid = np.zeros(n, bool)
        for i, cid in enumerate(self.cam_ids):
            f = feedback.get(cid)
            if f is not None:
                valid[i] = True
                lat[i] = f
        return dict(self.tick(lat, valid))

"""Mez core on PyTorch: brokers, log, characterization and the latency
controller (paper Sections 2-4)."""

from repro_torch.core.api import (AdmissionRejected, BoundedEventBuffer,
                                  BrokerDown, CameraQosResult, DeliveredFrame,
                                  EventKind, FrameBatch, LatencyBreakdown,
                                  MessagingSystem, QosBounds, QosUpdate,
                                  RPCTimeout, SessionEvent,
                                  SessionedMessagingSystem, SloClass,
                                  SLO_CLASSES, Status, SubscribeSpec,
                                  SubscriptionOptions, SubscriptionState,
                                  resolve_slo)
from repro_torch.core.broker import CamBroker, EdgeBroker, MezSystem
from repro_torch.core.channel import (ChannelConfig, WirelessChannel,
                                      calibrated_channel)
from repro_torch.core.characterization import (CharacterizationTable,
                                               LatencyRegression, characterize,
                                               fit_latency_regression)
from repro_torch.core.controller import (ControllerConfig, ControllerState,
                                         ControllerTables, FleetController,
                                         LatencyController, controller_init,
                                         controller_step)
from repro_torch.core.drift import (DriftConfig, DriftMonitor, DriftState,
                                    drift_init, drift_update)
from repro_torch.core.grid_engine import (GridCharacterization, WireSizeProxy,
                                          refresh_tables, run_grid)
from repro_torch.core.knobs import (KnobSetting, TransformMemo, apply_knobs,
                                    enumerate_settings, wire_size)
from repro_torch.core.log import (FrameLog, HostLog, LogSegmentStore,
                                  frame_log_append, frame_log_init,
                                  frame_log_point_query,
                                  frame_log_range_query)
from repro_torch.core.mqtt_bridge import MqttBridge, MqttMessage
from repro_torch.core.session import MezClient, Session, Subscription

__all__ = [
    "BrokerDown", "DeliveredFrame", "LatencyBreakdown", "MessagingSystem",
    "RPCTimeout", "Status", "SubscribeSpec", "ChannelConfig", "WirelessChannel",
    "calibrated_channel", "CharacterizationTable", "LatencyRegression",
    "characterize", "fit_latency_regression", "ControllerConfig",
    "ControllerState", "ControllerTables", "LatencyController",
    "FleetController", "controller_init", "controller_step", "KnobSetting",
    "apply_knobs", "enumerate_settings", "wire_size", "HostLog",
    "LogSegmentStore", "EventKind", "FrameBatch", "QosUpdate", "SessionEvent",
    "SessionedMessagingSystem", "SubscriptionState", "MezClient", "Session",
    "Subscription", "GridCharacterization", "WireSizeProxy", "run_grid",
    "refresh_tables", "TransformMemo", "DriftConfig", "DriftMonitor",
    "DriftState", "drift_init", "drift_update", "AdmissionRejected",
    "CameraQosResult", "QosBounds", "SloClass", "SLO_CLASSES",
    "SubscriptionOptions", "resolve_slo", "BoundedEventBuffer", "CamBroker",
    "EdgeBroker", "MezSystem", "FrameLog", "frame_log_init",
    "frame_log_append", "frame_log_point_query", "frame_log_range_query",
    "MqttBridge", "MqttMessage",
]

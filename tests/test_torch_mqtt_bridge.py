"""The port's MQTT ingress bridge (``repro_torch.core.mqtt_bridge``): the
topic scheme, QoS 0 and 1 under a seeded lossy hop, and ingress credits,
each against the JAX package's bridge on the same frames and seeds.  The
systems run on the CPU (``device="cpu"``)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.mqtt_bridge as JM  # noqa: E402
from benchmarks.common import synthetic_controller_table  # noqa: E402
from repro.core.broker import MezSystem as JaxMezSystem  # noqa: E402
from repro.core.channel import calibrated_channel as jax_channel  # noqa: E402
from repro.core.characterization import \
    fit_latency_regression as jax_fit  # noqa: E402
import repro_torch.core.mqtt_bridge as TM  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import MqttBridge, MqttMessage  # noqa: E402
from repro_torch.core.broker import MezSystem  # noqa: E402
from repro_torch.core.channel import calibrated_channel  # noqa: E402
from repro_torch.core.characterization import fit_latency_regression  # noqa: E402
from repro_torch.data.camera import CameraConfig, SyntheticCamera  # noqa: E402


def bridge_system(jax_side, *, n_cams=2, seed=3):
    """tests/test_gauntlet.py's fleet of registered, empty-log cameras, in
    either package: the bridge is the ingress path."""
    jt = synthetic_controller_table()
    if jax_side:
        ch, fit, table = jax_channel(seed=seed), jax_fit, jt
        system = JaxMezSystem(ch)
    else:
        ch = calibrated_channel(seed=seed)
        system, fit = MezSystem(ch, device="cpu"), fit_latency_regression
        table = convert.table_from_numpy(
            settings=[dataclasses.astuple(s) for s in jt.settings],
            sizes_sorted=jt.sizes_sorted, best_acc=jt.best_acc,
            best_idx=jt.best_idx, acc_by_setting=jt.acc_by_setting,
            size_by_setting=jt.size_by_setting)
    sizes = np.linspace(table.sizes_sorted[0], table.sizes_sorted[-1], 12)
    reg = fit(sizes, ch.regression_points(sizes, n=n_cams))
    for i in range(n_cams):
        cam = system.add_camera(f"cam{i}")
        cam.background = SyntheticCamera(CameraConfig(
            camera_id=f"cam{i}", dynamics="medium", seed=7)).background
        cam.set_target(0.100, 0.90, table, reg)
    return system


def frames_for(camera_id, n):
    return list(SyntheticCamera(CameraConfig(
        camera_id=camera_id, dynamics="medium", seed=7)).stream(n))


def messages(msgs):
    """What a subscriber sees: (topic, timestamp, qos, mid, dup, payload)."""
    return [(m.topic, m.timestamp, m.qos, m.mid, m.dup,
             None if m.payload is None else np.asarray(m.payload).tobytes())
            for m in msgs]


TOPICS = ["mez/cam3/frames", "mez/cam0", "mez/cam0/control",
          "other/cam0/frames", "mez//frames", "mez/+/frames", "mez/#"]
FILTERS = ["mez/+/frames", "mez/#", "#", "mez/cam0/frames", "mez/+",
           "mez/cam1/frames", "mez/+/control"]


def test_topic_helpers_match_jax():
    assert TM.topic_for("cam3") == JM.topic_for("cam3") == "mez/cam3/frames"
    assert TM.parse_topic("mez/cam3/frames") == "cam3"
    for topic in TOPICS:
        assert TM.parse_topic(topic) == JM.parse_topic(topic), topic
    for flt in FILTERS:
        for topic in TOPICS + ["mez/cam0/frames"]:
            assert TM.topic_matches(flt, topic) == \
                JM.topic_matches(flt, topic), (flt, topic)
    assert (TM.MQTT_ERR_AGAIN, TM.MQTT_ERR_SUCCESS, TM.MQTT_ERR_NO_CONN,
            TM.MQTT_ERR_QUEUE_SIZE) == (JM.MQTT_ERR_AGAIN,
                                        JM.MQTT_ERR_SUCCESS,
                                        JM.MQTT_ERR_NO_CONN,
                                        JM.MQTT_ERR_QUEUE_SIZE)
    assert TM.MqttBridge is MqttBridge and TM.MqttMessage is MqttMessage


def round_trip(jax_side, qos):
    """30 frames a camera over a hop losing 35% of transmissions, pumped
    out through one wildcard subscriber.  Eight retries a publish: at 35%
    loss a QoS 1 publish gives up with odds 0.35 ** 9 (the default four
    gives up one of these 60 frames)."""
    system = bridge_system(jax_side)
    bridge = (JM if jax_side else TM).MqttBridge(system, loss_rate=0.35,
                                                 seed=11, max_retries=8)
    acked, infos = [], []
    bridge.on_publish = lambda c, u, mid: acked.append(mid)
    rc, _ = bridge.subscribe("mez/+/frames")
    assert rc == TM.MQTT_ERR_SUCCESS
    msgs = []
    for cid in ("cam0", "cam1"):
        for ts, frame, _ in frames_for(cid, 30):
            info = bridge.publish(TM.topic_for(cid), frame, qos=qos,
                                  timestamp=ts)
            infos.append((cid, float(ts), info.rc, info.attempts,
                          info.is_published()))
        msgs.extend(bridge.pump(max_frames=64))
    return dict(stats=bridge.stats(), infos=infos, acked=acked,
                msgs=messages(msgs),
                logs={c: len(system.cams[c].log) for c in ("cam0", "cam1")},
                credits={c: bridge.credits(c) for c in ("cam0", "cam1")})


@pytest.mark.parametrize("qos", [0, 1])
def test_round_trip_under_loss_matches_jax(qos):
    """Both QoS levels on the same seeded lossy hop give the JAX bridge's
    return codes, transmissions, counters and delivered messages.  QoS 1
    lands and delivers every frame exactly once (DUPs deduped by the log);
    QoS 0 drops what the hop eats and never retries."""
    got, want = round_trip(False, qos), round_trip(True, qos)
    assert got == want
    stats = got["stats"]
    delivered = [(m[0], m[1]) for m in got["msgs"]]
    assert len(delivered) == len(set(delivered)) == stats["published"]
    if qos == 1:
        assert stats["published"] == 60 and stats["give_ups"] == 0
        assert stats["retries"] > 0 and stats["duplicates"] > 0
        assert sorted(delivered) == sorted(
            (TM.topic_for(cid), ts) for cid, ts, *_ in got["infos"])
        assert got["logs"] == {"cam0": 30, "cam1": 30}
    else:
        assert stats["retries"] == 0
        assert stats["published"] + stats["dropped_qos0"] == 60
        assert stats["dropped_qos0"] > 0


def credits_run(jax_side):
    """A two-credit window: QoS 0 sheds and QoS 1 parks when it is empty;
    delivery returns credits, which unpark the parked publish."""
    system = bridge_system(jax_side, n_cams=1)
    bridge = (JM if jax_side else TM).MqttBridge(system, ingress_credits=2)
    bridge.subscribe("mez/cam0/frames")
    stream = frames_for("cam0", 5)
    out = []
    for i, (ts, frame, _) in enumerate(stream[:4]):
        info = bridge.publish(TM.topic_for("cam0"), frame,
                              qos=1 if i == 3 else 0, timestamp=ts)
        out.append((info.rc, info.queued, info.is_published(),
                    bridge.credits("cam0")))
    out.append(messages(bridge.pump()))
    out.append((bridge.credits("cam0"), messages(bridge.pump()),
                bridge.stats()))
    return out


def test_ingress_credits_match_jax():
    got = credits_run(False)
    assert got == credits_run(True)
    assert [o[0] for o in got[:4]] == [TM.MQTT_ERR_SUCCESS] * 2 + [
        TM.MQTT_ERR_QUEUE_SIZE, TM.MQTT_ERR_SUCCESS]
    assert got[3][1] and not got[3][2]          # parked, not yet published
    assert len(got[4]) == 3                     # two, then the unparked one
    credits, again, stats = got[5]
    assert again == [] and stats["queued_now"] == 0
    assert credits == 2


def test_crashed_camera_parks_qos1_until_recovery():
    """QoS 1 against a crashed camera parks; recovery flushes in publish
    order, each frame paying and returning its credit once."""
    system = bridge_system(False, n_cams=1)
    bridge = TM.MqttBridge(system)
    bridge.subscribe("mez/cam0/frames")
    stream = frames_for("cam0", 5)
    system.cams["cam0"].crash()
    parked = [bridge.publish(TM.topic_for("cam0"), frame, qos=1,
                             timestamp=ts) for ts, frame, _ in stream]
    assert all(info.queued for info in parked)
    bridge.grant("cam0", 0)                      # still down: re-parks
    assert bridge.stats()["queued_total"] == 5
    assert len(system.cams["cam0"].log) == 0
    system.cams["cam0"].recover()
    bridge.grant("cam0", 0)
    assert all(info.is_published() for info in parked)
    assert [t for t, _ in system.cams["cam0"].log.tail(8)] == \
        [ts for ts, _, _ in stream]
    assert bridge.credits("cam0") == bridge.ingress_credits - 5
    assert len(bridge.pump()) == 5
    assert bridge.credits("cam0") == bridge.ingress_credits

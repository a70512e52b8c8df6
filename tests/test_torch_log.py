"""The port's device frame ring (``repro_torch.core.log.FrameLog`` and the
``frame_log_*`` functions) against the JAX package's ``repro.core.log``.

Tolerance: none.  Both keep float32 timestamps, int32 counters and the
payload's own dtype, and compute no arithmetic a rounding could move, so
every field and every query result is held exactly equal: ``found``,
``ts``, frames, ``valid``, ``head``, ``count``, ``last_ts`` and
``rejects``.

Inputs: one scripted sequence (capacity 8, uint8 frames ``(4, 6, 3)`` drawn
from a seeded NumPy generator, 20 appends at float64 timestamps ``i/10``
with one out of order and one equal to its predecessor, so the ring wraps
twice and refuses two) fed to both packages.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.core import log as TL  # noqa: E402

CAP, SHAPE = 8, (4, 6, 3)


def script() -> list[tuple[float, np.ndarray]]:
    rng = np.random.default_rng(0)
    ts = [i / 10 for i in range(20)]
    ts[7] = 0.3              # out of order
    ts[12] = ts[11]          # equal to the newest: refused too
    return [(t, rng.integers(0, 256, SHAPE, dtype=np.uint8)) for t in ts]


def fields(log) -> list[np.ndarray]:
    return [np.asarray(x) for x in (log.timestamps, log.payload, log.head,
                                    log.count, log.last_ts, log.rejects)]


@pytest.fixture
def jl():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import log as JL
    return jnp, JL


def build_both(jl, steps):
    jnp, JL = jl
    j = JL.frame_log_init(CAP, SHAPE)
    t = TL.frame_log_init(CAP, SHAPE, device="cpu")
    for ts, f in steps:
        j = JL.frame_log_append(j, ts, jnp.asarray(f))
        t = TL.frame_log_append(t, ts, torch.from_numpy(f))
    return j, t


def assert_equal(got, want):
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n_appends", [0, 3, 8, 13, 20])
def test_state_matches_jax_after_each_prefix(jl, n_appends):
    j, t = build_both(jl, script()[:n_appends])
    assert_equal(fields(t), fields(j))


POINTS = [-1.0, 0.0, 0.05, 0.3, 0.35, 0.9, 1.0, 1.25, 1.9, 1.95, 100.0,
          float("inf"), float("-inf")]


@pytest.mark.parametrize("n_appends", [3, 20])
def test_point_queries_match_jax(jl, n_appends):
    """Before the oldest live entry (a miss), at, between and after
    entries, on a partly filled and on a wrapped ring."""
    _, JL = jl
    j, t = build_both(jl, script()[:n_appends])
    for q in POINTS:
        assert_equal(TL.frame_log_point_query(t, q),
                     JL.frame_log_point_query(j, q))


@pytest.mark.parametrize("max_results", range(1, CAP + 3))
@pytest.mark.parametrize("window", [(0.0, 100.0), (1.25, 1.65), (1.3, 1.3),
                                    (-5.0, 0.5), (1.95, 3.0), (1.7, 1.2)])
def test_range_queries_match_jax(jl, window, max_results):
    _, JL = jl
    j, t = build_both(jl, script())
    assert_equal(TL.frame_log_range_query(t, *window, max_results),
                 JL.frame_log_range_query(j, *window, max_results))


def test_float32_timestamps_before_the_comparison(jl):
    """0.1 + 0.2 and 0.3 differ in float64 and agree in float32: the second
    append is refused in both packages."""
    jnp, JL = jl
    j = JL.frame_log_init(4, (1,))
    t = TL.frame_log_init(4, (1,), device="cpu")
    for ts in (0.1 + 0.2, 0.3):
        j = JL.frame_log_append(j, ts, jnp.ones((1,), jnp.uint8))
        t = TL.frame_log_append(t, ts, torch.ones(1, dtype=torch.uint8))
    assert int(t.rejects) == int(j.rejects) == 1
    assert_equal(fields(t), fields(j))


def test_wrapped_jax_ring_carried_across(jl):
    """A wrapped JAX ring crosses by ``convert.frame_log_from_numpy``; both
    answer the same queries, and both take the same next appends."""
    jnp, JL = jl
    steps = script()
    j, _ = build_both(jl, steps)
    t = convert.frame_log_from_numpy(**{
        k: np.asarray(getattr(j, k)) for k in (
            "timestamps", "payload", "head", "count", "last_ts", "rejects")},
        device="cpu")
    assert_equal(fields(t), fields(j))
    for q in POINTS:
        assert_equal(TL.frame_log_point_query(t, q),
                     JL.frame_log_point_query(j, q))
    rng = np.random.default_rng(1)
    for ts in (5.0, 4.0, 6.5):
        f = rng.integers(0, 256, SHAPE, dtype=np.uint8)
        j = JL.frame_log_append(j, ts, jnp.asarray(f))
        t = TL.frame_log_append(t, ts, f)
    assert_equal(fields(t), fields(j))
    assert_equal(TL.frame_log_range_query(t, 0.0, 10.0, CAP),
                 JL.frame_log_range_query(j, 0.0, 10.0, CAP))


def test_append_writes_in_place():
    """An append writes the one slot of the ring it was given: no tensor of
    the log is reallocated, taken or refused."""
    log = TL.frame_log_init(CAP, SHAPE, device="cpu")
    ptrs = [x.data_ptr() for x in (log.timestamps, log.payload, log.head,
                                   log.count, log.last_ts, log.rejects)]
    for ts, f in script():
        assert TL.frame_log_append(log, ts, f) is log
    assert [x.data_ptr() for x in (log.timestamps, log.payload, log.head,
                                   log.count, log.last_ts,
                                   log.rejects)] == ptrs
    assert int(log.rejects) == 2 and int(log.count) == CAP


# -- counterparts of tests/test_log.py::TestFrameLog -----------------------


def test_append_query():
    log = TL.frame_log_init(8, (2, 2), device="cpu")
    for i in range(5):
        TL.frame_log_append(log, float(i),
                            torch.full((2, 2), i, dtype=torch.uint8))
    found, ts, frame = TL.frame_log_point_query(log, 3.5)
    assert bool(found) and float(ts) == 3.0
    assert int(frame[0, 0]) == 3


def test_out_of_order_rejected():
    log = TL.frame_log_init(8, (2, 2), device="cpu")
    TL.frame_log_append(log, 5.0, torch.ones((2, 2), dtype=torch.uint8))
    TL.frame_log_append(log, 4.0, torch.ones((2, 2), dtype=torch.uint8))
    assert int(log.rejects) == 1
    assert int(log.count) == 1


def test_wraparound():
    log = TL.frame_log_init(4, (1,), device="cpu")
    for i in range(7):
        TL.frame_log_append(log, float(i), torch.tensor([i], dtype=torch.uint8))
    valid, ts, frames = TL.frame_log_range_query(log, 0.0, 100.0, 4)
    assert ts.tolist() == [3.0, 4.0, 5.0, 6.0]
    assert bool(valid.all())
    assert frames[:, 0].tolist() == [3, 4, 5, 6]


def test_range_query_window():
    log = TL.frame_log_init(16, (1,), device="cpu")
    for i in range(10):
        TL.frame_log_append(log, float(i), torch.tensor([i], dtype=torch.uint8))
    valid, ts, frames = TL.frame_log_range_query(log, 2.0, 5.0, 8)
    assert ts[valid].tolist() == [2.0, 3.0, 4.0, 5.0]


def test_point_query_misses_before_the_oldest_live_entry():
    log = TL.frame_log_init(4, (1,), device="cpu")
    for i in range(7):
        TL.frame_log_append(log, float(i), torch.tensor([i], dtype=torch.uint8))
    found, ts, _ = TL.frame_log_point_query(log, 2.5)    # 0..2 overwritten
    assert not bool(found) and float(ts) == float("-inf")
    found, ts, frame = TL.frame_log_point_query(log, 3.0)
    assert bool(found) and float(ts) == 3.0 and int(frame[0]) == 3

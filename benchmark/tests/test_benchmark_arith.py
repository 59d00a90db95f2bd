"""The yardstick's arithmetic on hand-counted cases."""

import math

import pytest

from benchmark import flops, roofline
from benchmark.kinds.serve import percentile, schedule


def test_bound_takes_the_larger_side():
    assert roofline.bound_s(3.35e12, 0.0) == pytest.approx(1.0)
    assert roofline.bound_s(0.0, 989e12) == pytest.approx(1.0)
    assert roofline.bound_s(3.35e12, 2 * 989e12) == pytest.approx(2.0)


def test_layer_params_hand_counted():
    # dim 4, 2 heads of 3, inner 5: to_q 4*6, to_kv 4*6, to_out 6*4, proj_in 4*10, proj_out 5*4
    assert roofline.layer_matrix_params(4, 2, 3, 5) == 24 + 24 + 24 + 40 + 20
    assert roofline.layer_columns(4, 2, 3, 5) == 6 + 6 + 4 + 10 + 4


def test_stage_work_hand_counted():
    dims = {"dim": 4, "depth": 1, "heads": 2, "dim_head": 3, "inner": 5, "vocab": 7}
    P = 132
    pf, pb, df, db = roofline.stage_work(dims, batch=2, prefill_len=3, n_new=2, weight_bytes=1.0, act_bytes=2.0)
    # prefill: 2 rows x (2*3*P + 4*2*3*6 pairs + 12*3*5) + the last position's head 2*4*7
    assert pf == 2 * (2 * 3 * P + 4 * 6 * 6 + 12 * 3 * 5 + 2 * 4 * 7)
    assert pb == P * 2 + 2 * 1 * 3 * 2 * 3 * 2 + 4 * 7 * 2
    # decode steps see 3 and 4 cached keys (plus the fresh one)
    step = [2 * (2 * P + 4 * 6 * (live + 1) + 12 * 5 + 2 * 4 * 7) for live in (3, 4)]
    assert df == sum(step)
    weights = P + 30 * 4 + 4 * 7 + 7 * 4
    row = 2 * 3 + 8
    assert db == sum(weights + 2 * (live * row + row + 3 * 2 * 5 * 2) for live in (3, 4))


def test_train_flops_hand_counted():
    dims = {"dim": 4, "heads": 2, "dim_head": 3, "inner": 5, "depth": 1, "specs": [(7, 1)]}
    n = 3 + 2
    per_layer = 2 * n * 4 * 6 + 2 * n * 4 * 6 + 4 * 6 * n * n + 2 * n * 6 * 4 + 2 * n * 4 * 10 + 12 * n * 5 + 2 * n * 5 * 4
    logit = 2 * 5 * 4 * 8
    relpos = (2 * n - 1) * (2 * 2 + 2 * 2 * 2 * 2 + 2 * 2 * 2)
    assert flops.stage_forward_flops(dims, [3], 1) == per_layer + logit + relpos
    assert flops.stage_train_flops(dims, [3], 1, 2) == 6 * (per_layer + logit + relpos)


def test_schedule_is_the_same_work_for_every_seed():
    a, b = schedule(4.0, 10.0, 1), schedule(4.0, 10.0, 2 ** 40 + 7)
    assert len(a) == len(b) == 40
    assert a != b
    gaps = lambda d: sorted(round(y - x, 12) for x, y in zip([0.0] + d[:-1], d))  # noqa: E731
    assert gaps(a) == gaps(b)
    assert a[-1] == pytest.approx(b[-1])
    assert all(y > x for x, y in zip(a, a[1:]))
    # the exponential quantiles' mean gap is close to 1 / rate
    assert a[-1] / 40 == pytest.approx(0.25, rel=0.1)
    # even arrivals: the same times for every seed, one every 1 / rate
    e = schedule(4.0, 10.0, 1, "even")
    assert e == schedule(4.0, 10.0, 2 ** 40 + 7, "even")
    assert e == pytest.approx([(i + 0.5) * 0.25 for i in range(40)])
    with pytest.raises(ValueError):
        schedule(4.0, 10.0, 1, "bursty")


def test_latency_counts_from_the_due_time():
    """A stall delays every request behind it: timed from its due time, a
    request that waited in the queue counts the wait; timed from when it
    was sent after the stall, it would not."""
    due = [0.0, 1.0, 2.0, 3.0]
    served = [0.5, 6.0, 6.2, 6.4]  # the server stalled from 1 s to 6 s
    lat = [s - d for s, d in zip(served, due)]
    assert lat == pytest.approx([0.5, 5.0, 4.2, 3.4])
    assert percentile(lat, 50) == pytest.approx(3.8)
    assert percentile([0.5, 0.5, 0.5, 0.5], 50) == 0.5


def test_percentile_and_rate_move_with_a_stall():
    base = [1.0] * 100
    stalled = [1.0] * 85 + [9.0] * 15
    assert percentile(base, 90) == 1.0
    assert percentile(stalled, 90) == 9.0
    assert percentile(stalled, 50) == 1.0
    # a rate over the whole window: the same work with a 2 s stall reads lower
    assert (128 * 4) / 10.0 > (128 * 4) / 12.0
    assert math.isclose(percentile(list(range(1, 102)), 90), 91.0)

"""The reduction of a traced slice: busy, idle and gaps from intervals."""

import pytest

from benchmark import devtrace


def test_overlapping_streams_count_once():
    # two streams overlap over [2, 3]; a copy inside a kernel adds nothing
    intervals = [(0.0, 3.0), (2.0, 5.0), (2.5, 2.6), (7.0, 8.0)]
    assert devtrace.busy(intervals) == pytest.approx(6.0)
    assert devtrace.idle_share(intervals, 10.0) == pytest.approx(0.4)
    assert devtrace.gaps(intervals) == [(5.0, 7.0)]


def test_a_summed_kernel_time_would_read_busier_than_the_wall():
    intervals = [(0.0, 4.0), (0.0, 4.0)]
    assert sum(b - a for a, b in intervals) == 8.0
    assert devtrace.idle_share(intervals, 4.0) == pytest.approx(0.0)


def test_idle_gaps_are_labelled_by_the_innermost_host_event():
    device = [(0.0, 1.0), (1.5, 2.0), (4.0, 5.0)]
    host = [("call", 0.0, 5.0), ("sync", 2.0, 3.5)]
    assert devtrace.labelled_gaps(device, host) == [["sync", 2.0], ["call", 0.5]]
    assert devtrace.labelled_gaps(device, []) == [["host idle", 2.0], ["host idle", 0.5]]


def test_top_ops_and_kernel_seconds():
    events = [("void channel_layernorm_kernel<bf16>", 0.0, 1.0), ("gemm", 1.0, 4.0),
              ("void channel_layernorm_kernel<bf16>", 5.0, 5.5)]
    assert devtrace.top_ops(events, 1) == [["gemm", 3.0]]
    assert devtrace.kernel_seconds(events, ("channel_layernorm_kernel",)) == (1.5, 2)


def test_a_slice_needs_a_wall():
    with pytest.raises(ValueError):
        devtrace.idle_share([(0.0, 1.0)], 0.0)

"""The window's arithmetic on synthetic timings."""

import pytest

from benchmark import window


def test_a_stall_inside_the_window_lowers_the_rate():
    steady = window.rate(40, 0.0, 30.0)
    # the same 40 calls with a 3 s stall between two of them
    stalled = window.rate(40, 0.0, 33.0)
    assert stalled < steady
    assert steady == pytest.approx(40 / 30)


def test_the_rate_needs_a_window():
    with pytest.raises(ValueError):
        window.rate(1, 2.0, 2.0)

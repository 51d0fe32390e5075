"""The roofline counts are fixed numbers: what the protocol requires of a
call at the cells' shapes, whatever implements the kernel."""

import pytest

from perfbench.lib import roofline


def test_peaks():
    assert roofline.HBM_BYTES_PER_S == 3.35e12
    assert roofline.INT32_OPS_PER_S == pytest.approx(16.72704e12)
    assert roofline.THREEFRY_OPS == 75


@pytest.mark.parametrize("rows,length,expect_ms", [
    # u1 B-term at 2^14: kappa_1 = 256 rows, r * t_1 * kappa = 16,384
    (256, 16 * 4 * 256, 1.20359963),
    # u1 B-term at 2^20: r * t_1 * kappa = 131,072
    (256, 128 * 4 * 256, 9.62879706),
    # C-term at 2^14: 136 (i <= j) pairs x t_2 = 3
    (256, 136 * 3, 0.02997245),
    # D-term at 2^20: 8,256 pairs x t_1 = 4
    (256, 8256 * 4, 2.42600551),
])
def test_stream_least_time_is_threefry_bound(rows, length, expect_ms):
    s = roofline.stream_least_s(rows, length, 64)
    assert s * 1e3 == pytest.approx(expect_ms, rel=1e-6)
    # the bytes' time is far below: the entries bound these calls
    assert 8 * 64 * (length + rows) / roofline.HBM_BYTES_PER_S < s


def test_instances_scale_the_count():
    assert roofline.stream_least_s(256, 100, 64, instances=3) == \
        pytest.approx(3 * roofline.stream_least_s(256, 100, 64))

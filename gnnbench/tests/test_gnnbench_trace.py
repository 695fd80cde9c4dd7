"""The trace reduction: the busy union, the gaps and their host names."""

from gnnbench.trace import Trace, idle_by_host, matched_device_time, top_device_ops


def _trace():
    dev = [("k1", 1.0, 2.0), ("k2", 1.5, 3.0), ("k1", 5.0, 6.0)]
    host = [("outer", 0.0, 10.0), ("inner", 3.5, 4.5), ("late", 6.5, 9.5)]
    gaps = [(0.0, 1.0), (3.0, 5.0), (6.0, 10.0)]
    return Trace(10.0, 4.0, dev, host, gaps)


def test_top_device_ops_sums_by_name():
    assert top_device_ops(_trace()) == [["k1", 2.0], ["k2", 1.5]]


def test_idle_named_by_the_innermost_open_host_op():
    assert idle_by_host(_trace()) == [["late", 4.0], ["inner", 2.0], ["outer", 1.0]]


def test_matched_device_time():
    assert matched_device_time(_trace(), ("k2",)) == 1.5

"""``chip_smoke.py``'s split of a profiled step by ``record_function``
range counts each device kernel once: where an event and its child both
list a kernel, where ranges nest, and where two launches of one kernel
take the same time.  Synthetic event trees stand for torch.profiler's."""

from types import SimpleNamespace as NS

import pytest

import chip_smoke


def _kernel(name, us):
    return NS(name=name, device=0, duration=us)


def _host(name, corr, us, kernels=(), children=()):
    return NS(name=name, id=corr, kernels=list(kernels),
              cpu_children=list(children), device_type="DeviceType.CPU",
              time_range=NS(start=0.0, elapsed_us=lambda: us))


def _device(name, corr, start, us):
    return NS(name=name, id=1000 + corr, linked_correlation_id=corr,
              kernels=[], cpu_children=[], device_type="DeviceType.CUDA",
              time_range=NS(start=start, elapsed_us=lambda: us))


def test_kernel_under_parent_and_child_counts_once():
    """A kernel filed among both an event's kernels and its child's is
    one launch: the range reads its time once."""
    k = _kernel("adamw_kernel", 5.0)
    child = _host("aten::_foreach_add_", 2, 6.0, [k])
    parent = _host("hvd.shard_update", 1, 10.0, [k], [child])
    assert [(n, us) for n, _, us in chip_smoke.range_kernels(parent)] == \
        [("adamw_kernel", 5.0)]


def test_launches_of_equal_time_count_apart():
    """Two launches of one kernel that took the same time are told apart
    by their start, from the device events' correlation ids; an
    annotation's device side is left out."""
    a = _host("aten::mul_", 2, 3.0)
    b = _host("aten::mul_", 3, 3.0)
    parent = _host("hvd.wire_codec", 1, 9.0, children=[a, b])
    events = [parent, a, b, _device("mul_kernel", 2, 100.0, 4.0),
              _device("mul_kernel", 3, 110.0, 4.0),
              _device("hvd.wire_codec", 1, 99.0, 20.0)]
    launched = chip_smoke.launched_kernels(events)
    got = chip_smoke.range_kernels(parent, launched)
    assert sorted(got) == [("mul_kernel", 100.0, 4.0),
                           ("mul_kernel", 110.0, 4.0)]


def test_nested_ranges_share_no_kernel():
    """A range inside another range: each kernel goes to the innermost,
    and the rest of the busy time is what no range launched."""
    inner_op = _host("aten::add_", 3, 2.0)
    inner = _host("hvd.allgather", 2, 4.0, children=[inner_op])
    outer_op = _host("aten::mul_", 4, 2.0)
    outer = _host("hvd.shard_update", 1, 10.0,
                  children=[inner, outer_op])
    events = [outer, inner, inner_op, outer_op,
              _device("add_kernel", 3, 10.0, 1.5),
              _device("mul_kernel", 4, 12.0, 2.5)]
    split, top, _ = chip_smoke.split_ranges(
        events, chip_smoke.ZERO_RANGES, busy_ms=0.010)
    assert split["allgather"] == pytest.approx(1.5e-3)
    assert split["shard AdamW"] == pytest.approx(2.5e-3)
    assert split["rest"] == pytest.approx(6e-3)
    assert top["allgather"] == {"add_kernel": pytest.approx(1.5e-3)}


def test_ranges_over_the_busy_time_fail():
    """Ranges that read more than the step's busy device time are a
    miscount, and the split raises."""
    op = _host("aten::mul_", 2, 2.0)
    rng = _host("hvd.shard_update", 1, 10.0, children=[op])
    events = [rng, op, _device("mul_kernel", 2, 0.0, 8.0)]
    with pytest.raises(AssertionError, match="busy"):
        chip_smoke.split_ranges(events, chip_smoke.ZERO_RANGES,
                                busy_ms=0.005)

"""The span attribution (``benchmark/spans.py``) on synthetic events, and
the readers of the span metrics: 0 where no kernel ran under their spans,
none where the window recorded no program span."""

import pytest

from _tiny import ROOT  # noqa: F401  (puts the checkout on sys.path)
from benchmark import run, spans

# host ranges (start, end, name) of one step: a block holding a norm and
# the planner, then the head; each kernel's launch on the host, and the
# kernel as (start, end, class) on the device (times in us)
HOST = [(0, 100, "step"), (1, 80, "trunk"), (2, 79, "block"),
        (3, 10, "norm"), (11, 20, "planner"), (81, 99, "head")]
LAUNCHES = [-1, 2.5, 4, 5, 12, 21, 85]
DEVICE = [(0.5, 3.5, "other"),             # launched before the step
          (12, 14, "gemm"),                # the block's own GEMM
          (16, 19, "other"),               # norm
          (20, 23, "other"),               # norm
          (40, 43, "other"),               # planner
          (60, 62, "block_sparse_kernel"),  # the block again
          (100, 103, "other")]             # head


def _ms(span_ms, path, cls):
    return span_ms.get(path, {}).get(cls, 0.0)


def test_the_innermost_span_open_at_the_launch_wins():
    got = spans.attribute(DEVICE, LAUNCHES, HOST)
    block = ("step", "trunk", "block")
    assert _ms(got, block + ("norm",), "other") == pytest.approx(0.006)
    assert _ms(got, block + ("planner",), "other") == pytest.approx(0.003)
    assert _ms(got, block, "gemm") == pytest.approx(0.002)
    assert _ms(got, block, "block_sparse_kernel") == pytest.approx(0.002)
    assert _ms(got, ("step", "head"), "other") == pytest.approx(0.003)
    # the unspanned remainder: the kernel launched before the step
    assert _ms(got, (), "other") == pytest.approx(0.003)


def test_equal_ranges_nest_as_they_do_elsewhere_in_the_trace():
    """A trunk whose one block opened and closed with it: the block, a
    deeper span everywhere else in the trace, is the inner one, in either
    order of the events."""
    host = HOST + [(200, 300, "step"), (201, 299, "trunk"),
                   (201, 299, "block")]
    kernels = DEVICE + [(301, 303, "other")]
    launches = LAUNCHES + [250]
    for order in (host, host[::-1]):
        got = spans.attribute(kernels, launches, order)
        assert _ms(got, ("step", "trunk", "block"), "other") \
            == pytest.approx(0.002)
        assert not any(p[-1:] == ("trunk",) for p in got)


def test_per_class_totals_are_preserved_and_the_check_catches_a_miss():
    got = spans.attribute(DEVICE, LAUNCHES, HOST)
    total = {"other": 5 * 0.003, "gemm": 0.002,
             "block_sparse_kernel": 0.002, "dense_kernel": 0.0}
    assert spans.check(got, total) == []
    planted = dict(total, other=total["other"] * 1.006)
    assert [c for c, _, _ in spans.check(got, planted)] == ["other"]
    assert spans.check(got, dict(total, other=total["other"] * 1.004)) \
        == []


def test_a_kernel_with_no_launch_or_an_ambiguous_one_is_missed():
    ids = [11, 12, 13, 14, 15, 16, 17]
    host = [(i, t) for i, t in zip(ids, LAUNCHES)]
    assert spans.launch_times(host, ids) == LAUNCHES
    # the K1 launch not found; the head kernel's id carried twice
    host = [h for h in host if h[0] != 16] + [(17, 50)]
    launches = spans.launch_times(host, ids)
    assert launches[5] is None and launches[6] is None
    got = spans.attribute(DEVICE, launches, HOST)
    total = {"other": 5 * 0.003, "gemm": 0.002,
             "block_sparse_kernel": 0.002}
    assert sorted(c for c, _, _ in spans.check(got, total)) == [
        "block_sparse_kernel", "other"]


def test_a_launch_timed_after_its_kernel_still_counts():
    """The trace's host and device clocks can disagree by more than a
    launch's lead: the launch alone decides the path."""
    device = list(DEVICE)
    device[2] = (3.5, 6.5, "other")     # "began" before its launch at 4
    got = spans.attribute(device, LAUNCHES, HOST)
    assert _ms(got, ("step", "trunk", "block", "norm"), "other") \
        == pytest.approx(0.006)


def _ctx(span_ms, syncs=None, steps=2):
    return {"busy_s": 1.0, "steps": steps, "device_ms": {},
            "spans": {"span_ms": span_ms, "syncs": syncs or {},
                      "idle_by_span": []}}


READERS = ("planner_ms", "elementwise_ms", "layout_ms", "sampler_ms",
           "host_syncs")


@pytest.mark.parametrize("metric", READERS)
def test_readers_read_zero_without_their_spans_and_none_without_spans(
        metric):
    read, _ = run.load_reader(metric)
    # a window whose only spans launched GEMMs in a block of the trunk
    only_block = {("step", "trunk", "block"): {"gemm": 4.0}}
    assert read(_ctx(only_block)) == 0.0
    no_spans = {"busy_s": 1.0, "steps": 2, "device_ms": {}, "spans": None}
    assert read(no_spans) is None
    assert read({"busy_s": 0.0, "steps": 2, "device_ms": {}}) is None


def test_readers_sum_their_paths_per_step():
    span_ms = {("step", "trunk", "block", "planner"): {"other": 2.0,
                                                      "gemm": 1.0},
               ("step", "trunk", "block", "norm"): {"other": 4.0},
               ("step", "trunk", "block", "rope"): {"other": 2.0},
               ("step", "head", "norm"): {"other": 1.0},
               ("step", "trunk", "block", "layout"): {"other": 6.0},
               ("step", "embed", "layout"): {"other": 2.0},
               ("step", "solver"): {"other": 1.0},
               (): {"other": 10.0}}
    syncs = {("step", "trunk", "block", "layout"): 60, (): 3}
    ctx = _ctx(span_ms, syncs)
    want = {"planner_ms": 1.5, "elementwise_ms": 3.5, "layout_ms": 4.0,
            "sampler_ms": 2.0, "host_syncs": 30.0}
    for metric, value in want.items():
        assert run.load_reader(metric)[0](ctx) == pytest.approx(value)

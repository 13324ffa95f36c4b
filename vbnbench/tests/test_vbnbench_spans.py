"""The readers of the port's own spans and counters (``port_spans.py``) on
a made-up span buffer: self times of the stages they name over the last
``len(ctx["calls"])`` ``vbn.call`` roots, the waits (``vbn.sync``) left
out, and None where the buffer holds fewer roots or dropped spans, where
the port keeps no spans (an older checkout run under this harness), and
on the made-up trace of
``test_vbnbench_trace.py``."""

import pytest

from vbnbench import registry
from vbnbench.tests.test_vbnbench_trace import fake_prof
from vbnbench.trace import reduce_trace
from vectorizedbayesiannetwork_torch.utils import profiling

READERS = ("prepare_ms_per_call", "build_ms_per_call", "enqueue_ms_per_call",
           "builds_per_call")
MS = 1_000_000  # ns


def _buffer():
    buf = []

    def span(name, a, b, parent=-1, call=0, **attrs):
        buf.append({"name": name, "start_ns": int(a * MS),
                    "end_ns": int(b * MS), "parent": parent, "call": call,
                    "attrs": attrs, "index": len(buf)})
        return len(buf) - 1

    # a call before the traced window: left out
    r = span("vbn.call", 0, 90, call=1, builds={"fn": 9, "tables": 9,
                                                 "plans": 9})
    span("vbn.normalize", 0, 50, r, 1)
    span("vbn.build", 50, 80, r, 1)
    # traced call A: prepare 1 + 0.5 + 2 + 0.3, build 0.6 + 0.4,
    # enqueue 1.2 + 0.3 + 0.2 + 0.4, builds 3; the waits are no one's
    r = span("vbn.call", 100, 110, call=2, builds={"fn": 1, "tables": 2,
                                                    "plans": 0})
    span("vbn.normalize", 100, 101, r, 2)
    span("vbn.plan", 101, 101.5, r, 2)
    red = span("vbn.reduce.dynamic", 102, 109, r, 2)
    span("vbn.pack", 102, 104, red, 2)
    b = span("vbn.build", 104, 105, red, 2)
    span("vbn.tables", 104.2, 104.6, b, 2)
    up = span("vbn.upload", 105, 105.5, red, 2)
    span("vbn.sync", 105, 105.2, up, 2)
    sw = span("vbn.sweep.per_node", 105.5, 108, red, 2)
    span("vbn.sync", 107.5, 107.9, sw, 2)
    d = span("vbn.draw", 106, 106.5, sw, 2)
    span("vbn.kernel.uniforms", 106.1, 106.3, d, 2)
    span("vbn.kernel.kde_pick", 107, 107.4, sw, 2)
    span("vbn.fetch", 108, 109, red, 2)
    # traced call B: prepare 2, build 3, enqueue 1, builds 5
    r = span("vbn.call", 120, 130, call=3, builds={"fn": 2, "tables": 2,
                                                    "plans": 1})
    span("vbn.normalize", 120, 122, r, 3)
    red = span("vbn.reduce.fused", 122, 129, r, 3)
    span("vbn.build", 122, 125, red, 3)
    span("vbn.kernel.categorical", 125, 126, red, 3)
    # a root of another kind after the window: left out
    span("vbn.draw", 140, 150, call=4)
    return buf


@pytest.fixture
def buffer(monkeypatch):
    buf = _buffer()
    monkeypatch.setattr(profiling, "spans", lambda: buf)
    return buf


def _read(name, ctx):
    return registry.metric_reader(name).read(ctx)


def test_readers_on_a_span_buffer(buffer):
    ctx = {"calls": [{}, {}]}
    assert _read("prepare_ms_per_call", ctx) == pytest.approx((3.8 + 2.0) / 2)
    assert _read("build_ms_per_call", ctx) == pytest.approx((1.0 + 3.0) / 2)
    assert _read("enqueue_ms_per_call", ctx) == pytest.approx((2.1 + 1.0) / 2)
    assert _read("builds_per_call", ctx) == (3 + 5) / 2


@pytest.mark.parametrize("name", READERS)
def test_fewer_roots_than_traced_calls(buffer, name):
    assert _read(name, {"calls": [{}] * 4}) is None
    assert _read(name, {"calls": []}) is None
    assert _read(name, {}) is None


@pytest.mark.parametrize("name", READERS)
def test_a_buffer_that_dropped_spans(buffer, monkeypatch, name):
    """Past ``MAX_SPANS`` the port keeps no new roots, so the last roots
    kept are older calls: the readers give None, not those."""
    monkeypatch.setattr(profiling, "spans_dropped", lambda: 1)
    assert _read(name, {"calls": [{}, {}]}) is None


@pytest.mark.parametrize("name", READERS)
def test_a_port_without_spans(monkeypatch, name):
    monkeypatch.delattr(profiling, "spans")
    assert _read(name, {"calls": [{}, {}]}) is None


@pytest.mark.parametrize("name", READERS)
def test_none_on_the_made_up_trace(name):
    profiling.reset_spans()
    t = reduce_trace(fake_prof())
    t["least_ms"] = [0.007, 0.004]
    t["peak_bytes"] = 2**31
    assert _read(name, t) is None

"""The reader of the program's spans (``spans.py``) on synthetic profiler
events: the benchmark's synthetic calls plus ``mh::`` host ranges and
their device-side ranges.  Without the ranges the harness's reading is
unchanged; each synthetic kernel and idle gap goes to its innermost span;
each stage reading is None where the record holds no program span."""

import types

import pytest

from spgemm_bench import profile, spans


class _Event:
    def __init__(self, name, t0, t1, device=False, annotation=False,
                 id=0):
        self.name = name
        self.time_range = types.SimpleNamespace(start=t0, end=t1)
        self.device_type = "DeviceType.CUDA" if device else "DeviceType.CPU"
        self.is_user_annotation = annotation
        self.id = id


def _warm(calls=2, flagged=True):
    """Calls of 1 ms (us timestamps).  In each: ``front.pre`` launches a
    kernel (linked by correlation id), ``tail.sort`` launches one through
    an aten op and leaves a host gap under ``aten::nonzero``,
    ``extract.static`` a copy that no launch links (only its device-side
    range holds it), and one kernel runs outside any program span.
    ``flagged``: the device-side ranges carry the user-annotation flag."""
    ev = [_Event("ProfilerStep#1", 0, 1000 * calls)]
    for c in range(calls):
        b, k = c * 1000, 100 * c
        ev += [
            _Event("bench::call", b, b + 1000),
            _Event("mh::bucketed", b + 10, b + 950),
            _Event("mh::front.pre", b + 20, b + 100),
            _Event("cudaLaunchKernel", b + 30, b + 40, id=k + 1),
            _Event("expand<double>(int const*)", b + 100, b + 300,
                   device=True, id=k + 1),
            _Event("mh::tail.sort", b + 300, b + 650),
            _Event("aten::sort", b + 305, b + 320),
            _Event("cudaLaunchKernel", b + 310, b + 315, id=k + 2),
            _Event("radixSort(int*)", b + 320, b + 400, device=True,
                   id=k + 2),
            _Event("aten::nonzero", b + 400, b + 600),
            _Event("mh::extract.static", b + 650, b + 900),
            _Event("Memcpy DtoD (Device -> Device)", b + 700, b + 800,
                   device=True, id=0),
            _Event("mh::extract.static", b + 700, b + 800, device=True,
                   annotation=flagged),
            _Event("mh::tail.sort", b + 320, b + 400, device=True,
                   annotation=flagged),
            _Event("cudaLaunchKernel", b + 955, b + 960, id=k + 3),
            _Event("fill<int>(int*)", b + 960, b + 990, device=True,
                   id=k + 3),
        ]
    return ev


def _without(events):
    return [e for e in events if not e.name.startswith(spans.PREFIX)]


def test_harness_reading_unchanged_without_the_ranges():
    ev = _warm(flagged=False)
    sp = spans.summarize(ev, 2, 0.0)
    want = profile.summarize(_without(ev), 2, 0.0)
    got = sp.profile
    assert got.busy_s == want.busy_s and got.window_s == want.window_s
    assert got.by_name == want.by_name and got.partial == want.partial
    assert got.launches_per_call() == want.launches_per_call() == 4
    assert got.idle == want.idle
    assert "call/aten::nonzero" in got.idle


def test_device_time_goes_to_the_innermost_span():
    sp = spans.summarize(_warm(), 2, 0.0)
    dev = {k: v[2] for k, v in sp.spans.items()}
    assert dev["front.pre"] == pytest.approx(2 * 200e-6)
    assert dev["tail.sort"] == pytest.approx(2 * 80e-6)
    assert dev["extract.static"] == pytest.approx(2 * 100e-6)
    assert dev[spans.OUTSIDE] == pytest.approx(2 * 30e-6)
    assert dev["bucketed"] == 0.0
    assert sp.linked == {"launch": 6, "annotation": 2, "none": 0}
    assert sum(dev.values()) == pytest.approx(sp.profile.busy_s)
    counts = {k: v[0] for k, v in sp.spans.items() if v[0]}
    assert counts == {"bucketed": 2, "front.pre": 2, "tail.sort": 2,
                      "extract.static": 2}
    assert sp.spans["tail.sort"][1] == pytest.approx(2 * 350e-6)


def test_idle_goes_to_the_innermost_span():
    sp = spans.summarize(_warm(), 2, 0.0)
    idle = sp.idle_by_span
    # 0-100 (10 us under bench::call, 10 under mh::bucketed, 80 under
    # front.pre), 300-320 and 400-650 under tail.sort, 650-700 and
    # 800-900 under extract.static, 900-950 bucketed, 950-960 and
    # 990-1000 call
    assert idle["mh::tail.sort"] == pytest.approx(2 * 270e-6)
    assert idle["mh::extract.static"] == pytest.approx(2 * 150e-6)
    assert idle["mh::front.pre"] == pytest.approx(2 * 80e-6)
    assert idle["mh::bucketed"] == pytest.approx(2 * 60e-6)
    assert idle["bench::call"] == pytest.approx(2 * 30e-6)
    total = sp.profile.window_s - sp.profile.busy_s
    assert sum(idle.values()) == pytest.approx(total)


def test_stage_readings():
    sp = spans.summarize(_warm(), 2, 0.0)
    got = {k: spans.read(sp, k) for k in spans.READERS}
    assert got["frontend_ms.warm"] == pytest.approx(0.2)
    assert got["esc_tail.sort_ms.warm"] == pytest.approx(0.08)
    assert got["esc_tail.kernel_ms.warm"] == 0.0
    assert got["extract_ms.warm"] == pytest.approx(0.1)
    assert got["learn_ms.cold"] == 0.0
    assert got["plan.discarded_ms.cold"] == 0.0


def _cold(replan=True):
    ev = [_Event("ProfilerStep#1", 0, 10000),
          _Event("bench::plan", 0, 6000),
          _Event("mh::plan", 10, 5990),
          _Event("mh::plan.first", 20, 4020)]
    if replan:
        ev.append(_Event("mh::plan.replan", 4100, 5900))
    ev += [_Event("bench::run", 6000, 9000),
           _Event("mh::bucketed", 6010, 8990),
           _Event("cudaLaunchKernel", 6100, 6110, id=7),
           _Event("expand<double>(int const*)", 6110, 6300, device=True,
                  id=7),
           _Event("mh::learn", 6500, 7700)]
    return ev


@pytest.mark.parametrize("replan", [True, False])
def test_cold_readings(replan):
    sp = spans.summarize(_cold(replan), 1, 0.0)
    assert spans.read(sp, "learn_ms.cold") == pytest.approx(1.2)
    assert spans.read(sp, "plan.discarded_ms.cold") == pytest.approx(
        4.0 if replan else 0.0)
    assert sp.idle_by_span["mh::plan.first"] == pytest.approx(4000e-6)
    assert sp.idle_by_span["mh::learn"] == pytest.approx(1200e-6)


@pytest.mark.parametrize("name", sorted(spans.READERS))
def test_reading_is_none_without_program_spans(name):
    for ev in (_warm(), _cold()):
        sp = spans.summarize(_without(ev), 1, 0.0)
        assert not sp.has_spans()
        assert spans.read(sp, name) is None
    assert spans.read(None, name) is None


def test_innermost_of_nested_ranges():
    rs = [(0, 100, "a"), (10, 50, "b"), (20, 30, "c"), (60, 90, "d")]
    got = spans.innermost(rs, [5, 25, 40, 55, 70, 95, 120])
    assert [r[2] if r else None for r in got] == [
        "a", "c", "b", "a", "d", "a", None]

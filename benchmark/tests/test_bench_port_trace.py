"""The trace readers on a small synthetic Chrome trace: the busy share,
the kernels attributed to host ops (by correlation and by External id),
the idle gaps by host op, and the per-layer readers on it."""
import pytest

from benchmark import harness, spec, trace


def _op(name, ts, dur, tid=1, ext=None):
    e = {"ph": "X", "cat": "cpu_op", "name": name, "pid": 1, "tid": tid,
         "ts": ts, "dur": dur, "args": {}}
    if ext is not None:
        e["args"]["External id"] = ext
    return e


def _launch(ts, corr, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "pid": 1, "tid": tid, "ts": ts, "dur": 1, "args": {
                "correlation": corr}}


def _kernel(name, ts, dur, corr=None, ext=None):
    args = {}
    if corr is not None:
        args["correlation"] = corr
    if ext is not None:
        args["External id"] = ext
    return {"ph": "X", "cat": "kernel", "name": name, "pid": 0, "tid": 7,
            "ts": ts, "dur": dur, "args": args}


def events():
    return [
        {"ph": "X", "cat": "user_annotation", "name": harness.PERIOD_BEGIN,
         "pid": 1, "tid": 1, "ts": 0, "dur": 1},
        _op("XV", 10, 10), _launch(12, 1), _kernel("xv_k", 30, 10, corr=1),
        _op("PlaneBCE", 25, 20), _launch(26, 2),
        _kernel("plane_k", 40, 30, corr=2),
        # the backward runs on another thread; its op is nested
        _op("autograd::engine::evaluate_function: PlaneBCEBackward", 50,
            40, tid=2),
        _op("PlaneBCEBackward", 51, 30, tid=2), _launch(60, 3, tid=2),
        _kernel("plane_bwd_k", 80, 20, corr=3),
        # a kernel known only by its External id, launched inside XVBackward
        _op("XVBackward", 95, 10, tid=2, ext=77),
        _kernel("dv_k", 110, 10, ext=77),
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "pid": 0,
         "tid": 8, "ts": 125, "dur": 5},
        _op("aten::addmm", 130, 60),
        {"ph": "X", "cat": "user_annotation", "name": harness.PERIOD_END,
         "pid": 1, "tid": 1, "ts": 200, "dur": 1},
    ]


def test_busy_is_the_union_of_device_intervals():
    ev = events()
    # kernels 30-40, 40-70, 80-100, 110-120, the copy 125-130
    assert trace.busy_us(ev, 0, 200) == 10 + 30 + 20 + 10 + 5
    assert trace.busy_us(ev, 35, 85) == 5 + 30 + 5
    overlap = ev + [_kernel("x", 60, 25, corr=99)]   # 60-85 overlaps
    assert trace.busy_us(overlap, 0, 200) == (100 - 30) + 10 + 5


def test_kernels_are_attributed_to_their_host_op():
    ev = events()
    assert trace.kernel_us_under(ev, 0, 200, ["XV"]) == 10
    assert trace.kernel_us_under(ev, 0, 200,
                                 ["PlaneBCE", "PlaneBCEBackward"]) == 50
    assert trace.kernel_us_under(ev, 0, 200, ["XVBackward"]) == 10
    assert trace.kernel_us_under(ev, 0, 200, ["Adam"]) is None


def test_markers_device_ops_and_idle_gaps():
    ev = events()
    assert trace.marker(ev, harness.PERIOD_BEGIN) == 0
    assert trace.marker(ev, harness.PERIOD_END) == 200
    ops = dict(trace.device_ops(ev, 0, 200))
    assert ops["plane_k"] == pytest.approx(30e-6)
    gaps = dict(trace.idle_gaps(ev, 0, 200, skip=(harness.PERIOD_BEGIN,
                                                  harness.PERIOD_END)))
    # 0-30: XV runs from 10, nothing before; 70-80 inside the backward;
    # 100-110 and 120-125 inside XVBackward / nothing; 130-200 in addmm.
    assert gaps["aten::addmm"] == pytest.approx(70e-6)
    assert gaps["PlaneBCEBackward"] == pytest.approx(10e-6)
    assert sum(gaps.values()) == pytest.approx((200 - 75) * 1e-6)


def test_readers_on_the_synthetic_period():
    run = harness.Run(events=events(), period=(0.0, 200.0),
                      period_steps=[(8, False)], M=16, D=2, ks=[2])
    idle = spec.reader("metrics", "idle_pct")(run)
    assert idle == pytest.approx(100 * (1 - 75 / 200))
    plane = spec.reader("metrics", "roofline_pct.plane")(run)
    from benchmark import work
    b = work.period_bound(run.period_steps, 16, 2, [2], "plane")
    assert plane == pytest.approx(100 * b / 50e-6)
    mfu = spec.reader("metrics", "step_mfu")(run)
    assert mfu == pytest.approx(100 * work.step_model_flops(8, 16, 2, [2])
                                / 200e-6 / work.PEAKS["tf32_flops"])
    empty = harness.Run()
    for name in ("idle_pct", "roofline_pct.xv", "step_mfu"):
        assert spec.reader("metrics", name)(empty) is None

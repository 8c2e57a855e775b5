"""The readers of the program's spans and set-up counters on a small
synthetic Chrome trace, built as test_bench_port_trace.py builds its own:
the idle time split by the span the host was in, the kernels launched
inside na.adam and na.clamp by correlation id, and None on a trace and a
phase that hold none of them (a program that records no span)."""
import os

import pytest

from benchmark import harness, spans, spec


def _span(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "pid": 1,
            "tid": tid, "ts": ts, "dur": dur, "args": {}}


def _launch(ts, corr, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "pid": 1, "tid": tid, "ts": ts, "dur": 1, "args": {
                "correlation": corr}}


def _kernel(name, ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": name, "pid": 0, "tid": 7,
            "ts": ts, "dur": dur, "args": {"correlation": corr}}


def events(with_spans=True):
    """One step, an epoch's boundary and the next epoch's first batch, in
    the period [0, 200):

      span         host       device busy
      na.plan      0-10       -
      na.batch     10-20      gather 15-25
      na.forward   20-40      xv 30-50
      na.backward  40-60      dv 55-70 (launched on the autograd thread)
      na.adam      60-80      adam 70-90
      na.clamp     80-90      clamp 95-100
      na.epoch_end 90-150     -
      na.plan      150-160    plan copy 155-157
      na.batch     160-170    -
      (none)       170-195    -
      na.plan      195-205    the period ends at 200, inside it
    """
    ev = [
        _span(harness.PERIOD_BEGIN, 0, 1), _span(harness.PERIOD_END, 200, 1),
        _launch(12, 1), _kernel("gather", 15, 10, 1),
        _launch(22, 2), _kernel("xv", 30, 20, 2),
        _launch(45, 3, tid=2), _kernel("dv", 55, 15, 3),
        _launch(62, 4), _kernel("multi_tensor_apply", 70, 20, 4),
        _launch(82, 5), _kernel("clamp", 95, 5, 5),
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "pid": 0,
         "tid": 8, "ts": 155, "dur": 2},
    ]
    if with_spans:
        ev += [_span("na.plan", 0, 10), _span("na.batch", 10, 10),
               _span("na.forward", 20, 20), _span("na.backward", 40, 20),
               _span("na.adam", 60, 20), _span("na.clamp", 80, 10),
               _span("na.epoch_end", 90, 60), _span("na.plan", 150, 10),
               _span("na.batch", 160, 10), _span("na.plan", 195, 10)]
    return ev


def _run(ev, **kw):
    return harness.Run(events=ev, period=(0.0, 200.0),
                       period_steps=[(8, False), (8, False)], M=16, D=2,
                       ks=[2], **kw)


def read(name, run):
    return spec.reader("metrics", name)(run)


def test_idle_time_is_split_by_the_span_the_host_was_in():
    run = _run(events())
    # idle: 0-15, 25-30, 50-55, 90-95, 100-155, 157-200 (128 of 200)
    assert read("idle_pct", run) == pytest.approx(100 * 128 / 200)
    # in a step's spans: 10-15 (batch), 25-30 (forward), 50-55
    # (backward), 160-170 (batch)
    assert read("idle_pct.step", run) == pytest.approx(100 * 25 / 200)
    # at the boundary: 0-10, 150-155, 157-160, 195-200 (plan), 90-95 and
    # 100-150 (epoch_end)
    assert read("idle_pct.epoch_end", run) == pytest.approx(100 * 78 / 200)
    # what no span covers (170-195) is in neither


def test_the_optimizer_is_the_kernels_launched_in_adam_and_clamp():
    run = _run(events())
    # adam 20 us + clamp 5 us over two steps
    assert read("optimizer_ms", run) == pytest.approx(25e-3 / 2)
    # a kernel is attributed by its launch, not by when it runs: the
    # clamp kernel runs inside na.epoch_end and still counts
    assert spans.kernel_ms_per_step(run, ("na.epoch_end",)) is None
    assert spans.kernel_ms_per_step(run, ("na.backward",)) is None


def test_interval_arithmetic():
    assert spans.overlap_us([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert spans.overlap_us([(0, 10)], [(10, 20)]) == 0
    assert spans.span_intervals(events(), ["na.plan"], 0, 200) == [
        (0, 10), (150, 160), (195, 200)]
    assert spans.idle_intervals(events(), 0, 200)[0] == (0, 15)


NEW = ("idle_pct.step", "idle_pct.epoch_end", "optimizer_ms",
       "layout_s.host", "layout_s.upload", "init_s.optimizer")


def test_a_program_without_spans_or_counters_reads_none():
    run = _run(events(with_spans=False),
               phase={"layout": 15.0, "init": 0.5, "q_pass": 0.2},
               warm_phase={"layout": 0.1, "init": 8.0})
    assert read("idle_pct", run) is not None
    for name in NEW:
        assert read(name, run) is None, name
    for name in NEW:
        assert read(name, harness.Run()) is None, name


def test_the_counters_read_the_calls_phases():
    run = _run([], phase={"layout": 15.0, "layout.host": 9.0,
                          "layout.upload": 6.0, "init.optimizer": 0.1},
               warm_phase={"init": 8.0, "init.optimizer": 7.5})
    assert read("layout_s.host", run) == 9.0
    assert read("layout_s.upload", run) == 6.0
    assert read("init_s.optimizer", run) == 7.5  # the process's first Adam
    # a streamed call uploads no rows
    assert read("layout_s.upload", _run([], phase={"layout.host": 1.0})) \
        is None


def test_the_new_metrics_are_declared_for_both_cells():
    bench = spec.benchmark_json(os.path.dirname(spec.HERE))
    declared = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        m = declared[name]
        assert m["source"] == "program_span"
        assert m["workloads"] == ["train_k2to10_b800", "train_k8_b4096"]
        assert m["moves"] == ("setup_s" if "_s." in name
                              else "train_samples_per_s")

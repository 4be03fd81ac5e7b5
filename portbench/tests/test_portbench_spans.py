"""The readers of the program's own spans on the tiny traced CPU cell (the
harness's profiler makes the program record its steps), and the idle gaps
labelled by program span on a trace made up here."""
import json
import math

from pb_paths import DATA, REPO

NEW = ["forward_device_ms.train", "backward_device_ms.train",
       "optimizer_device_ms.train", "data_ms.train", "loop_untraced_ms.train"]


def test_span_readers_read_the_tiny_traced_run():
    import harness
    import program_spans
    out = harness.run_cell(REPO, "tiny.prune", 2**31 + 3, 0.5, True,
                           device="cpu",
                           manifest_path=DATA / "manifest_spans.json",
                           data_dir=DATA)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == set(NEW)
    for name, v in out["metrics"].items():
        assert math.isfinite(v["value"]) and v["value"] >= 0, (name, v)
        assert v["unit"] == "ms"
    spans = program_spans.read()
    # the traffic's three traced steps, 21 + 1 to 21 + 3
    assert sorted(s["step"] for s in spans if s["name"] == "train.step") \
        == [22, 23, 24]
    assert program_spans.steps(spans) == 3


def _trace(tmp_path, kernels_us):
    doc = {"baseTimeNanoseconds": 1_000_000_000,
           "traceEvents": [{"cat": "kernel", "name": f"k{i}", "ts": a,
                            "dur": b - a}
                           for i, (a, b) in enumerate(kernels_us)]}
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(doc))
    return str(path)


def _ns(us):
    return 1_000_000_000 + us * 1000


def _span(name, a_us, b_us, parent="train"):
    return {"name": name, "start_ns": _ns(a_us), "end_ns": _ns(b_us),
            "device_ms": None, "step": 1, "parent": parent}


def test_idle_gaps_take_the_innermost_program_span(tmp_path):
    import program_spans
    # the device busy 0-10, 30-40, 45-50, 90-100 us: gaps 10-30 (in the
    # harness's step, in step.optimizer), 50-90 (the loop, in train.hook
    # and its parent train.step aside) and 40-45 (no program span)
    path = _trace(tmp_path, [(0, 10), (30, 40), (45, 50), (90, 100)])
    marks = [_ns(0), _ns(100)]
    harness = [(_ns(0), _ns(41), "step")]
    spans = [_span("train", 0, 100, parent=None),
             _span("train.step", 0, 39),
             _span("step.forward", 0, 5, parent="train.step"),
             _span("step.optimizer", 5, 35, parent="train.step"),
             _span("train.hook", 48, 95)]
    got = program_spans.label_gaps(path, marks, harness, spans)
    assert [label for label, _ in got] == [
        "loop:train.hook", "step:step.optimizer", "step"]
    assert [round(s * 1e6) for _, s in got] == [40, 20, 5]
    # covered 0-39 (train.step) and 48-95 (train.hook): 9 us in one step
    assert math.isclose(program_spans.untraced_ms(spans), 0.009)

"""The harness finds a cell, a mix and a metric from files alone, and
BENCHMARK.json, and benchmark/candidates.json (the cells built but not yet
declared), keep to the benchmark's format."""

import json
import re
import types

import pytest

import run
import tracing

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


CANDIDATES = run.BENCH / "candidates.json"
REGISTRIES = [run.ROOT / "BENCHMARK.json", CANDIDATES]


@pytest.fixture(scope="module", params=REGISTRIES, ids=["declared", "candidates"])
def registry(request):
    return request.param


@pytest.fixture(scope="module")
def bench(registry):
    return run.read_json(registry)


def test_top_level_keys_and_paths(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51


def test_every_cell_finds_its_files(bench, registry):
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and len(w["why"]) <= 200 and w["chips"] in (1, 4)
        ctx = run.Ctx(w["name"], 1, 1.0, False, "cpu", bench_file=registry)
        assert (run.BENCH / "traffic" / f"{ctx.params['kind']}.py").exists()
        assert ctx.config["name"] == w["config"]
        assert ctx.end_to_end(), "a cell reports an end-to-end metric"
        assert any(m["name"] == "setup_s" for m in ctx.end_to_end())
        assert len(ctx.end_to_end()) >= 2 and ctx.per_layer()
        assert ctx.params["limits"], "a cell compares its outputs"


def test_configs_hold_their_sources(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and c["reduced"] == []
        data = run.read_json(run.ROOT / c["file"])
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]


def test_metrics_keep_to_the_format(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["end_to_end"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", cells)
        assert (run.BENCH / "metrics" / f"{m['name']}.py").exists()
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline") and m["unit"] == "%"


def empty_trace(counters=None):
    return tracing.Trace([], [], (0.0, 1e6), 1, counters or {})


def test_every_reader_is_found_by_name_and_reads_nothing_from_nothing(bench, registry):
    for m in bench["per_layer"]:
        ctx = run.Ctx(m["workloads"][0], 1, 1.0, True, "cpu", bench_file=registry)
        reader = run.load_module(run.BENCH / "metrics" / f"{m['name']}.py", "r_" + m["name"])
        value = reader.read(empty_trace(), ctx)
        if m["name"] in ("device_idle.corpus", "device_idle.train"):
            assert value == 100.0  # a window with no kernel is all idle
        else:
            assert value is None, m["name"]


def test_device_idle_and_launches_from_a_built_timeline():
    k = [tracing.Kernel("a", 100.0, 300.0, 0, 50.0, 1), tracing.Kernel("b", 250.0, 400.0, 0, 60.0, 1),
         tracing.Kernel("c", 700.0, 800.0, 0, 650.0, 1)]
    spans = [tracing.Span("bench.window", 0.0, 1000.0, 1), tracing.Span("bench.dispatch", 0.0, 500.0, 1)]
    tr = tracing.Trace(k, spans, (0.0, 1000.0), 1, {"clips_started": 3})
    assert tr.busy_s() == pytest.approx(400e-6)
    assert tr.busy_s([(0.0, 500.0)]) == pytest.approx(300e-6)
    assert [x.name for x in tr.in_spans("bench.dispatch")] == ["a", "b"]
    ctx = run.Ctx("vote.serve", 1, 1.0, True, "cpu", bench_file=CANDIDATES)
    idle = run.load_module(run.BENCH / "metrics" / "device_idle.serve.py", "idle_s")
    assert idle.read(tr, ctx) == pytest.approx(100 * (1 - 300 / 500))
    lpr = run.load_module(run.BENCH / "metrics" / "launches_per_request.serve.py", "lpr")
    assert lpr.read(tr, ctx) == 1.0
    gaps = tr.breakdown()["idle_gaps"]
    assert gaps[0][1] == pytest.approx(300e-6) and gaps[0][0] == "host"


def test_trace_reading_fails_on_a_lost_kernel():
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench.window", "ts": 0, "dur": 100, "tid": 1},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 10, "dur": 1,
           "tid": 1, "args": {"correlation": 7}},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 20, "dur": 1,
           "tid": 1, "args": {"correlation": 8}},
          {"ph": "X", "cat": "kernel", "name": "k", "ts": 30, "dur": 5, "args": {"correlation": 7}}]
    with pytest.raises(tracing.TraceIncomplete):
        tracing.Trace.from_events(ev, 1, {})
    ev.append({"ph": "X", "cat": "kernel", "name": "k2", "ts": 40, "dur": 5,
               "args": {"correlation": 8}})
    tr = tracing.Trace.from_events(ev, 1, {})
    assert len(tr.kernels) == 2 and tr.window_s == pytest.approx(1e-4)


def test_a_new_cell_needs_only_files(tmp_path, monkeypatch):
    """A cell added by data alone: a BENCHMARK.json entry, a mix and a
    workload file are all the harness needs to resolve it."""
    bench = run.read_json(run.ROOT / "BENCHMARK.json")
    extra = dict(bench)
    extra["workloads"] = bench["workloads"] + [
        {"name": "mlp149.corpus_small", "config": "mlp149", "traffic": "corpus_905", "chips": 1,
         "why": "a test cell"}]
    f = tmp_path / "BENCHMARK.json"
    f.write_text(json.dumps(extra))
    wl = run.BENCH / "workloads" / "mlp149.corpus_small.json"
    monkeypatch.setattr(run, "read_json", lambda p: (
        {"clips": 4, "limits": {"mfcc_gap": 1.0}} if p == wl else json.loads(open(p).read())))
    ctx = run.Ctx("mlp149.corpus_small", 1, 1.0, False, "cpu", bench_file=f)
    assert ctx.params["kind"] == "corpus_pass" and ctx.params["clips"] == 4
    assert [m["name"] for m in ctx.per_layer()] == []  # listed metrics name their cells


def test_run_reads_only_benchmark_json():
    """A cell that only benchmark/candidates.json holds is not a cell of
    run.py's command line; the tools reach it through `bench_file`."""
    with pytest.raises(KeyError):
        run.Ctx("vote.serve", 1, 1.0, False, "cpu")
    assert run.Ctx("vote.serve", 1, 1.0, False, "cpu", bench_file=CANDIDATES).chips == 1


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    import stutter_tpu_torch  # noqa: F401  the port passes

    assert "stutter_tpu_torch" not in run.forbidden_modules()
    monkeypatch.setitem(__import__("sys").modules, "stutter_tpu.ops", types.ModuleType("x"))
    assert "stutter_tpu" in run.forbidden_modules()

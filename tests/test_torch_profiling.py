"""The port's timing and trace primitives (stutter_tpu_torch/utils/profiling.py)
against the JAX package's: block_and_time keeps the JAX contract (one warm
call, `iters` dispatches, host seconds per call), its `_sync` walks nested
outputs and waits for every CUDA device they touch, and `trace` writes a
trace a viewer reads.  The `gpu` cases skip without a CUDA device; on a GPU
machine without JAX run

    python -m pytest tests/test_torch_profiling.py -m gpu --noconftest -q
"""

import dataclasses
import glob
import gzip
import json
import os

import numpy as np
import pytest
import torch

from stutter_tpu_torch.utils import profiling as P


def _counting(out):
    calls = []

    def fn(*args, **kwargs):
        calls.append((args, kwargs))
        return out

    return fn, calls


@pytest.mark.parametrize("iters", [1, 4])
def test_block_and_time_calls_fn_iters_plus_one_times_like_the_jax_package(iters):
    from stutter_tpu.utils import profiling as J

    x = np.random.RandomState(0).randn(8, 3).astype(np.float32)
    ours, ours_calls = _counting(torch.from_numpy(x) * 2)
    theirs, theirs_calls = _counting(x * 2)
    t = P.block_and_time(ours, x, iters=iters, scale=2)
    tj = J.block_and_time(theirs, x, iters=iters, scale=2)
    assert len(ours_calls) == len(theirs_calls) == iters + 1
    assert all(a[0] is x and k == {"scale": 2} for a, k in ours_calls)
    assert isinstance(t, float) and t > 0 and isinstance(tj, float) and tj > 0


@dataclasses.dataclass
class _Out:
    feats: torch.Tensor
    extra: dict


@pytest.mark.parametrize("out", [
    (torch.ones(2), [np.zeros(3), {"a": torch.zeros(1), "b": (1.5, "label")}]),
    {"label": "block", "proba": {"block": 0.7, "fluent": 0.3}},
    np.arange(5.0),
    _Out(torch.ones(3), {"n": np.int32(4), "none": None}),
], ids=["nested_tuple", "dict", "numpy", "dataclass"])
def test_sync_accepts_nested_host_outputs(out):
    """Host values and CPU tensors hold no CUDA device: nothing to wait for,
    and block_and_time over them is a positive time (the JAX package's
    `_sync` takes the same numpy output)."""
    from stutter_tpu.utils import profiling as J

    assert P._cuda_devices(out, set()) == set()
    P._sync(out)
    fn, calls = _counting(out)
    assert P.block_and_time(fn, iters=3) > 0 and len(calls) == 4
    if isinstance(out, np.ndarray):
        J._sync(out)


@pytest.mark.parametrize("out", [torch.empty(2, device="meta"), [object()]],
                         ids=["meta_tensor", "unknown_leaf"])
def test_sync_refuses_an_output_it_cannot_place(out):
    """A leaf whose device is unknown is never skipped silently."""
    with pytest.raises(TypeError, match="cannot"):
        P._sync(out)
    with pytest.raises(TypeError, match="cannot"):
        P.block_and_time(lambda: out, iters=1)


def _trace_files(logdir):
    return sorted(glob.glob(os.path.join(logdir, "**", "*trace.json*"), recursive=True))


def _read_trace(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def test_trace_on_the_cpu_writes_one_parseable_trace_like_the_jax_package(tmp_path):
    """Each package's trace of the same seeded product is one file under its
    logdir that parses as a Chrome trace (a `traceEvents` list); the port's
    holds the CPU op it ran."""
    import jax.numpy as jnp

    from stutter_tpu.utils import profiling as J

    x = np.random.RandomState(1).randn(64, 64).astype(np.float32)
    with P.trace(str(tmp_path / "ours"), device="cpu") as prof:
        t = torch.from_numpy(x)
        ours = (t @ t).sum()
    with J.trace(str(tmp_path / "theirs")):
        theirs = (jnp.asarray(x) @ jnp.asarray(x)).sum().block_until_ready()
    assert abs(float(ours) - float(theirs)) <= 1e-3 * abs(float(theirs))
    assert prof is not None
    for logdir in ("ours", "theirs"):
        files = _trace_files(str(tmp_path / logdir))
        assert len(files) == 1, files
        assert isinstance(_read_trace(files[0])["traceEvents"], list)
    events = _read_trace(_trace_files(str(tmp_path / "ours"))[0])["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


def test_trace_asks_for_cuda_by_default_and_raises_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device traces it")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        with P.trace(str(tmp_path / "t")):
            pass
    assert _trace_files(str(tmp_path)) == []


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    from stutter_tpu_torch.device import resolve_device

    return resolve_device("cuda")


@pytest.mark.gpu
def test_sync_waits_for_every_cuda_device_of_the_output(cuda, monkeypatch):
    """An output with a tensor on each visible GPU (and one on the CPU) is
    synchronised on each of those GPUs, not only on the current one."""
    devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    out = {"shards": [torch.ones(4, device=d) for d in devs], "host": torch.ones(1)}
    seen = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: (seen.append(d), real(d)))
    P._sync(out)
    assert sorted(d.index for d in seen) == [d.index for d in devs]


@pytest.mark.gpu
def test_block_and_time_covers_the_device_time_of_a_kernel(cuda):
    """The front end's kernels at B=16 x 3 s: block_and_time is no shorter
    than the device time torch.profiler reads for the same call."""
    from torch.profiler import ProfilerActivity, profile

    from stutter_tpu_torch.ops.frontend import extract_features_149_batch

    rng = np.random.RandomState(2)
    audio = torch.from_numpy((0.2 * rng.randn(16, 49152)).astype(np.float32)).to(cuda)
    lengths = torch.full((16,), 48000, dtype=torch.int32, device=cuda)
    t = P.block_and_time(extract_features_149_batch, audio, lengths, iters=5)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        extract_features_149_batch(audio, lengths)
        torch.cuda.synchronize()
    device_s = sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
    assert device_s > 0 and t >= 0.9 * device_s


@pytest.mark.gpu
def test_trace_on_the_card_records_the_kernels(cuda, tmp_path):
    """trace() on `cuda` records a device event for each of spectromel's
    three kernels and chroma_stats's one, once per wrapper launch."""
    from stutter_tpu_torch.ops.chroma_stats import chroma_stats
    from stutter_tpu_torch.ops.frontend import extract_features_149_batch
    from stutter_tpu_torch.ops.spectromel import spectromel

    rng = np.random.RandomState(3)
    audio = torch.from_numpy((0.2 * rng.randn(4, 49152)).astype(np.float32)).to(cuda)
    lengths = torch.full((4,), 48000, dtype=torch.int32, device=cuda)
    extract_features_149_batch(audio, lengths)
    before = spectromel.launches, chroma_stats.launches
    with P.trace(str(tmp_path)):
        extract_features_149_batch(audio, lengths)
    assert (spectromel.launches, chroma_stats.launches) == (before[0] + 1, before[1] + 1)
    (path,) = _trace_files(str(tmp_path))
    names = [e["name"] for e in _read_trace(path)["traceEvents"] if e.get("cat") == "kernel"]
    for k in ("spectromel_frames", "spectromel_stats", "tuning_tail", "chroma_stats_kernel"):
        assert sum(k in n for n in names) == 1, (k, names)


def test_trace_mesh_summary_reads_device_and_runtime_time(tmp_path):
    """tools.trace_mesh.summarize on a trace of known events: per device the
    kernels' and copies' ms and first / last offsets from the first host
    op, and the runtime calls by host ms."""
    from stutter_tpu_torch.tools.trace_mesh import summarize

    def x(cat, name, ts, dur, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}

    events = [x("cpu_op", "aten::to", 1000, 50),
              x("cuda_runtime", "cudaMemcpyAsync", 1010, 30),
              x("cuda_runtime", "cudaLaunchKernel", 1060, 5),
              x("cuda_runtime", "cudaLaunchKernel", 1070, 5),
              x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 1020, 200, device=0),
              x("kernel", "void gate_analysis<512>(float const*)", 1300, 100, device=0),
              x("kernel", "void gate_synth<512>(float const*)", 1500, 300, device=1),
              x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 2000, 100, device=1),
              {"ph": "i", "cat": "cpu_instant_event", "name": "marker", "ts": 5000}]
    path = tmp_path / "t.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = summarize(str(path))
    assert s["span_ms"] == pytest.approx(1.1)
    assert s["devices"]["0"] == pytest.approx({"kernel_ms": 0.1, "h2d_ms": 0.2, "d2h_ms": 0.0,
                                               "other_ms": 0.0, "first_ms": 0.02,
                                               "last_ms": 0.4})
    assert s["devices"]["1"]["kernel_ms"] == pytest.approx(0.3)
    assert s["devices"]["1"]["d2h_ms"] == pytest.approx(0.1)
    assert s["devices"]["1"]["last_ms"] == pytest.approx(1.1)
    assert s["runtime_top"][0][0] == "cudaMemcpyAsync" and s["runtime_top"][1][2] == 2


def test_trace_mesh_summary_leaves_out_the_window_opening(tmp_path):
    """A trace from utils.profiling.trace opens on profile_window's burst
    and its synchronize: summarize reads the same numbers as without
    them."""
    from stutter_tpu_torch.tools.trace_mesh import summarize

    def x(cat, name, ts, dur, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}

    region = [x("cpu_op", "aten::to", 1000, 50),
              x("cuda_runtime", "cudaLaunchKernel", 1060, 5),
              x("kernel", "void gate_synth<512>(float const*)", 1500, 300, device=1)]
    opening = [x("cuda_runtime", "cudaLaunchKernel", 100, 5),
               x("kernel", "void at::cuda::(anonymous namespace)::spin_kernel(long)", 110, 1,
                 device=0),
               x("cpu_op", "aten::empty", 120, 2),
               x("cuda_runtime", "cudaDeviceSynchronize", 130, 20)]
    out = []
    for name, events in (("plain", region), ("opened", opening + region)):
        path = tmp_path / f"{name}.pt.trace.json"
        path.write_text(json.dumps({"traceEvents": events}))
        out.append(summarize(str(path)))
    assert out[0] == out[1]
    assert list(out[1]["devices"]) == ["1"] and out[1]["runtime_top"] == [
        ["cudaLaunchKernel", 0.005, 1]]


def test_trace_counts_device_kernels_against_kernel_launches():
    """The check behind trace()'s refusal of a trace that lost device
    events: kernels on the device (not copies, sets or user annotations)
    against the host's launch calls (not cudaLaunchHostFunc)."""
    from types import SimpleNamespace

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(name, dev, annotation=False):
        return SimpleNamespace(name=name, device_type=dev, is_user_annotation=annotation)

    events = [ev("cudaLaunchKernel", cpu), ev("cudaLaunchKernelExC", cpu),
              ev("cuLaunchKernel", cpu), ev("cudaLaunchHostFunc", cpu), ev("aten::add", cpu),
              ev("cudaMemcpyAsync", cpu), ev("void gate_synth<512>(float const*)", cuda),
              ev("chroma_stats_kernel", cuda), ev("Memcpy HtoD (Pageable -> Device)", cuda),
              ev("Memset (Device)", cuda), ev("Optimizer.step#Adam.step", cuda, True)]
    assert P._kernels_and_launches(events) == (2, 3)
    assert P._kernels_and_launches(events + [ev("sm90_gemm", cuda)]) == (3, 3)
    with pytest.raises(P.TraceIncomplete):
        P.check_complete(events, "this profile")
    assert P.check_complete(events + [ev("sm90_gemm", cuda)], "this profile") == (3, 3)
    # profile_window's burst: its kernels are not counted, its launches
    # are taken off the count, so losing them does not fail the window
    burst = [ev("cudaLaunchKernel", cpu)] * 4 + [
        ev("void at::cuda::(anonymous namespace)::spin_kernel(long)", cuda)] * 2
    assert P._kernels_and_launches(events + burst) == (2, 7)
    assert P.check_complete(events + burst + [ev("sm90_gemm", cuda)], "this profile",
                            burst=4) == (3, 3)
    with pytest.raises(P.TraceIncomplete):
        P.check_complete(events + burst, "this profile", burst=4)


@pytest.mark.parametrize("cuda", [False, True])
def test_profile_window_opens_a_device_window_on_a_pad_and_a_burst(monkeypatch, cuda):
    """profile_window sleeps WINDOW_PAD_S, launches WINDOW_BURST one-cycle
    kernels and synchronises before the region of a window that records
    CUDA activity, and sleeps WINDOW_PAD_S after it; a CPU-only window
    runs the region alone."""
    import contextlib

    from torch.profiler import ProfilerActivity

    log = []

    @contextlib.contextmanager
    def fake_profile(activities, **kwargs):
        log.append(("start", tuple(activities), kwargs))
        yield "prof"
        log.append(("stop",))

    monkeypatch.setattr(torch.profiler, "profile", fake_profile)
    monkeypatch.setattr(P.time, "sleep", lambda s: log.append(("sleep", s)))
    monkeypatch.setattr(torch.cuda, "_sleep", lambda cycles: log.append(("burst", cycles)))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: log.append(("sync",)))
    acts = [ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * cuda
    with P.profile_window(acts, record_shapes=True) as prof:
        log.append(("region", prof))
    opening = [("sleep", P.WINDOW_PAD_S)] + [("burst", 1)] * P.WINDOW_BURST + [("sync",)]
    assert log == [("start", tuple(acts), {"record_shapes": True}), *opening * cuda,
                   ("region", "prof"), *[("sleep", P.WINDOW_PAD_S)] * cuda, ("stop",)]
    assert P.WINDOW_PAD_S > 0 and P.WINDOW_BURST > 0

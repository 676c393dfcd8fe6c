"""Timing and tracing (counterpart of stutter_tpu/utils/profiling.py):

  * span(name) / count(name, n) -- the port's own spans and counters,
    recorded only while a torch profiler records (`tracing()`): a span is
    a record_function range "stp.<name>" in the profiler's trace, on the
    clock of its kernels and copies, and is kept in memory too
    (`spans()`); a counter adds to an in-memory table (`counters()`).
    With no profiler recording, each costs one flag check.
  * StageTimer -- per-stage wall-clock counters (each stage a span); the
    corpus entry points log a stage report to the
    `stutter_tpu_torch.profiling` logger.
  * trace(logdir, device) -- torch.profiler over the wrapped region, CUDA
    activity included on a CUDA device; writes a trace that TensorBoard's
    profiler plugin and a Chrome-trace viewer (chrome://tracing, Perfetto)
    open.
  * profile_window(activities) -- torch.profiler.profile whose device
    window opens on idle host time and a burst of tiny kernels, so the
    region's kernels are not lost; check_complete(events) raises
    TraceIncomplete when a profile lost some all the same.
  * block_and_time(fn, ...) -- host seconds per call of `fn`, its output
    synchronised on every CUDA device that holds a tensor of it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import threading
import time
from collections import defaultdict

import numpy as np
import torch
import torch.autograd.profiler as autograd_profiler

from stutter_tpu_torch.device import resolve_device

log = logging.getLogger("stutter_tpu_torch.profiling")

SPAN_PREFIX = "stp."


def tracing() -> bool:
    """Whether a torch profiler is recording (trace(), profile_window, or
    any torch.profiler.profile): the port's spans and counters record only
    then."""
    return autograd_profiler._is_profiler_enabled


@dataclasses.dataclass(frozen=True)
class SpanRecord:
    """One span kept in memory: its name (without SPAN_PREFIX), its start
    and end on the host's monotonic clock (time.perf_counter_ns), taken
    inside its record_function range, and its thread's native id (the
    `tid` of the range in the profiler's trace)."""

    name: str
    start_ns: int
    end_ns: int
    tid: int


class _Record:
    """The process's spans and counters, under a lock: the service's
    threads call the corpus path too (infer's denoise_clips)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.counts: dict[str, int] = defaultdict(int)
        self.spans: list[SpanRecord] = []


_RECORD = _Record()
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "range", "start_ns")

    def __init__(self, name: str):
        self.name = name
        self.range = torch.profiler.record_function(SPAN_PREFIX + name)

    def __enter__(self):
        self.range.__enter__()
        self.start_ns = time.perf_counter_ns()

    def __exit__(self, *exc):
        end_ns = time.perf_counter_ns()
        self.range.__exit__(*exc)
        rec = SpanRecord(self.name, self.start_ns, end_ns, threading.get_native_id())
        with _RECORD.lock:
            _RECORD.spans.append(rec)


def span(name: str):
    """A span over the wrapped block while a profiler records (a
    record_function range "stp.<name>", also kept in memory); otherwise a
    shared no-op context."""
    if not autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def count(name: str, n) -> None:
    """Add `n` to the counter `name` ("<owner>.<counter>") while a profiler
    records; otherwise nothing."""
    if autograd_profiler._is_profiler_enabled:
        with _RECORD.lock:
            _RECORD.counts[name] += int(n)


def counters() -> dict[str, int]:
    """A snapshot of every counter counted in this process."""
    with _RECORD.lock:
        return dict(_RECORD.counts)


def spans() -> list[SpanRecord]:
    """A snapshot of every span recorded in this process, in the order they
    ended."""
    with _RECORD.lock:
        return list(_RECORD.spans)


class StageTimer:
    """Accumulates wall-clock per named stage; thread-unsafe by design (cheap)."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        lines = [f"{'stage':28s} {'total_s':>9s} {'calls':>6s} {'per_call_ms':>12s}"]
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:28s} {total:9.3f} {n:6d} {total / n * 1000:12.2f}")
        return "\n".join(lines)

    def log_report(self):
        for line in self.report().splitlines():
            log.info(line)


# On the H100 machine this repo is measured on, torch.profiler loses the
# first kernels of a window, a few more the longer the process has run
# (PERF.md §6, Findings; a window of chip_smoke.py's phase 2 once held
# no `tuning_tail`), and idle host time before the region alone does not
# keep them.  A window with device activity therefore opens on
# WINDOW_PAD_S of idle host time and a burst of WINDOW_BURST launches of
# torch's one-cycle BURST_KERNEL (torch.cuda._sleep), which the loss takes
# in place of the region's kernels, and closes on WINDOW_PAD_S more; the
# counts here leave the burst out.
WINDOW_PAD_S = 0.25
WINDOW_BURST = 1024
BURST_KERNEL = "spin_kernel"


class TraceIncomplete(RuntimeError):
    """A profile holds fewer device kernels than the kernel launches the
    host made in it: the profiler lost device events."""


@contextlib.contextmanager
def profile_window(activities, **kwargs):
    """torch.profiler.profile(activities, **kwargs); when it records CUDA
    activity, the region runs between WINDOW_PAD_S of host sleep and a
    burst of WINDOW_BURST BURST_KERNEL launches on the current device at
    its start, and WINDOW_PAD_S of sleep at its end.  Yields the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    cuda = ProfilerActivity.CUDA in activities
    with profile(activities=activities, **kwargs) as prof:
        if cuda:
            time.sleep(WINDOW_PAD_S)
            for _ in range(WINDOW_BURST):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
        try:
            yield prof
        finally:
            if cuda:
                time.sleep(WINDOW_PAD_S)


def check_complete(events, what: str, burst: int = 0) -> tuple[int, int]:
    """(device kernels, kernel launches) of a profile's events, the
    window's `burst` launches (profile_window's WINDOW_BURST) and their
    kernels left out; raises TraceIncomplete when kernels are missing."""
    kernels, launches = _kernels_and_launches(events)
    launches -= burst
    if kernels < launches:
        raise TraceIncomplete(f"{what} holds {kernels} device kernels for {launches} kernel "
                              "launches: the profiler lost device events")
    return kernels, launches


@contextlib.contextmanager
def trace(logdir: str, device: torch.device | str = "cuda"):
    """torch.profiler trace of the wrapped region (view in TensorBoard:
    `tensorboard --logdir LOGDIR`, or open the file in chrome://tracing or
    Perfetto).  Records CPU activity, and CUDA activity on a CUDA device:
    `cuda` raises without a GPU or without CUDA tracing, never recording a
    CPU-only trace in its place.  The window is profile_window's (its
    burst of BURST_KERNEL launches is in the file), every visible GPU is
    synchronised before the trace stops, so kernels still queued are in
    it, and a trace that holds fewer device kernels than the region's
    kernel launches raises TraceIncomplete after it is written.  The file lands in `logdir` as
    <host>_<pid>.<ms>.pt.trace.json; the counters the region counted are
    logged to the `stutter_tpu_torch.profiling` logger.  Yields the
    profiler."""
    from torch.profiler import ProfilerActivity, tensorboard_trace_handler

    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        if ProfilerActivity.CUDA not in torch.profiler.supported_activities():
            raise RuntimeError("this torch build cannot trace CUDA activity")
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    before = counters()
    with profile_window(activities, on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        try:
            yield prof
        finally:
            if dev.type == "cuda":
                for i in range(torch.cuda.device_count()):
                    torch.cuda.synchronize(i)
    counted = {k: v - before.get(k, 0) for k, v in counters().items() if v != before.get(k, 0)}
    log.info("counters of the trace in %s: %s", logdir, counted)
    if dev.type == "cuda":
        check_complete(prof.events(), f"the trace in {logdir}", WINDOW_BURST)


def _kernels_and_launches(events) -> tuple[int, int]:
    """(device kernels, host-side kernel-launch calls) among a profile's
    events: every launch the runtime records runs one kernel."""
    kernels = launches = 0
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # a user annotation (an optimizer's step range) lies on the
            # device's timeline too, over the kernels it encloses
            kernels += not (e.name.startswith(("Memcpy", "Memset")) or BURST_KERNEL in e.name
                            or getattr(e, "is_user_annotation", False))
        elif e.name.startswith(("cudaLaunch", "cuLaunch")) and "HostFunc" not in e.name:
            launches += 1
    return kernels, launches


def block_and_time(fn, *args, iters: int = 10, **kwargs) -> float:
    """Host seconds per call of `fn(*args, **kwargs)`: one warm call and a
    sync, `iters` dispatches, one final sync of the last output (`_sync`)."""
    out = fn(*args, **kwargs)
    _sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kwargs)
    _sync(out)
    return (time.perf_counter() - t0) / iters


_HOST_LEAVES = (np.ndarray, np.generic, int, float, complex, bool, str, bytes, type(None))


def _cuda_devices(out, found: set) -> set:
    """The CUDA devices that hold a tensor of `out`, walking tuples, lists,
    dicts and dataclasses; raises on a leaf it cannot place."""
    if isinstance(out, torch.Tensor):
        if out.device.type == "cuda":
            found.add(out.device)
        elif out.device.type != "cpu":
            raise TypeError(f"cannot synchronise a tensor on {out.device}")
    elif isinstance(out, (tuple, list)):
        for v in out:
            _cuda_devices(v, found)
    elif isinstance(out, dict):
        for v in out.values():
            _cuda_devices(v, found)
    elif dataclasses.is_dataclass(out) and not isinstance(out, type):
        for f in dataclasses.fields(out):
            _cuda_devices(getattr(out, f.name), found)
    elif not isinstance(out, _HOST_LEAVES):
        raise TypeError(f"cannot tell where an output of type {type(out).__name__} lives")
    return found


def _sync(out) -> None:
    """Wait for every CUDA device that holds a tensor of `out` (a launch
    acts on its own device, so the current one alone is not enough); host
    values and CPU tensors are ready already."""
    for dev in _cuda_devices(out, set()):
        torch.cuda.synchronize(dev)

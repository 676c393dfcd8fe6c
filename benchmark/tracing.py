"""Traced runs: the profiler window and the reading of its device timeline.

`profile_window` and `check_complete` are copies of the port's
utils/profiling.py: on the H100 machines this benchmark runs on,
torch.profiler loses the first kernels of a window, so a window opens on
idle host time and a burst of `spin_kernel` launches that the loss takes,
and a window that still holds fewer device kernels than kernel launches
fails the run (a lost kernel must fail it, not thin it).

`Trace.read` turns the profiler's Chrome trace into what the per-layer
readers need: the device kernels (with the host thread and time of their
launch), the benchmark's own spans (`span(name)`, a record_function
range), and the region of interest, the span "bench.window".
"""

from __future__ import annotations

import contextlib
import dataclasses
import gzip
import json
import os
import tempfile
import time

import torch

WINDOW_PAD_S = 0.25
WINDOW_BURST = 1024
BURST_KERNEL = "spin_kernel"
REGION = "bench.window"


class TraceIncomplete(RuntimeError):
    """A profile holds fewer device kernels than kernel launches."""


@contextlib.contextmanager
def profile_window():
    """torch.profiler over CPU and CUDA activity; the region runs between
    WINDOW_PAD_S of host sleep and a burst of WINDOW_BURST BURST_KERNEL
    launches at its start, and WINDOW_PAD_S of sleep at its end."""
    from torch.profiler import ProfilerActivity, profile

    kwargs = {}
    try:  # the launches of every thread: a server launches from its own threads
        kwargs["experimental_config"] = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except (AttributeError, TypeError):
        pass
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], **kwargs) as prof:
        time.sleep(WINDOW_PAD_S)
        for _ in range(WINDOW_BURST):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        try:
            yield prof
        finally:
            for i in range(torch.cuda.device_count()):
                torch.cuda.synchronize(i)
            time.sleep(WINDOW_PAD_S)


def check_complete(kernels: int, launches: int, what: str) -> None:
    if kernels < launches:
        raise TraceIncomplete(f"{what} holds {kernels} device kernels for {launches} kernel "
                              "launches: the profiler lost device events")


def span(name: str):
    """A benchmark span around a call into one layer (a record_function
    range on the calling thread)."""
    return torch.profiler.record_function(name)


@dataclasses.dataclass
class Kernel:
    name: str
    start: float  # us, the trace's clock
    end: float
    device: int
    launch_ts: float | None  # the host launch call's time and thread
    launch_tid: int | None


@dataclasses.dataclass
class Span:
    name: str
    start: float
    end: float
    tid: int


@dataclasses.dataclass
class Trace:
    kernels: list  # Kernel, inside the region, the burst left out
    spans: list  # Span, the benchmark's own
    region: tuple  # (start, end) us
    devices: int  # devices the run uses
    counters: dict  # what the traffic counted inside the region

    @property
    def window_s(self) -> float:
        return (self.region[1] - self.region[0]) * 1e-6

    def busy_s(self, intervals=None) -> float:
        """Seconds in which a kernel ran, per device, averaged over the
        run's devices; `intervals` ([(start, end)] us) clips the timeline
        to their union."""
        total = 0.0
        for d in range(self.devices):
            ivs = sorted((k.start, k.end) for k in self.kernels if k.device == d)
            total += _union_len(_clip(_merge(ivs), intervals) if intervals else _merge(ivs))
        return total * 1e-6 / self.devices

    def in_spans(self, name: str) -> list:
        """The kernels whose launch lies inside a span called `name` on the
        launching thread."""
        spans = [s for s in self.spans if s.name == name]
        out = []
        for k in self.kernels:
            if k.launch_ts is None:
                continue
            if any(s.tid == k.launch_tid and s.start <= k.launch_ts <= s.end for s in spans):
                out.append(k)
        return out

    def spans_named(self, name: str) -> list:
        return [s for s in self.spans if s.name == name]

    @classmethod
    def read(cls, prof, devices: int, counters: dict) -> "Trace":
        """The profile's Chrome trace, written to a temporary file, read and
        deleted."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            opener = gzip.open if path.endswith(".gz") else open
            with opener(path, "rt") as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        return cls.from_events(events, devices, counters)

    @classmethod
    def from_events(cls, events: list, devices: int, counters: dict) -> "Trace":
        launches, kernels, spans = {}, [], []
        n_launch = 0
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, name = e.get("cat", ""), e.get("name", "")
            if cat in ("cuda_runtime", "cuda_driver"):
                if name.startswith(("cudaLaunch", "cuLaunch")) and "HostFunc" not in name:
                    corr = e.get("args", {}).get("correlation")
                    launches[corr] = (float(e["ts"]), e.get("tid"))
            elif cat == "kernel":
                kernels.append(e)
            elif cat == "user_annotation" and name.startswith("bench."):
                spans.append(Span(name, float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                                  e.get("tid")))
        regions = [s for s in spans if s.name == REGION]
        if len(regions) != 1:
            raise TraceIncomplete(f"{len(regions)} '{REGION}' spans in the trace")
        r0, r1 = regions[0].start, regions[0].end
        out = []
        for e in kernels:
            if BURST_KERNEL in e["name"]:
                continue
            corr = e.get("args", {}).get("correlation")
            ts, tid = launches.get(corr, (None, None))
            start, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            inside = (ts if ts is not None else start)
            if r0 <= inside <= r1:
                out.append(Kernel(e["name"], start, end, int(e.get("args", {}).get("device", 0)),
                                  ts, tid))
        n_launch = sum(1 for ts, _ in launches.values() if r0 <= ts <= r1)
        check_complete(sum(1 for k in out if k.launch_ts is not None), n_launch,
                       "the traced window")
        counters = {**counters, "trace_events": {"kernels": len(kernels), "launches": len(launches),
                                                 "spans": len(spans), "in_region": len(out)}}
        return cls(out, spans, (r0, r1), devices, counters)

    def breakdown(self) -> dict:
        """The ten device operations that took most time, and the ten
        longest idle gaps on device 0, each named by the benchmark span
        the host was in at the gap's middle ("host" outside every span)."""
        by_name: dict = {}
        for k in self.kernels:
            by_name[k.name] = by_name.get(k.name, 0.0) + (k.end - k.start) * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        ivs = _merge(sorted((k.start, k.end) for k in self.kernels if k.device == 0))
        gaps = []
        prev = self.region[0]
        for s, e in ivs + [(self.region[1], self.region[1])]:
            if s > prev:
                mid = 0.5 * (prev + s)
                inner = [sp for sp in self.spans if sp.name != REGION and sp.start <= mid <= sp.end]
                label = min(inner, key=lambda sp: sp.end - sp.start).name if inner else "host"
                gaps.append((label, (s - prev) * 1e-6))
            prev = max(prev, e)
        gaps.sort(key=lambda g: -g[1])
        return {"device_ops": [[n[:120], s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps[:10]]}


def _merge(ivs: list) -> list:
    out: list = []
    for s, e in ivs:
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _clip(ivs: list, within: list) -> list:
    """The parts of merged intervals `ivs` that lie inside the union of
    `within`."""
    within = _merge(sorted(within))
    out = []
    for s, e in ivs:
        for a, b in within:
            lo, hi = max(s, a), min(e, b)
            if hi > lo:
                out.append((lo, hi))
    return out


def _union_len(ivs: list) -> float:
    return sum(e - s for s, e in ivs)

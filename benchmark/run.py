"""The port's benchmark: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port (`stutter_tpu_torch`).  The
cell's entry in BENCHMARK.json names its configuration and its traffic; the
harness finds everything else by those names:

  benchmark/configs/<config>.json     the configuration, as it is run
  benchmark/mixes/<traffic>.json      the mix's parameters; `kind` names
  benchmark/traffic/<kind>.py         the code that drives that kind of mix
  benchmark/workloads/<cell>.json     the cell's own parameters and limits
  benchmark/metrics/<metric>.py       one reader per per-layer metric

A run sets up (inputs and weights from the seed, the program loaded and
warmed on every shape the cell uses), measures for --seconds, reads the
peak device memory, frees the program, checks what the timed path produced
against the plain reference (benchmark/reference), checks that no JAX
module was loaded, and prints one JSON line last: the end-to-end metrics
with --trace 0, the per-layer metrics (from a profiled part of the window)
with --trace 1.  The numbers compared, each beside its limit, are the last
lines on standard error and the result's last key.

Exit codes: 0 a result was printed (correct or not); 2 no CUDA device, or
fewer than the cell asks for; 3 a JAX module was loaded; anything else a
fault of the run.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up is counted from the process's first line

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "stutter_tpu")  # top-level module names
MISSING = 1e300  # a metric that failed requests made infinite


def load_module(path: Path, name: str):
    """A module of the benchmark found by name (file names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Ctx:
    """Everything a run knows: the cell, its files, the run's arguments."""

    def __init__(self, cell: str, seed: int, seconds: float, trace: bool, device: str,
                 overrides: dict | None = None, bench_file: Path | None = None):
        self.bench = read_json(bench_file or ROOT / "BENCHMARK.json")
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if cell not in cells:
            raise KeyError(f"no workload {cell!r} in BENCHMARK.json: {sorted(cells)}")
        self.cell = cells[cell]
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config_entry = configs[self.cell["config"]]
        self.config = read_json(ROOT / self.config_entry["file"])
        self.mix = read_json(BENCH / "mixes" / f"{self.cell['traffic']}.json")
        self.params = {**self.mix, **read_json(BENCH / "workloads" / f"{cell}.json"),
                       **(overrides or {})}
        self.name, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.device, self.chips = device, int(self.cell["chips"])

    def per_layer(self) -> list[dict]:
        """The per-layer metrics this cell reports."""
        return [m for m in self.bench["per_layer"]
                if self.name in m.get("workloads", [w["name"] for w in self.bench["workloads"]])]

    def end_to_end(self) -> list[dict]:
        return [m for m in self.bench["end_to_end"]
                if self.name in m.get("workloads", [w["name"] for w in self.bench["workloads"]])]


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout, so
    that only a checkout's first run builds."""
    cache = ROOT / ".bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
        os.makedirs(os.environ[var], exist_ok=True)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run(ctx: Ctx, require_chip: bool = True) -> tuple[int, dict | None]:
    """One run of ctx's cell -> (exit code, the result line's object)."""
    import torch

    if require_chip:
        if not torch.cuda.is_available() or torch.cuda.device_count() < ctx.chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"benchmark: {ctx.name} needs {ctx.chips} CUDA device(s), this machine has "
                  f"{n}", file=sys.stderr)
            return 2, None
    sys.path.insert(0, str(ROOT))
    kind = load_module(BENCH / "traffic" / f"{ctx.params['kind']}.py", f"traffic_{ctx.params['kind']}")
    state = kind.setup(ctx)
    setup_s = time.perf_counter() - T_START
    win = kind.window(ctx, state)
    on_card = ctx.device.startswith("cuda")
    peak = (max(torch.cuda.max_memory_allocated(d) for d in range(ctx.chips)) if on_card else 0)
    kind.release(ctx, state)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks = kind.compare(ctx, state)
    found = forbidden_modules()
    if found:
        print(f"benchmark: modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3, None

    failed = int(win["failed"])
    correct = failed == 0 and all(c["ok"] for c in checks)
    metrics = {}
    units = {m["name"]: m["unit"] for m in ctx.bench["end_to_end"] + ctx.bench["per_layer"]}
    if not ctx.trace:
        values = {**win["metrics"], "setup_s": setup_s}
        for m in ctx.end_to_end():
            v = values[m["name"]]
            if not math.isfinite(v):  # a tail over failed requests: JSON has no infinity
                print(f"benchmark: {m['name']} is {v} (failed requests)", file=sys.stderr)
                v = MISSING
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu" if on_card else ctx.device,
              "kind": torch.cuda.get_device_name(0) if on_card else ctx.device,
              "count": ctx.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(win["attempted"]), "failed": failed,
              "metrics": metrics, "device": device}
    tr = win.get("trace")
    if ctx.trace and tr is not None:
        for m in ctx.per_layer():
            reader = load_module(BENCH / "metrics" / f"{m['name']}.py", "metric_" + m["name"])
            value = reader.read(tr, ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": units[m["name"]]}
        device.update(busy_s=tr.busy_s(), window_s=tr.window_s)
        result["breakdown"] = tr.breakdown()
    if on_card:
        result["card"] = power_limit()
    win.setdefault("detail", {}).update(getattr(state, "notes", {}))
    if tr is not None:
        win["detail"]["trace_events"] = tr.counters.get("trace_events")
    for key, value in win.get("detail", {}).items():
        print(f"detail {key}: {json.dumps(value)}", file=sys.stderr)
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return 0, result


def main(argv=None, bench_file: Path | None = None) -> int:
    """The command line; `bench_file` (the tools' only) reads the cells
    from another file of BENCHMARK.json's format."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rate", type=float, default=None,
                    help="offered requests/s in place of the cell's (the knee sweep only)")
    args = ap.parse_args(argv)
    set_cache_dirs()
    overrides = {"rate": args.rate} if args.rate is not None else None
    ctx = Ctx(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", overrides,
              bench_file)
    code, result = run(ctx)
    if result is not None:
        sys.stderr.flush()
        print(json.dumps(result), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())

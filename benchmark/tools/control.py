"""The control of a cell: the plain reference in the precision below the
configuration's (TF32 where the configuration states FP32 with TF32 off),
put in the program's place and judged by the cell's own comparison, on
each seed at the cell's own size.  A sound limit lies below every reading
this prints.

    python3 benchmark/tools/control.py --workload mlp149.corpus --seeds 1 2 3

`--bench-file` names the file of BENCHMARK.json's format that holds the
cell (BENCHMARK.json by default; benchmark/candidates.json holds the cells
built but not yet declared, such as vote.serve).

Prints one JSON line per seed, the cell's limits beside the gaps.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(BENCH))

import run  # noqa: E402


def control_rows(ctx, seeds: list[int], n: int | None = None,
                 fault: str | None = None) -> list[dict]:
    """The control's gaps per seed, at the cell's check size unless `n`;
    `fault` names a fault planted in the reference in its place instead,
    for the kinds that plant one."""
    sys.path.insert(0, str(run.ROOT))
    kind = run.load_module(BENCH / "traffic" / f"{ctx.params['kind']}.py",
                           f"traffic_{ctx.params['kind']}")
    size = n or ctx.params.get("check_requests") or ctx.params.get("check_clips")
    return kind.control(ctx, seeds, size, **({"fault": fault} if fault else {}))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--bench-file", type=Path, default=run.ROOT / "BENCHMARK.json")
    ap.add_argument("--fault", default=None,
                    help="a fault planted in the reference (cv_grid: half_batch)")
    args = ap.parse_args()
    run.set_cache_dirs()
    ctx = run.Ctx(args.workload, args.seeds[0], 0, False, "cuda", bench_file=args.bench_file)
    ctx.seconds = args.seconds or ctx.bench["run_seconds"]
    for row in control_rows(ctx, args.seeds, fault=args.fault):
        print(json.dumps({**row, "limits": ctx.params["limits"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The knee sweep of an HTTP cell: one run of the cell at each offered
rate, each in a process of its own, and per rate the completed rate and
the latency of the first and the last quarter of the requests (a backlog
that grows across the window shows as a last quarter far above the
first).

    python3 benchmark/tools/sweep.py --workload vote.serve --seed 7 --seconds 10 \\
        --rates 60 80 100 120 --bench-file benchmark/candidates.json

`--bench-file` names the file of BENCHMARK.json's format that holds the
cell (BENCHMARK.json by default; benchmark/candidates.json holds the cells
built but not yet declared).  One run of such a cell, as run.py makes one:

    python3 benchmark/tools/sweep.py --child benchmark/candidates.json \\
        --workload mlp149.train --seed 7 --seconds 51 --trace 1

Prints one JSON line per rate.  The knee is the highest rate whose
requests completed keep up with the requests sent, with no backlog
growing; the cell's rate is written into its workload file by hand.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent


def child(argv: list[str]) -> int:
    """One run of the cell, in this process: run.py's command line with the
    cells read from the file named first."""
    sys.path.insert(0, str(BENCH))
    import run

    return run.main(argv[1:], bench_file=Path(argv[0]))


def main() -> int:
    if sys.argv[1:2] == ["--child"]:
        return child(sys.argv[2:])
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--bench-file", type=Path, default=BENCH.parent / "BENCHMARK.json")
    args = ap.parse_args()
    for i, rate in enumerate(args.rates):
        p = subprocess.run([sys.executable, __file__, "--child", str(args.bench_file.resolve()),
                            "--workload", args.workload,
                            "--seed", str(args.seed + i), "--seconds", str(args.seconds),
                            "--trace", "0", "--rate", str(rate)], capture_output=True, text=True)
        row = {"rate": rate, "rc": p.returncode}
        for line in p.stderr.splitlines():
            m = re.match(r"detail (\w+): (.*)", line)
            if m:
                row[m.group(1)] = json.loads(m.group(2))
        if p.returncode == 0 and p.stdout.strip():
            res = json.loads(p.stdout.strip().splitlines()[-1])
            row.update({k: v["value"] for k, v in res["metrics"].items()},
                       correct=res["correct"], failed=res["failed"])
        else:
            row["stderr"] = p.stderr[-2000:]
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The control on the card: the plain reference in TF32, in the program's
place, fails a limit of each cell at a size a test run holds (the cell's
own size: `python3 benchmark/tools/control.py --workload <cell> --seeds ...`)."""

import sys

import pytest

import run

sys.path.insert(0, str(run.BENCH / "tools"))
import control  # noqa: E402


@pytest.mark.gpu
@pytest.mark.parametrize("cell,registry,n", [
    ("vote.serve", run.BENCH / "candidates.json", 4),
    ("mlp149.corpus", run.ROOT / "BENCHMARK.json", 4),
    ("mlp149.train", run.BENCH / "candidates.json", None)])
def test_control_fails_a_limit(cuda, cell, registry, n):
    ctx = run.Ctx(cell, 0, 10.0, False, "cuda", bench_file=registry)
    lim = ctx.params["limits"]
    for row in control.control_rows(ctx, [101, 102, 103], n):
        assert any(row[k] > v for k, v in lim.items()), row

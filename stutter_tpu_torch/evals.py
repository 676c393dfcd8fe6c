"""CSV output of the corpus path (counterpart of the CSV writer in
stutter_tpu/evals.py): plain comma-separated rows, a cell quoted only when
it holds a comma or a quote, so both packages write the same bytes."""

from __future__ import annotations

import os


def write_csv(path: str, header: list[str], rows: list[list]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(",".join(str(h) for h in header) + "\n")
        for r in rows:
            f.write(",".join(_csv_cell(v) for v in r) + "\n")


def _csv_cell(v) -> str:
    s = str(v)
    if "," in s or '"' in s:
        s = '"' + s.replace('"', '""') + '"'
    return s

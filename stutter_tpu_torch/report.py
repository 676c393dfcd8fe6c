"""Dependency-free HTML/SVG report generation (counterpart of
stutter_tpu/report.py): the same bytes for the same inputs.

The reference renders Plotly charts in Streamlit and exports roc_*.html
(ref: pipeline1.py:291-347, 553, 563).  This module emits self-contained
HTML with inline SVG -- ROC curves, confusion heatmaps, bar charts -- with no
plotting dependency, written alongside the CSV artifacts.
"""

from __future__ import annotations

import html
from pathlib import Path

import numpy as np

_COLORS = [
    "#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd",
    "#8c564b", "#e377c2", "#7f7f7f", "#bcbd22", "#17becf",
]

_W, _H, _PAD = 640, 480, 48


def _svg_open(title: str) -> list[str]:
    return [
        f'<svg viewBox="0 0 {_W} {_H}" xmlns="http://www.w3.org/2000/svg" '
        f'font-family="sans-serif" font-size="12">',
        f'<text x="{_W/2}" y="20" text-anchor="middle" font-size="15">{html.escape(title)}</text>',
    ]


def _axes(xlabel: str, ylabel: str) -> list[str]:
    x0, y0, x1, y1 = _PAD, _H - _PAD, _W - _PAD, _PAD
    out = [
        f'<line x1="{x0}" y1="{y0}" x2="{x1}" y2="{y0}" stroke="#333"/>',
        f'<line x1="{x0}" y1="{y0}" x2="{x0}" y2="{y1}" stroke="#333"/>',
        f'<text x="{(x0 + x1) / 2}" y="{_H - 10}" text-anchor="middle">{html.escape(xlabel)}</text>',
        f'<text x="14" y="{(y0 + y1) / 2}" text-anchor="middle" '
        f'transform="rotate(-90 14 {(y0 + y1) / 2})">{html.escape(ylabel)}</text>',
    ]
    for frac in (0.0, 0.25, 0.5, 0.75, 1.0):
        xx = x0 + frac * (x1 - x0)
        yy = y0 - frac * (y0 - y1)
        out.append(f'<text x="{xx}" y="{y0 + 16}" text-anchor="middle">{frac:g}</text>')
        out.append(f'<text x="{x0 - 8}" y="{yy + 4}" text-anchor="end">{frac:g}</text>')
    return out


def _polyline(xs, ys, color: str) -> str:
    x0, y0, x1, y1 = _PAD, _H - _PAD, _W - _PAD, _PAD
    pts = " ".join(
        f"{x0 + float(x) * (x1 - x0):.1f},{y0 - float(y) * (y0 - y1):.1f}"
        for x, y in zip(xs, ys)
    )
    return f'<polyline points="{pts}" fill="none" stroke="{color}" stroke-width="1.6"/>'


def roc_svg(curves: list[dict], title: str = "Multi-Class ROC") -> str:
    """curves: [{label, fpr: array, tpr: array, auc: float}, ...] -> SVG string."""
    parts = _svg_open(title) + _axes("False Positive Rate", "True Positive Rate")
    parts.append(_polyline([0, 1], [0, 1], "#999").replace('stroke-width="1.6"',
                 'stroke-width="1" stroke-dasharray="4 3"'))
    for i, c in enumerate(curves):
        color = _COLORS[i % len(_COLORS)]
        parts.append(_polyline(c["fpr"], c["tpr"], color))
        parts.append(
            f'<text x="{_W - _PAD - 4}" y="{_PAD + 16 + 14 * i}" text-anchor="end" '
            f'fill="{color}">{html.escape(c["label"])} (AUC {c["auc"]:.2f})</text>'
        )
    parts.append("</svg>")
    return "\n".join(parts)


def confusion_svg(cm: np.ndarray, class_names: list[str], title: str) -> str:
    n = len(class_names)
    cell = min(80, (min(_W, _H) - 2 * _PAD) // max(n, 1))
    x0, y0 = _PAD + 60, 60
    vmax = max(cm.max(), 1)
    parts = _svg_open(title)
    for i in range(n):
        for j in range(n):
            v = cm[i, j] / vmax
            shade = int(255 - 180 * v)
            parts.append(
                f'<rect x="{x0 + j * cell}" y="{y0 + i * cell}" width="{cell}" height="{cell}" '
                f'fill="rgb({shade},{shade},255)" stroke="#fff"/>'
            )
            parts.append(
                f'<text x="{x0 + j * cell + cell / 2}" y="{y0 + i * cell + cell / 2 + 4}" '
                f'text-anchor="middle">{int(cm[i, j])}</text>'
            )
    for i, name in enumerate(class_names):
        short = html.escape(name[:14])
        parts.append(f'<text x="{x0 - 6}" y="{y0 + i * cell + cell / 2 + 4}" text-anchor="end">{short}</text>')
        parts.append(
            f'<text x="{x0 + i * cell + cell / 2}" y="{y0 + n * cell + 16}" text-anchor="middle">{short}</text>'
        )
    parts.append(f'<text x="{x0 + n * cell / 2}" y="{y0 + n * cell + 36}" text-anchor="middle">Predicted</text>')
    parts.append("</svg>")
    return "\n".join(parts)


def bar_svg(labels: list[str], values: list[float], title: str, unit: str = "%") -> str:
    parts = _svg_open(title)
    vmax = max(max(values), 1e-9)
    n = len(labels)
    bw = (_W - 2 * _PAD) / max(n, 1)
    y0 = _H - _PAD
    for i, (lab, v) in enumerate(zip(labels, values)):
        h = (v / vmax) * (_H - 2 * _PAD)
        x = _PAD + i * bw
        parts.append(
            f'<rect x="{x + bw * 0.15:.1f}" y="{y0 - h:.1f}" width="{bw * 0.7:.1f}" '
            f'height="{h:.1f}" fill="{_COLORS[i % len(_COLORS)]}"/>'
        )
        parts.append(f'<text x="{x + bw / 2:.1f}" y="{y0 - h - 5:.1f}" text-anchor="middle">{v:.1f}{unit}</text>')
        parts.append(f'<text x="{x + bw / 2:.1f}" y="{y0 + 16}" text-anchor="middle">{html.escape(str(lab)[:12])}</text>')
    parts.append("</svg>")
    return "\n".join(parts)


def write_html(path: str | Path, title: str, svgs: list[str]) -> None:
    body = "\n<hr/>\n".join(svgs)
    Path(path).write_text(
        f"<!doctype html><html><head><meta charset='utf-8'>"
        f"<title>{html.escape(title)}</title></head>"
        f"<body style='max-width:720px;margin:auto'><h2>{html.escape(title)}</h2>{body}</body></html>"
    )

"""Per-assembly HTML status page (HTML.pm equivalent).

The port's own copy of canu_tpu.pipeline.html (no torch, no jax), with the same
results.

The reference builds per-phase HTML dashboards with gnuplot figures
(Canu src/pipelines/canu/HTML.pm:909, builders :95-508).
Here: one self-contained page from the persistent Report — the
reference's ASCII-histogram style (Gatekeeper.pm:360-470,
Meryl.pm:61-215) in <pre> blocks, plus native SVG figures (no gnuplot):
a per-stage wall-clock bar chart from <prefix>.stage-times.jsonl and
the overlap sub-stage breakdown.
"""

from __future__ import annotations

import html as _html
import json
import os
import time

from .report import Report

_PHASES = [
    ("cor", "Correction"),
    ("obt", "Trimming"),
    ("utg", "Assembly"),
]

_CSS = """
body { font-family: monospace; max-width: 60em; margin: 2em auto;
       color: var(--text-primary); background: var(--surface-1);
       --surface-1: #fcfcfb; --text-primary: #0b0b0b;
       --text-secondary: #52514e; --grid: #e4e3df; --series-1: #2a78d6; }
@media (prefers-color-scheme: dark) {
  body { --surface-1: #1a1a19; --text-primary: #ffffff;
         --text-secondary: #c3c2b7; --grid: #3a3936; --series-1: #3987e5; }
}
h1 { border-bottom: 2px solid var(--text-secondary); }
h2 { background: color-mix(in srgb, var(--text-secondary) 12%, transparent);
     padding: .2em .5em; }
pre { background: color-mix(in srgb, var(--text-secondary) 7%, transparent);
      padding: .5em; overflow-x: auto; }
.meta { color: var(--text-secondary); }
svg text { font-family: monospace; font-size: 11px; }
"""


def _svg_hbar(rows: list[tuple[str, float]], title: str,
              unit: str = "s") -> str:
    """Horizontal bar chart SVG: one series (sequential single hue),
    4px-rounded data ends anchored to the baseline, direct value
    labels in text ink, native <title> hover per bar."""
    if not rows:
        return ""
    W, ROW, LPAD, RPAD = 640, 22, 190, 70
    H = ROW * len(rows) + 30
    mx = max(v for _k, v in rows) or 1.0
    parts = [
        f"<svg viewBox='0 0 {W} {H}' width='{W}' role='img' "
        f"aria-label='{_html.escape(title)}'>",
        f"<text x='0' y='14' fill='var(--text-primary)' "
        f"font-weight='bold'>{_html.escape(title)}</text>",
    ]
    y = 26
    span = W - LPAD - RPAD
    for name, v in rows:
        w = max(2.0, span * v / mx)
        parts.append(
            f"<text x='{LPAD - 6}' y='{y + 12}' text-anchor='end' "
            f"fill='var(--text-secondary)'>{_html.escape(name)}</text>"
        )
        parts.append(
            f"<rect x='{LPAD}' y='{y + 2}' width='{w:.1f}' height='12' "
            f"rx='4' fill='var(--series-1)'>"
            f"<title>{_html.escape(name)}: {v:.1f} {unit}</title></rect>"
        )
        parts.append(
            f"<text x='{LPAD + w + 6:.1f}' y='{y + 12}' "
            f"fill='var(--text-primary)'>{v:.1f}</text>"
        )
        y += ROW
    parts.append("</svg>")
    return "".join(parts)


def _stage_walls(work_dir: str, prefix: str):
    """(stage walls desc-sorted, latest overlap sub-walls) from the
    stage-times JSONL (Execution.pm wall-log role)."""
    path = os.path.join(work_dir, f"{prefix}.stage-times.jsonl")
    walls: dict[str, float] = {}
    subs: dict[str, dict] = {}
    if not os.path.exists(path):
        return [], {}
    with open(path) as fh:
        for line in fh:
            try:
                r = json.loads(line)
            except ValueError:
                continue
            st = r.get("stage", "")
            if st.endswith(".sub"):
                subs[st[:-4]] = r.get("sub_walls_s", {})
            elif "wall_s" in r:
                walls[st] = walls.get(st, 0.0) + float(r["wall_s"])
    rows = sorted(walls.items(), key=lambda kv: -kv[1])
    return rows, subs


def ascii_histogram(values, width: int = 50, label: str = "") -> str:
    """canu-style horizontal ASCII histogram from a list of counts."""
    if not len(values):
        return "(empty)"
    mx = max(values) or 1
    lines = [label] if label else []
    for i, v in enumerate(values):
        bar = "*" * max(0, round(width * v / mx))
        lines.append(f"{i:>4} {v:>8} {bar}")
    return "\n".join(lines)


def build_html(work_dir: str, prefix: str) -> str:
    """Write <prefix>.html from the report; returns the path."""
    rep = Report(os.path.join(work_dir, f"{prefix}.report"))
    parts = [
        "<!doctype html><html><head><meta charset='utf-8'>",
        f"<title>{_html.escape(prefix)} — canu_tpu</title>",
        f"<style>{_CSS}</style></head><body>",
        f"<h1>{_html.escape(prefix)}</h1>",
        f"<p class='meta'>generated {time.strftime('%Y-%m-%d %H:%M:%S')} — canu_tpu</p>",
    ]
    walls, subs = _stage_walls(work_dir, prefix)
    if walls:
        parts.append("<h2>Wall clock</h2>")
        parts.append(_svg_hbar(walls, "wall seconds by stage"))
        for stage, sub in sorted(subs.items()):
            rows = sorted(((k, float(v)) for k, v in sub.items()),
                          key=lambda kv: -kv[1])
            if rows:
                parts.append(_svg_hbar(
                    rows, f"{stage} sub-stage walls"))
    for tag, title in _PHASES:
        keys = sorted(k for k in rep.data if k.startswith(tag + "."))
        if not keys:
            continue
        parts.append(f"<h2>{title}</h2>")
        for k in keys:
            parts.append(f"<h3>{_html.escape(k)}</h3>")
            parts.append(f"<pre>{_html.escape(rep.data[k])}</pre>")
    other = sorted(k for k in rep.data if not any(k.startswith(t + ".") for t, _ in _PHASES))
    if other:
        parts.append("<h2>Other</h2>")
        for k in other:
            parts.append(f"<h3>{_html.escape(k)}</h3><pre>{_html.escape(rep.data[k])}</pre>")
    parts.append("</body></html>")
    path = os.path.join(work_dir, f"{prefix}.html")
    with open(path + ".WORKING", "w") as fh:
        fh.write("\n".join(parts))
    os.replace(path + ".WORKING", path)
    return path

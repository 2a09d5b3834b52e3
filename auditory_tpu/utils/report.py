"""Self-contained HTML report for A/B segment comparisons.

The reference's gaborview app is a *live* two-pane explorer: edit
WParams/PParams/GParams, reprocess, and eyeball both result tab sets
(gbv.go:243-258, 952-1207, 1209-1313). The headless equivalents
(`compare_segments` + `utils.viz.render_compare`) cover the computation and
the figures; this module closes the browsing gap:
ONE self-contained HTML file per compare run -- A/B parameters side by side
with differing rows highlighted, the per-tensor diff-statistics table, and
every comparison figure base64-embedded -- so a user can open a single file
anywhere and browse the whole A/B result, no server, no image directory.
"""

from __future__ import annotations

import base64
import html
import os
import tempfile
from typing import List, Mapping, Optional, Union

import numpy as np

__all__ = ["write_compare_html"]


_CSS = """
body { font-family: system-ui, sans-serif; margin: 2em auto; max-width: 72em;
       color: #1a1a2e; }
h1 { font-size: 1.4em; } h2 { font-size: 1.1em; margin-top: 1.6em; }
table { border-collapse: collapse; margin: 0.8em 0; }
th, td { border: 1px solid #ccd; padding: 0.3em 0.7em; font-size: 0.9em;
         text-align: right; }
th { background: #eef1f8; }
td.key, th.key { text-align: left; font-family: ui-monospace, monospace; }
tr.differs td { background: #fff3df; font-weight: 600; }
img { max-width: 100%; border: 1px solid #dde; margin: 0.4em 0; }
.meta { color: #667; font-size: 0.85em; }
"""


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    return html.escape(str(v))


def _params_table(params_a: Mapping, params_b: Mapping) -> str:
    keys = list(params_a) + [k for k in params_b if k not in params_a]
    rows = []
    for k in keys:
        va, vb = params_a.get(k), params_b.get(k)
        cls = ' class="differs"' if va != vb else ""
        rows.append(
            f"<tr{cls}><td class=key>{html.escape(str(k))}</td>"
            f"<td>{_fmt(va)}</td><td>{_fmt(vb)}</td></tr>"
        )
    return (
        "<table><tr><th class=key>param</th><th>A</th><th>B</th></tr>"
        + "".join(rows)
        + "</table>"
    )


def _diff_table(diff: Mapping[str, Mapping]) -> str:
    head = (
        "<tr><th class=key>output</th><th>shape A</th><th>shape B</th>"
        "<th>max|A|</th><th>max|B|</th><th>active A</th><th>active B</th>"
        "<th>Δactive</th><th>max|B−A|</th></tr>"
    )
    rows = []
    for k, e in diff.items():
        if "only_in" in e:
            rows.append(
                f"<tr class=differs><td class=key>{html.escape(k)}</td>"
                f"<td colspan=8>only computed on side "
                f"{html.escape(str(e['only_in']).upper())}</td></tr>"
            )
            continue
        a, b = e["a"], e["b"]
        mad = e.get("max_abs_diff")
        nan_mm = int(e.get("nan_mismatch", 0))
        differs = (
            (mad is None) or (mad > 0) or nan_mm > 0
            or a["shape"] != b["shape"]
        )
        rows.append(
            f"<tr{' class=differs' if differs else ''}>"
            f"<td class=key>{html.escape(k)}</td>"
            f"<td>{_fmt(tuple(a['shape']))}</td>"
            f"<td>{_fmt(tuple(b['shape']))}</td>"
            f"<td>{_fmt(a['max_abs'])}</td><td>{_fmt(b['max_abs'])}</td>"
            f"<td>{_fmt(a['active_frac'])}</td>"
            f"<td>{_fmt(b['active_frac'])}</td>"
            f"<td>{_fmt(e['active_frac_delta'])}</td>"
            f"<td>{'—' if mad is None else _fmt(mad)}"
            + (f" (+{nan_mm} NaN-placement)" if nan_mm else "")
            + "</td></tr>"
        )
    return "<table>" + head + "".join(rows) + "</table>"


def write_compare_html(
    data: Union[str, Mapping[str, np.ndarray]],
    out_html: str,
    *,
    params_a: Optional[Mapping] = None,
    params_b: Optional[Mapping] = None,
    diff: Optional[Mapping[str, Mapping]] = None,
    title: Optional[str] = None,
    keys: Optional[List[str]] = None,
) -> str:
    """Write one self-contained HTML report for an A/B compare run.

    ``data``: a ``cli segment --compare`` npz path or mapping (``a_<key>`` /
    ``b_<key>`` arrays). Figures come from :func:`utils.viz.render_compare`
    (rendered to a temp dir, embedded as base64, temp files removed).
    ``params_a``/``params_b``: the two parameter stacks (differing rows are
    highlighted). ``diff``: the ``compare_segments`` diff-statistics dict.
    Returns ``out_html``.
    """
    from .viz import render_compare

    if isinstance(data, str):
        data = dict(np.load(data))

    parts = [
        "<!doctype html><html><head><meta charset='utf-8'>",
        f"<title>{html.escape(title or 'A/B segment comparison')}</title>",
        f"<style>{_CSS}</style></head><body>",
        f"<h1>{html.escape(title or 'A/B segment comparison')}</h1>",
        "<p class=meta>auditory_tpu · headless gaborview A/B explorer "
        "(reference: gbv.go dual WParams/PParams/GParams)</p>",
    ]
    if params_a is not None or params_b is not None:
        parts.append("<h2>Parameters</h2>")
        parts.append(_params_table(params_a or {}, params_b or {}))
    if diff:
        parts.append("<h2>Output differences</h2>")
        parts.append(_diff_table(diff))
    parts.append("<h2>Figures</h2>")
    with tempfile.TemporaryDirectory() as td:
        for png in render_compare(data, td, keys=keys):
            with open(png, "rb") as f:
                b64 = base64.b64encode(f.read()).decode("ascii")
            name = os.path.basename(png)[len("compare_"):-len(".png")]
            parts.append(f"<h3 class=key>{html.escape(name)}</h3>")
            parts.append(
                f"<img alt='{html.escape(name)}' "
                f"src='data:image/png;base64,{b64}'>"
            )
    parts.append("</body></html>")
    out_dir = os.path.dirname(os.path.abspath(out_html))
    os.makedirs(out_dir, exist_ok=True)
    with open(out_html, "w", encoding="utf-8") as f:
        f.write("\n".join(parts))
    return out_html

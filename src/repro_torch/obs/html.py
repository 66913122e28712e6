"""Static HTML report: per-switch Gantt strips + attribution tables, a copy
of ``repro.obs.html``.

``render_html`` turns a ``ScenarioAttribution`` into one self-contained
HTML file (no external assets): per period, a Gantt strip per switch
(serve = blue, reconfigure = orange, idle = neutral gray — categorical
slots 1/2 and the neutral from the validated reference palette, with the
dark-mode steps under ``prefers-color-scheme``), a legend naming each
color in text, and a numbers table carrying the same data for readers
the color channel does not serve. Interval tooltips ride the native
``title`` attribute.
"""

from __future__ import annotations

from html import escape
from pathlib import Path

from .timeline_table import ScenarioAttribution, TimelineTable

__all__ = ["render_html", "save_html"]

_CSS = """\
.obs-root {
  color-scheme: light;
  --surface-1: #fcfcfb;
  --page: #f9f9f7;
  --text-primary: #0b0b0b;
  --text-secondary: #52514e;
  --muted: #898781;
  --grid: #e1e0d9;
  --border: rgba(11,11,11,0.10);
  --serve: #2a78d6;   /* categorical slot 1 (blue) */
  --reconf: #eb6834;  /* categorical slot 2 (orange) */
  --idle: #f0efec;    /* neutral gray */
  font-family: system-ui, -apple-system, "Segoe UI", sans-serif;
  background: var(--page);
  color: var(--text-primary);
  margin: 0;
  padding: 24px;
}
@media (prefers-color-scheme: dark) {
  :root:where(:not([data-theme="light"])) .obs-root {
    color-scheme: dark;
    --surface-1: #1a1a19;
    --page: #0d0d0d;
    --text-primary: #ffffff;
    --text-secondary: #c3c2b7;
    --grid: #2c2c2a;
    --border: rgba(255,255,255,0.10);
    --serve: #3987e5;
    --reconf: #d95926;
    --idle: #383835;
  }
}
:root[data-theme="dark"] .obs-root {
  color-scheme: dark;
  --surface-1: #1a1a19;
  --page: #0d0d0d;
  --text-primary: #ffffff;
  --text-secondary: #c3c2b7;
  --grid: #2c2c2a;
  --border: rgba(255,255,255,0.10);
  --serve: #3987e5;
  --reconf: #d95926;
  --idle: #383835;
}
.obs-root h1 { font-size: 20px; margin: 0 0 4px; }
.obs-root h2 { font-size: 15px; margin: 24px 0 8px; }
.obs-root .sub { color: var(--text-secondary); font-size: 13px; margin: 0 0 16px; }
.obs-card {
  background: var(--surface-1);
  border: 1px solid var(--border);
  border-radius: 8px;
  padding: 16px;
  margin-bottom: 16px;
}
.obs-legend { display: flex; gap: 16px; font-size: 12px;
  color: var(--text-secondary); margin: 0 0 12px; }
.obs-legend .chip { display: inline-block; width: 10px; height: 10px;
  border-radius: 2px; margin-right: 5px; vertical-align: -1px; }
.obs-row { display: flex; align-items: center; gap: 8px; margin: 3px 0; }
.obs-row .lab { width: 64px; font-size: 12px; color: var(--text-secondary);
  text-align: right; font-variant-numeric: tabular-nums; }
.obs-strip { position: relative; flex: 1; height: 16px;
  background: var(--idle); border-radius: 4px; overflow: hidden; }
.obs-strip .iv { position: absolute; top: 0; bottom: 0;
  border-left: 1px solid var(--surface-1);
  border-right: 1px solid var(--surface-1); box-sizing: border-box; }
.obs-strip .serve { background: var(--serve); }
.obs-strip .reconf { background: var(--reconf); }
.obs-row .util { width: 56px; font-size: 12px; color: var(--text-secondary);
  font-variant-numeric: tabular-nums; }
.obs-axis { display: flex; justify-content: space-between; font-size: 11px;
  color: var(--muted); margin: 4px 0 0 72px; }
table.obs-table { border-collapse: collapse; font-size: 12px; width: 100%; }
table.obs-table th, table.obs-table td {
  text-align: right; padding: 4px 10px;
  border-bottom: 1px solid var(--grid);
  font-variant-numeric: tabular-nums; }
table.obs-table th { color: var(--text-secondary); font-weight: 600; }
table.obs-table th:first-child, table.obs-table td:first-child {
  text-align: left; }
"""

_LEGEND = (
    '<p class="obs-legend">'
    '<span><span class="chip" style="background:var(--serve)"></span>serve</span>'
    '<span><span class="chip" style="background:var(--reconf)"></span>reconfigure (δ)</span>'
    '<span><span class="chip" style="background:var(--idle);'
    'outline:1px solid var(--grid)"></span>idle</span>'
    "</p>"
)


def _strip(table: TimelineTable, row_index: int) -> str:
    """One switch's Gantt strip: absolutely-positioned interval blocks."""
    row = table.rows[row_index]
    horizon = table.horizon or 1.0
    parts = []
    for iv in row.intervals:
        if iv.kind == "idle" or iv.duration <= 0:
            continue  # idle is the strip background
        left = 100.0 * iv.start / horizon
        width = 100.0 * iv.duration / horizon
        tip = (
            f"ocs{row.switch} {iv.kind} "
            f"[{iv.start:.4f}, {iv.end:.4f})"
            + (f" slot {iv.slot}" if iv.kind == "serve" else "")
        )
        parts.append(
            f'<span class="iv {iv.kind}" title="{escape(tip)}" '
            f'style="left:{left:.3f}%;width:{width:.3f}%"></span>'
        )
    reused = " +" if row.reused else ""
    return (
        '<div class="obs-row">'
        f'<span class="lab">ocs{row.switch}{reused}</span>'
        f'<span class="obs-strip">{"".join(parts)}</span>'
        f'<span class="util">{row.utilization:.1%}</span>'
        "</div>"
    )


def _period_card(title: str, table: TimelineTable) -> str:
    att = table.attribution
    strips = "".join(_strip(table, i) for i in range(len(table.rows)))
    gap = (
        f"gap ×{att.makespan / att.lower_bound:.4f}"
        if att.lower_bound and att.lower_bound == att.lower_bound
        else "no lower bound"
    )
    return (
        '<div class="obs-card">'
        f"<h2>{escape(title)}</h2>"
        f'<p class="sub">makespan {att.makespan:.4f} · {gap} · '
        f"shares: serve {att.transmission_share:.1%}, "
        f"δ {att.delta_share:.1%}, idle {att.idle_share:.1%}"
        + (
            f" · reuse {att.reuse_count} (δ avoided {att.delta_avoided:.4f})"
            if att.reuse_count
            else ""
        )
        + "</p>"
        + _LEGEND
        + strips
        + f'<div class="obs-axis"><span>0</span>'
        f"<span>{table.horizon:.4f}</span></div>"
        "</div>"
    )


def _numbers_table(att: ScenarioAttribution) -> str:
    """The table view: the same attribution numbers, per period."""
    head = (
        "<tr><th>period</th><th>makespan</th><th>LB</th><th>serve</th>"
        "<th>δ paid</th><th>idle</th><th>util mean</th><th>reuse</th></tr>"
    )
    rows = []
    for label, tables in (("", att.tables), ("online ", att.online_tables)):
        for t, table in enumerate(tables):
            a = table.attribution
            rows.append(
                f"<tr><td>{label}{t}</td><td>{a.makespan:.4f}</td>"
                f"<td>{a.lower_bound:.4f}</td><td>{a.transmission:.4f}</td>"
                f"<td>{a.delta_paid:.4f}</td><td>{a.idle:.4f}</td>"
                f"<td>{table.utilization.mean():.1%}</td>"
                f"<td>{a.reuse_count}</td></tr>"
            )
    return (
        '<div class="obs-card"><h2>Attribution table</h2>'
        f'<table class="obs-table">{head}{"".join(rows)}</table></div>'
    )


def render_html(att: ScenarioAttribution, *, title: str | None = None) -> str:
    """Self-contained HTML report for one scenario attribution."""
    title = title or f"{att.scenario} · {att.solver} — switch timelines"
    agg = att.summary()
    cards = [
        _period_card(f"period {t}", table) for t, table in enumerate(att.tables)
    ]
    cards += [
        _period_card(f"online period {t} (credit-aware)", table)
        for t, table in enumerate(att.online_tables)
    ]
    return (
        "<!DOCTYPE html>\n<html><head><meta charset='utf-8'>"
        f"<title>{escape(title)}</title><style>{_CSS}</style></head>"
        '<body class="obs-root">'
        f"<h1>{escape(title)}</h1>"
        f'<p class="sub">{agg["periods"]} periods · '
        f'serve {agg["transmission_share"]:.1%} · '
        f'δ {agg["delta_share"]:.1%} · idle {agg["idle_share"]:.1%} · '
        f'mean utilization {agg["util_mean"]:.1%}</p>'
        + "".join(cards)
        + _numbers_table(att)
        + "</body></html>\n"
    )


def save_html(
    att: ScenarioAttribution, path: str | Path, *, title: str | None = None
) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(render_html(att, title=title))
    return path

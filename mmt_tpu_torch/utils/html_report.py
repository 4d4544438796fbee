"""Dependency-free HTML writer for qualitative ranking pages.

Replaces the reference's dominate-based writer (utils/html_utils.py) with
plain string templating; same artifact: one page per eval with, per
sampled query, the caption, per-modality MoE weights, and the top-ranked
videos with GT highlighting (utils/visualizer.py:45-191 behavior).

A copy of mmt_tpu/utils/html_report.py (the port imports nothing of the JAX
package).
"""

from __future__ import annotations

import html
import pathlib
from typing import List, Sequence

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
 body {{ font-family: sans-serif; margin: 2em; }}
 .query {{ border-top: 1px solid #ccc; padding: 1em 0; }}
 .gt {{ color: #0a0; font-weight: bold; }}
 .weights {{ color: #777; font-size: 0.9em; }}
 table {{ border-collapse: collapse; }}
 td {{ padding: 2px 10px; border: 1px solid #eee; }}
</style></head>
<body><h2>{title}</h2>
{body}
</body></html>
"""


class HTMLReport:
  def __init__(self, web_dir, title: str):
    self.web_dir = pathlib.Path(web_dir)
    self.title = title
    self._sections: List[str] = []

  def add_query(self, caption: str, text_weights: Sequence[float],
                modalities: Sequence[str], gt_rank: float, gt_sim: float,
                rows: List[dict]):
    """rows: [{'path','rank','sim','is_gt','vid_weights'}]."""
    w = ", ".join(f"{m}:{float(x):.3f}"
                  for m, x in zip(modalities, text_weights))
    parts = [f'<div class="query"><p><b>{html.escape(caption)}</b></p>',
             f'<p class="weights">text MoE: {w}</p>',
             f'<p>GT rank {gt_rank:g}, sim {gt_sim:.4f}</p>',
             "<table><tr><th>rank</th><th>video</th><th>sim</th>"
             "<th>video MoE</th></tr>"]
    for row in rows:
      cls = ' class="gt"' if row.get("is_gt") else ""
      vw = ", ".join(f"{m}:{float(x):.3f}"
                     for m, x in zip(modalities, row.get("vid_weights", [])))
      parts.append(
          f"<tr{cls}><td>{row['rank']}</td>"
          f"<td>{html.escape(str(row['path']))}</td>"
          f"<td>{row['sim']:.4f}</td><td>{vw}</td></tr>")
    parts.append("</table></div>")
    self._sections.append("\n".join(parts))

  def save(self, filename: str = "index.html") -> str:
    self.web_dir.mkdir(parents=True, exist_ok=True)
    out = self.web_dir / filename
    out.write_text(_PAGE.format(title=html.escape(self.title),
                                body="\n".join(self._sections)))
    return str(out)

"""Matrix aggregation: the paper's Table 1 generalized to a full grid.

Counterpart of ``repro.obs.matrix`` (numpy only).

One `StabilityReport` describes one run; the selector-zoo matrix
(the reference's ``benchmarks/table11_matrix.py``) runs every selector × execution regime
× adversarial scenario cell and needs those per-run reports folded into a
single ranked artifact. This module is that fold — numpy-only, like
``obs.stability``, so it stays importable without ``repro_torch.fed``.

Coverage is a contract, not a best effort: every expected cell must be
*accounted for* — either it ran (``status='ok'`` with its Table-1 summary)
or it is explicitly ``status='unsupported'`` with a human-readable reason.
`cell_support` is the single source of the unsupported rules, and
`MatrixReport.missing` lets the runner (and the tests pinning this
behavior) prove nothing was skipped silently.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs.stability import StabilityReport

#: Execution regimes of the matrix: round_policy × topology combinations
#: the engine stack supports (async/hierarchical exists too, but the matrix
#: axes follow the reference's grid — sync/flat, async/flat, sync/hierarchical).
REGIMES = ("sync", "async", "hierarchical")

#: Scenario axis (mirrors fed.scenarios.SCENARIOS; duplicated as plain
#: strings so this module stays free of repro_torch.fed imports).
MATRIX_SCENARIOS = ("baseline", "churn", "stragglers", "drift")


def cell_support(selector: str, regime: str, scenario: str) -> Optional[str]:
    """Why a cell cannot run, or None if it is supported.

    The one place unsupported-cell knowledge lives: the matrix runner calls
    it before building a spec, and the pinning test asserts the rules
    instead of discovering them by crashing engines.
    """
    if scenario == "stragglers" and regime != "async":
        return ("straggler profiles (SystemProfile) drive the async "
                "engine's virtual clock; the sync engines have no wall "
                "clock to apply them to")
    return None


@dataclasses.dataclass
class MatrixCell:
    """One (selector, regime, scenario) grid cell."""

    selector: str
    regime: str
    scenario: str
    status: str                              # 'ok' | 'unsupported'
    reason: str = ""                         # non-empty iff unsupported
    summary: Optional[Dict[str, Any]] = None  # StabilityReport.summary()

    def key(self) -> Tuple[str, str, str]:
        return (self.selector, self.regime, self.scenario)

    def to_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "selector": self.selector, "regime": self.regime,
            "scenario": self.scenario, "status": self.status,
        }
        if self.status == "unsupported":
            out["reason"] = self.reason
        if self.summary is not None:
            out["summary"] = dict(self.summary)
        return out


class MatrixReport:
    """Folds per-cell stability reports into one ranked artifact."""

    def __init__(self, metric_name: str = "accuracy"):
        self.metric_name = metric_name
        self.cells: List[MatrixCell] = []

    # -- accumulation -------------------------------------------------------

    def _add(self, cell: MatrixCell) -> None:
        if any(c.key() == cell.key() for c in self.cells):
            raise ValueError(f"duplicate matrix cell {cell.key()}")
        self.cells.append(cell)

    def add_run(self, selector: str, regime: str, scenario: str,
                report: StabilityReport) -> None:
        """Record a completed cell with its Table-1 summary (bit-exact:
        the stored numbers are ``StabilityReport.summary()``'s floats)."""
        self._add(MatrixCell(selector, regime, scenario, status="ok",
                             summary=report.summary()))

    def add_unsupported(self, selector: str, regime: str, scenario: str,
                        reason: str) -> None:
        """Record a cell that cannot run. A reason is mandatory — an
        unexplained hole is a silent skip, which the matrix forbids."""
        if not reason:
            raise ValueError(
                f"unsupported cell ({selector}, {regime}, {scenario}) "
                "needs a non-empty reason")
        self._add(MatrixCell(selector, regime, scenario,
                             status="unsupported", reason=reason))

    # -- coverage -----------------------------------------------------------

    def cell(self, selector: str, regime: str, scenario: str
             ) -> Optional[MatrixCell]:
        for c in self.cells:
            if c.key() == (selector, regime, scenario):
                return c
        return None

    def missing(self, selectors: Sequence[str], regimes: Sequence[str],
                scenarios: Sequence[str]) -> List[Tuple[str, str, str]]:
        """Expected cells with no entry at all — must be empty before
        `write`; the runner exits loudly otherwise."""
        have = {c.key() for c in self.cells}
        return [(s, r, sc) for s in selectors for r in regimes
                for sc in scenarios if (s, r, sc) not in have]

    # -- ranking ------------------------------------------------------------

    def ok_cells(self) -> List[MatrixCell]:
        return [c for c in self.cells if c.status == "ok"]

    def ranked(self, scenario: Optional[str] = None,
               regime: Optional[str] = None) -> List[MatrixCell]:
        """Completed cells best-first: final metric desc, then stability
        drop asc (hold high AND give back little), then name for stability."""
        pool = [c for c in self.ok_cells()
                if (scenario is None or c.scenario == scenario)
                and (regime is None or c.regime == regime)]
        return sorted(
            pool,
            key=lambda c: (-c.summary["final"], c.summary["stability_drop"],
                           c.selector, c.regime))

    def leaderboard(self) -> List[Dict[str, Any]]:
        """Per-selector aggregate over its completed cells."""
        by_sel: Dict[str, List[MatrixCell]] = {}
        for c in self.ok_cells():
            by_sel.setdefault(c.selector, []).append(c)
        rows = []
        for sel, cells in by_sel.items():
            finals = np.asarray([c.summary["final"] for c in cells],
                                np.float64)
            drops = np.asarray([c.summary["stability_drop"] for c in cells],
                               np.float64)
            rows.append({
                "selector": sel,
                "cells": len(cells),
                "mean_final": float(finals.mean()),
                "mean_peak": float(np.mean(
                    [c.summary["peak"] for c in cells])),
                "mean_stability_drop": float(drops.mean()),
            })
        rows.sort(key=lambda r: (-r["mean_final"], r["mean_stability_drop"],
                                 r["selector"]))
        return rows

    # -- rendering ----------------------------------------------------------

    def to_json(self) -> Dict[str, Any]:
        return {
            "metric_name": self.metric_name,
            "cells_total": len(self.cells),
            "cells_ok": len(self.ok_cells()),
            "cells_unsupported": sum(
                1 for c in self.cells if c.status == "unsupported"),
            "cells": [c.to_json() for c in self.cells],
            "leaderboard": self.leaderboard(),
        }

    def to_markdown(self) -> str:
        ok = self.ok_cells()
        unsup = [c for c in self.cells if c.status == "unsupported"]
        scenarios = sorted({c.scenario for c in self.cells})
        lines = [
            "# Selector × regime × scenario stability matrix",
            "",
            "The paper's Table-1 triple (peak / final / stability drop) for",
            "every selector under every execution regime and adversarial",
            "scenario. Every expected cell is accounted for: it either ran",
            "to completion or is explicitly marked unsupported with the",
            "reason — never silently skipped.",
            "",
            f"**Coverage:** {len(ok)} cells completed, "
            f"{len(unsup)} explicitly unsupported, "
            f"{len(self.cells)} total.",
            "",
            "## Leaderboard (mean over completed cells, best final first)",
            "",
            f"| rank | selector | cells | mean peak | mean final "
            f"| mean stability drop |",
            "|---|---|---|---|---|---|",
        ]
        for i, row in enumerate(self.leaderboard(), start=1):
            lines.append(
                f"| {i} | `{row['selector']}` | {row['cells']} "
                f"| {row['mean_peak']:.6f} | {row['mean_final']:.6f} "
                f"| {row['mean_stability_drop']:.6f} |")
        for sc in scenarios:
            lines += [
                "",
                f"## Scenario: {sc}",
                "",
                f"| selector | regime | peak | final | stability drop "
                f"| final Gini |",
                "|---|---|---|---|---|---|",
            ]
            for c in self.ranked(scenario=sc):
                s = c.summary
                lines.append(
                    f"| `{c.selector}` | {c.regime} | {s['peak']:.6f} "
                    f"| {s['final']:.6f} | {s['stability_drop']:.6f} "
                    f"| {s['final_part_gini']:.6f} |")
            for c in unsup:
                if c.scenario == sc:
                    lines.append(
                        f"| `{c.selector}` | {c.regime} | — | — | — | — |"
                        f" *unsupported: {c.reason}*")
        lines.append("")
        return "\n".join(lines)

    def write(self, out_dir: str, stem: str = "matrix_report"
              ) -> Tuple[str, str]:
        """Write ``<stem>.md`` + ``<stem>.json`` under ``out_dir``."""
        os.makedirs(out_dir, exist_ok=True)
        md_path = os.path.join(out_dir, f"{stem}.md")
        json_path = os.path.join(out_dir, f"{stem}.json")
        with open(md_path, "w") as f:
            f.write(self.to_markdown())
        with open(json_path, "w") as f:
            json.dump(self.to_json(), f, indent=2)
        return md_path, json_path

"""Online stability reporting: the paper's Table-1 triple per run.

Counterpart of ``repro.obs.stability`` (numpy only).

``StabilityReport`` condenses a run into the numbers the paper argues
about — peak accuracy, final accuracy, and the stability drop
(peak − final) under extreme heterogeneity — plus the fairness
trajectories (participation Gini, selection entropy over rounds) that
explain *why* a run held or collapsed. It renders to ``report.md`` and a
JSON artifact per run.

The triple is computed with exactly the numpy expressions ``FLResult``
uses (``max()``, ``[-1]``, ``[-10:].mean()`` over a float64 metric
array), so ``from_result(res)`` reproduces ``res.peak_acc`` /
``res.final_acc`` / ``res.stability_drop`` bit-for-bit — pinned by
``tests/test_torch_obs.py``. Inputs are duck-typed (any object with
``accuracy`` and ``selected_history`` arrays works), so this module
stays numpy-only with no dependency on ``repro_torch.fed``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs.metrics import gini, selection_entropy


@dataclasses.dataclass
class StabilityReport:
    """Table-1 triple + fairness trajectories for one federated run."""

    metric_name: str
    metric: List[float]
    part_gini: List[float]
    sel_entropy: List[float]
    selection_counts: List[int]

    # -- the Table-1 triple (same numpy ops as FLResult, for exactness) ----

    @property
    def peak(self) -> float:
        return float(np.asarray(self.metric, dtype=np.float64).max())

    @property
    def final(self) -> float:
        return float(np.asarray(self.metric, dtype=np.float64)[-1])

    @property
    def stable(self) -> float:
        return float(np.asarray(self.metric, dtype=np.float64)[-10:].mean())

    @property
    def stability_drop(self) -> float:
        return self.peak - self.final

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_result(cls, res) -> "StabilityReport":
        """Build from an ``FLResult``-shaped object (duck-typed).

        Fairness trajectories are recomputed from the per-round selection
        history via cumulative participation counts — the same functions
        ``MetricsRegistry`` applies online, so the two paths agree.
        """
        hist = np.asarray(res.selected_history)
        csum = np.cumsum(hist.astype(np.int64), axis=0)
        return cls(
            metric_name=getattr(res, "metric_name", "accuracy"),
            metric=[float(x) for x in np.asarray(res.accuracy)],
            part_gini=[gini(c) for c in csum],
            sel_entropy=[selection_entropy(c) for c in csum],
            selection_counts=[int(c) for c in csum[-1]] if len(csum) else [],
        )

    @classmethod
    def from_registry(cls, registry, metric_name: str = "accuracy"
                      ) -> "StabilityReport":
        """Build from a live ``MetricsRegistry`` (the online path)."""
        return cls(
            metric_name=metric_name,
            metric=registry.series("metric"),
            part_gini=registry.series("part_gini"),
            sel_entropy=registry.series("sel_entropy"),
            selection_counts=[int(c) for c in registry.selection_counts],
        )

    # -- rendering ----------------------------------------------------------

    def summary(self) -> Dict[str, Any]:
        return {
            "metric_name": self.metric_name,
            "rounds": len(self.metric),
            "peak": self.peak,
            "final": self.final,
            "stable": self.stable,
            "stability_drop": self.stability_drop,
            "final_part_gini": self.part_gini[-1] if self.part_gini else 0.0,
            "final_sel_entropy":
                self.sel_entropy[-1] if self.sel_entropy else 0.0,
        }

    def to_markdown(self) -> str:
        s = self.summary()
        lines = [
            f"# Stability report — {self.metric_name}",
            "",
            "The paper's Table-1 view of this run: how high the model got,",
            "where it ended, and how much it gave back (the stability drop),",
            "with the fairness trajectory that explains the selection side.",
            "",
            "| quantity | value |",
            "|---|---|",
            f"| rounds | {s['rounds']} |",
            f"| peak {self.metric_name} | {s['peak']:.6f} |",
            f"| final {self.metric_name} | {s['final']:.6f} |",
            f"| stable (last-10 mean) | {s['stable']:.6f} |",
            f"| stability drop (peak − final) | {s['stability_drop']:.6f} |",
            f"| final participation Gini | {s['final_part_gini']:.6f} |",
            f"| final selection entropy | {s['final_sel_entropy']:.6f} |",
            "",
            "## Fairness trajectory",
            "",
            "| round | " + self.metric_name +
            " | participation Gini | selection entropy |",
            "|---|---|---|---|",
        ]
        for t, m in enumerate(self.metric):
            g = self.part_gini[t] if t < len(self.part_gini) else 0.0
            e = self.sel_entropy[t] if t < len(self.sel_entropy) else 0.0
            lines.append(f"| {t} | {m:.6f} | {g:.6f} | {e:.6f} |")
        lines.append("")
        return "\n".join(lines)

    def write(self, out_dir: str, stem: str = "report") -> Tuple[str, str]:
        """Write ``<stem>.md`` + ``<stem>.json`` under ``out_dir``."""
        os.makedirs(out_dir, exist_ok=True)
        md_path = os.path.join(out_dir, f"{stem}.md")
        json_path = os.path.join(out_dir, f"{stem}.json")
        with open(md_path, "w") as f:
            f.write(self.to_markdown())
        payload = dict(self.summary())
        payload["metric"] = list(self.metric)
        payload["part_gini"] = list(self.part_gini)
        payload["sel_entropy"] = list(self.sel_entropy)
        payload["selection_counts"] = list(self.selection_counts)
        with open(json_path, "w") as f:
            json.dump(payload, f, indent=2)
        return md_path, json_path

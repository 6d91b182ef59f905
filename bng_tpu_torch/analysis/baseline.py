"""Baseline handling: accepted findings that don't block CI.

A baseline entry is a Finding identity (code, path, scope, detail —
line numbers deliberately excluded so unrelated edits don't churn it)
plus a mandatory one-line justification. `bng check` exits 1 on any
finding NOT in the baseline; `--update-baseline` rewrites the file from
the current run, preserving justifications of entries that survive and
stamping new ones with "TODO: justify" (CI should reject a TODO tag —
the justification is the review artifact).

Stale entries (baselined findings the code no longer produces) are
reported and dropped on update: a baseline that only grows becomes a
dead letter.
"""

from __future__ import annotations

import json
from pathlib import Path

from bng_tpu_torch.analysis.core import Finding

BASELINE_VERSION = 1
DEFAULT_BASELINE = Path(__file__).resolve().parent / "baseline.json"
TODO_TAG = "TODO: justify"


def load(path: Path | str | None = None) -> dict[tuple, str]:
    """{finding key -> justification}; empty when the file is absent."""
    path = Path(path) if path is not None else DEFAULT_BASELINE
    if not path.exists():
        return {}
    data = json.loads(path.read_text(encoding="utf-8"))
    out: dict[tuple, str] = {}
    for e in data.get("findings", ()):
        key = (e["code"], e["path"], e.get("scope", ""),
               e.get("detail", ""))
        out[key] = e.get("justification", TODO_TAG)
    return out


def split(findings: list[Finding],
          baseline: dict[tuple, str]) -> tuple[list[Finding],
                                               list[Finding], list[tuple]]:
    """(new, accepted, stale_keys): findings not in the baseline, the
    baselined ones, and baseline entries nothing matched."""
    new: list[Finding] = []
    accepted: list[Finding] = []
    seen: set[tuple] = set()
    for f in findings:
        k = f.key()
        if k in baseline:
            accepted.append(f)
            seen.add(k)
        else:
            new.append(f)
    stale = [k for k in baseline if k not in seen]
    return new, accepted, stale


def write(findings: list[Finding], path: Path | str | None = None,
          old: dict[tuple, str] | None = None,
          keep: dict[tuple, str] | None = None) -> Path:
    """Rewrite the baseline from `findings`, carrying over existing
    justifications; new entries get the TODO tag for review. `keep`
    entries (key -> justification) are preserved verbatim — the caller's
    out-of-scope set when the run was selective."""
    path = Path(path) if path is not None else DEFAULT_BASELINE
    old = old if old is not None else {}
    emitted: set[tuple] = set()
    rows: list[tuple[tuple, str]] = []
    for f in findings:
        k = f.key()
        if k not in emitted:
            emitted.add(k)
            rows.append((k, old.get(k, TODO_TAG)))
    for k, just in (keep or {}).items():
        if k not in emitted:
            emitted.add(k)
            rows.append((k, just))
    entries = [
        {"code": k[0], "path": k[1], "scope": k[2], "detail": k[3],
         "justification": just}
        for k, just in sorted(rows, key=lambda r: r[0])
    ]
    path.write_text(json.dumps(
        {"version": BASELINE_VERSION, "findings": entries},
        indent=1, sort_keys=False) + "\n", encoding="utf-8")
    return path

"""`python -m bng_tpu_torch check` / `python -m bng_tpu_torch.analysis` — the
analyzer driver over the port (a copy of `bng_tpu/analysis/cli.py`).

Exit codes:
    0  clean (every finding baselined WITH a justification, or none)
    1  at least one non-baselined finding, or a baseline entry still
       tagged "TODO: justify" (the justification is the review
       artifact — an unjustified acceptance is not an acceptance)
    2  analyzer-internal error (unreadable baseline, bad arguments)

Importing this module never imports torch or jax — the analyzer is pure stdlib
`ast`, so `bng check` runs in milliseconds on any box (the <30s
acceptance bound is dominated by Python startup, not the scan).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from bng_tpu_torch.analysis import baseline as baseline_mod
from bng_tpu_torch.analysis.core import CODE_CONFIG, Project, run_passes
from bng_tpu_torch.analysis.passes import all_codes, build


def default_root() -> Path:
    """The repo root: the directory holding the bng_tpu_torch package."""
    return Path(__file__).resolve().parents[2]


def add_check_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("paths", nargs="*",
                   help="files/dirs to scan (default: the repo scan set)")
    p.add_argument("--root", default=None,
                   help="repo root (default: the bng_tpu_torch install root)")
    p.add_argument("--baseline", default=None,
                   help="baseline file (default: "
                        "bng_tpu_torch/analysis/baseline.json)")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore the baseline (report every finding)")
    p.add_argument("--update-baseline", action="store_true",
                   help="rewrite the baseline from this run (new entries "
                        "tagged 'TODO: justify')")
    p.add_argument("--select", default=None,
                   help="comma-separated pass names or finding codes "
                        "(e.g. hotpath,BNG020)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable report on stdout")
    p.add_argument("--codes", action="store_true",
                   help="print the finding-code catalog and exit")


def run_check(args: argparse.Namespace) -> int:
    if args.codes:
        for code, desc in all_codes().items():
            print(f"{code}  {desc}")
        return 0

    if args.no_baseline and args.update_baseline:
        # --no-baseline discards the justifications --update-baseline
        # must carry over; combining them would rewrite the file with
        # every entry reset to the TODO tag.
        print("bng check: --no-baseline and --update-baseline are "
              "mutually exclusive", file=sys.stderr)
        return 2

    root = Path(args.root) if args.root else default_root()
    select = (set(s.strip() for s in args.select.split(","))
              if args.select else None)
    passes = build(select)
    if not passes:
        print(f"bng check: no pass matches --select {args.select}",
              file=sys.stderr)
        return 2

    project = Project.load(root, [Path(p) for p in args.paths] or None)
    report = run_passes(project, passes)

    if args.no_baseline:
        bl: dict = {}
        bl_path = None
    else:
        bl_path = Path(args.baseline) if args.baseline else (
            baseline_mod.DEFAULT_BASELINE)
        try:
            bl = baseline_mod.load(bl_path)
        except (json.JSONDecodeError, KeyError, OSError) as e:
            print(f"bng check: unreadable baseline {bl_path}: {e}",
                  file=sys.stderr)
            return 2
    new, accepted, stale = baseline_mod.split(report.findings, bl)
    report.findings, report.baselined = new, accepted
    # A selective run (--select, or explicit paths narrowing the scan)
    # can only vouch for the codes its passes emit against the files it
    # scanned — both the TODO rejection and the baseline rewrite below
    # must stay inside that scope.
    emittable = {c for p in passes for c in p.codes} | {CODE_CONFIG}
    scanned = {f.path for f in project.files} | {"<analyzer>"}
    # baseline.py's contract: entries stamped "TODO: justify" by
    # --update-baseline are review debt, and CI must reject them — an
    # entry nobody wrote a reason for is a silenced finding, not an
    # accepted one. (--update-baseline itself is exempt below: it is the
    # verb that CREATES the tag for the reviewer to replace.) Scoped:
    # an out-of-scope TODO entry is one this invocation can neither
    # re-verify nor re-stamp, so failing on it would leave a narrow
    # `--select`/path run permanently red.
    todo = sorted(k for k, just in bl.items()
                  if just.strip() == baseline_mod.TODO_TAG
                  and k[0] in emittable and k[1] in scanned)

    if args.update_baseline:
        # Baseline entries outside the run's scope must survive the
        # rewrite, or `--select hotpath --update-baseline` silently
        # wipes every other pass's justified entries.
        keep = {k: v for k, v in bl.items()
                if k[0] not in emittable or k[1] not in scanned}
        stale = [k for k in stale if k not in keep]
        out = baseline_mod.write(new + accepted, bl_path, old=bl,
                                 keep=keep)
        print(f"bng check: baseline rewritten: {out} "
              f"({len(new)} new, {len(accepted)} kept, "
              f"{len(keep)} out-of-scope preserved, "
              f"{len(stale)} stale dropped)")
        return 0

    if args.as_json:
        doc = report.to_dict()
        doc["stale_baseline_entries"] = [list(k) for k in stale]
        doc["todo_baseline_entries"] = [list(k) for k in todo]
        if "concurrency" in report.passes_run:
            # the per-function context classification, so reviewers can
            # audit the call-graph facts behind BNG06x findings (the
            # model is memoized on the Project — no second build)
            from bng_tpu_torch.analysis import facts
            doc["contexts"] = facts.build_concurrency_model(
                project).contexts_report()
        print(json.dumps(doc, indent=2))
    else:
        for f in new:
            print(f"{f.location()}: {f.code} [{f.scope or '<module>'}] "
                  f"{f.message}")
        for k in todo:
            print(f"{k[1]}: {k[0]} [{k[2] or '<module>'}] baseline entry "
                  f"still tagged {baseline_mod.TODO_TAG!r} — write the "
                  f"justification in {bl_path}")
        if stale:
            print(f"bng check: {len(stale)} stale baseline entr"
                  f"{'y' if len(stale) == 1 else 'ies'} (code no longer "
                  f"produces them) — run --update-baseline",
                  file=sys.stderr)
        print(f"bng check: {len(new)} finding(s), {len(accepted)} "
              f"baselined ({len(todo)} unjustified), "
              f"{report.files_scanned} files, "
              f"{report.elapsed_s:.2f}s "
              f"[{', '.join(report.passes_run)}]",
              file=sys.stderr)
    return 1 if new or todo else 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="bng check",
        description="bngcheck: dataplane-invariant static analyzer")
    add_check_args(parser)
    return run_check(parser.parse_args(argv))


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())

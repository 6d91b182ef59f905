"""Concurrency-ownership discipline (BNG060-BNG064) — the `_ctl` rule,
machine-checked (the port's copy of
`bng_tpu/analysis/passes/concurrency.py`, scoped to the port's files).

The codebase has five execution contexts touching shared state: the
dataplane run loop, the OpsServer HTTP handler thread ("ctl"), the
metrics scrape path, HA syncer threads, and fleet worker processes.
The discipline — every cross-thread touch of loop-owned state goes
through `_ctl` (or the object's own lock) — was enforced only by
reviewer vigilance, and the last two review passes caught real races
by hand (the OpsController check-then-act timeout; `ops_status`
racing loop-side fleet mutations). Yuan et al. (OSDI'14): most
catastrophic failures hide in exactly this kind of untested
error/concurrency interleaving; SAMC (OSDI'14): semantic awareness of
WHICH interleavings matter is what makes checking tractable. Here the
semantics are the context classification facts.py builds from the
repo's own AST (thread entry points -> call graph -> reachable context
sets + guaranteed-held lock sets).

* **BNG060** — an attribute mutated from >=2 thread contexts with no
  common lock across the mutation sites. "worker" is excluded: fleet
  workers run in separate processes (inline mode runs on the calling
  thread, which is already counted).
* **BNG061** — a lock `.acquire()`d without `with` or a try/finally
  release in the same function: an exception between acquire and
  release deadlocks every other context forever.
* **BNG062** — check-then-act: a function reads a shared attribute in
  a test and writes it later, without holding the lock its OTHER
  writers (in other contexts) agree on — the OpsController timeout's
  bug class. Only fires when such a guard lock exists; when the
  writers have no common lock at all that is BNG060's finding.
* **BNG063** — a blocking call (sleep/join/pipe recv/...) while a lock
  is held in a function the run loop reaches: the dataplane stalls for
  the duration. Intentional barriers (the fleet gather IS the batch
  boundary) are baselined with a justification.
* **BNG064** — a Thread created in control/ by a class with no
  stop/join path: an orphan thread outlives close() and races
  teardown.

Like every pass, findings are baselined by the line-independent
identity; a missing fact source (no loop roots, no resolvable thread
target) is a loud BNG990, never a silent no-op.
"""

from __future__ import annotations

from bng_tpu_torch.analysis import facts
from bng_tpu_torch.analysis.core import Finding, Pass, Project

# cli.py rides along: BNGApp is the _ctl discipline's anchor class —
# leaving it out would make the very object the @owned_by stamp guards
# invisible to the static half
SCOPE_PREFIXES = ("bng_tpu_torch/control/", "bng_tpu_torch/runtime/",
                  "bng_tpu_torch/cli.py")
THREAD_SCOPE = ("bng_tpu_torch/control/",)


def _racy(ctxs: set) -> frozenset:
    return frozenset(c for c in ctxs if c not in facts.NON_RACY_CONTEXTS)


class ConcurrencyPass(Pass):
    name = "concurrency"
    description = ("thread-ownership discipline: cross-context mutations "
                   "hold a common lock; no check-then-act, unreleased "
                   "acquires, blocking under loop locks, or orphan "
                   "threads")
    codes = {
        "BNG060": "attribute mutated from >=2 thread contexts with no "
                  "common lock",
        "BNG061": "lock acquired without `with`/try-finally release",
        "BNG062": "check-then-act on a shared attribute without the "
                  "writers' lock",
        "BNG063": "blocking call inside a held lock reachable from the "
                  "run loop",
        "BNG064": "Thread created in control/ without a stop/join path",
    }

    def run(self, project: Project) -> list[Finding]:
        model = facts.build_concurrency_model(project)
        out: list[Finding] = []
        for detail in model.missing_facts:
            out.append(self.config_finding(
                detail, f"concurrency fact source missing: {detail} — "
                        f"context classification would be blind"))
        for rec in model.unresolved:
            out.append(Finding(
                "BNG990", rec.get("path", "<analyzer>"),
                rec.get("line", 0),
                "thread entry point's target could not be resolved to a "
                "function — its context (and everything it mutates) is "
                "invisible to the concurrency pass",
                scope=rec.get("qual", ""),
                detail=f"thread-target:{rec.get('qual', '?')}"))

        sites = self._mutation_sites(model)
        flagged_060 = self._bng060(model, sites, out)
        self._bng062(model, sites, flagged_060, out)
        self._bng061(model, out)
        self._bng063(model, out)
        self._bng064(model, out)
        return out

    # -- shared: mutation sites per (class, attr) ------------------------

    def _mutation_sites(self, model) -> dict:
        """{(class identity, attr) -> [(fid, line, locks, contexts)]}
        over scoped files, reachable functions only. Class identity is
        (path, enclosing qual) — two same-named classes in different
        modules (every HTTP `Handler`) must NOT merge into one site
        list, or their disjoint contexts would fabricate a BNG060."""
        sites: dict = {}
        for fid, fact in model.functions.items():
            if fact.cls is None or not fact.path.startswith(SCOPE_PREFIXES):
                continue
            if fact.qual.rsplit(".", 1)[-1] in ("__init__", "__post_init__"):
                # writes in a constructor precede publication: no other
                # context can hold the object yet
                continue
            ctxs = _racy(model.contexts.get(fid, set()))
            if not ctxs:
                continue
            held = model.held.get(fid, frozenset())
            resolved = model.resolved_lines.get(fid, ())
            cls_id = (fact.path, fact.qual.rsplit(".", 1)[0])
            for attr, line, locks, kind in fact.writes:
                if kind == "mutcall" and line in resolved:
                    continue  # the callee's own writes carry the check
                sites.setdefault((cls_id, attr), []).append(
                    (fid, line, held | frozenset(locks), ctxs))
        return sites

    # -- BNG060 ----------------------------------------------------------

    def _bng060(self, model, sites, out: list[Finding]) -> set:
        flagged: set = set()
        for (cls_id, attr), rows in sorted(sites.items()):
            all_ctx: set = set()
            for _fid, _line, _locks, ctxs in rows:
                all_ctx |= ctxs
            if len(all_ctx) < 2:
                continue
            common = frozenset.intersection(
                *[locks for _f, _l, locks, _c in rows])
            if common:
                continue
            fid, line, _locks, _ctxs = sorted(rows)[0]
            fact = model.functions[fid]
            flagged.add((cls_id, attr))
            out.append(Finding(
                "BNG060", fact.path, line,
                f"`{fact.cls}.{attr}` is mutated from contexts "
                f"{{{', '.join(sorted(all_ctx))}}} with no common lock "
                f"across the mutation sites — take the owning lock at "
                f"every writer or hand one context a snapshot API",
                scope=fact.qual, detail=f"{fact.cls}.{attr}"))
        return flagged

    # -- BNG062 ----------------------------------------------------------

    def _bng062(self, model, sites, flagged_060: set,
                out: list[Finding]) -> None:
        emitted: set = set()
        for fid, fact in sorted(model.functions.items()):
            if fact.cls is None or not fact.path.startswith(SCOPE_PREFIXES):
                continue
            ctxs = _racy(model.contexts.get(fid, set()))
            if not ctxs or not fact.test_reads:
                continue
            held = model.held.get(fid, frozenset())
            cls_id = (fact.path, fact.qual.rsplit(".", 1)[0])
            written_attrs = {w[0] for w in fact.writes}
            for attr, line, locks in fact.test_reads:
                if attr not in written_attrs:
                    continue  # read-only test: not check-then-act
                if (cls_id, attr) in flagged_060:
                    continue  # already the stronger finding
                others = [r for r in sites.get((cls_id, attr), ())
                          if r[0] != fid and (r[3] - ctxs)]
                if not others:
                    continue  # no cross-context writer
                guard = frozenset.intersection(*[r[2] for r in others])
                if not guard:
                    continue  # no agreed guard: BNG060 territory
                # the TEST must hold the guard: a locked write after an
                # unlocked test still acts on a stale decision (the
                # OpsController timeout's shape — the check passed just
                # before the deadline, the act landed after)
                mine = (frozenset(locks) | held) & guard
                if mine:
                    continue
                key = (fid, attr)
                if key in emitted:
                    continue
                emitted.add(key)
                out.append(Finding(
                    "BNG062", fact.path, line,
                    f"check-then-act on `{fact.cls}.{attr}`: tested here "
                    f"and written later without "
                    f"{{{', '.join(sorted(guard))}}} — the lock its "
                    f"cross-context writers hold (the OpsController "
                    f"timeout bug class); the test result is stale by "
                    f"the time the write lands",
                    scope=fact.qual, detail=f"{fact.cls}.{attr}"))

    # -- BNG061 ----------------------------------------------------------

    def _bng061(self, model, out: list[Finding]) -> None:
        for fid, fact in sorted(model.functions.items()):
            if not fact.path.startswith(SCOPE_PREFIXES):
                continue
            safe = set(fact.releases_final)
            for tok, line in fact.acquires:
                if tok in safe:
                    continue
                out.append(Finding(
                    "BNG061", fact.path, line,
                    f"`{tok}.acquire()` without `with` or a try/finally "
                    f"release in the same function — an exception here "
                    f"deadlocks every other context on {tok} forever",
                    scope=fact.qual, detail=f"acquire:{tok}"))

    # -- BNG063 ----------------------------------------------------------

    def _bng063(self, model, out: list[Finding]) -> None:
        for fid, fact in sorted(model.functions.items()):
            if not fact.path.startswith(SCOPE_PREFIXES):
                continue
            if facts.CONTEXT_LOOP not in model.contexts.get(fid, set()):
                continue
            held = model.held.get(fid, frozenset())
            seen: set = set()
            for name, line, locks in fact.blocking:
                all_locks = held | frozenset(locks)
                if not all_locks or name in seen:
                    continue
                seen.add(name)
                out.append(Finding(
                    "BNG063", fact.path, line,
                    f"blocking `{name}()` while holding "
                    f"{{{', '.join(sorted(all_locks))}}} in a function "
                    f"the run loop reaches — the dataplane stalls for "
                    f"the full wait; move the block outside the lock or "
                    f"baseline with the justification that the pause IS "
                    f"the design",
                    scope=fact.qual, detail=f"{name}@{fact.qual}"))

    # -- BNG064 ----------------------------------------------------------

    def _bng064(self, model, out: list[Finding]) -> None:
        for rec in model.spawns:
            if rec["kind"] != "thread":
                continue
            path = rec.get("path", "")
            if not path.startswith(THREAD_SCOPE):
                continue
            if rec.get("has_stop"):
                continue
            # a cancel-closure nested in the spawning function also
            # counts as a stop path (the SSE reader idiom)
            fid = rec.get("fid", "")
            has_cancel = False
            if model.functions.get(fid) is not None:
                # nested defs of the spawning function live under its
                # qual prefix; one calling `<event>.set()` / `.join()`
                # is the cancel path (attribute calls only — a bare
                # `set()` is the builtin constructor, not a stop)
                prefix = fid + "."
                for ofid, ofact in model.functions.items():
                    if ofid.startswith(prefix) and any(
                            c.get("m") in ("set", "join")
                            for c in ofact.calls):
                        has_cancel = True
                        break
            if has_cancel:
                continue
            out.append(Finding(
                "BNG064", path, rec.get("line", 0),
                "Thread created with no stop/join path: the enclosing "
                "class has no stop/close/shutdown method and the "
                "spawning function builds no cancel closure — the "
                "thread outlives close() and races teardown",
                scope=rec.get("qual", ""),
                detail=f"thread:{rec.get('qual', '?')}"))

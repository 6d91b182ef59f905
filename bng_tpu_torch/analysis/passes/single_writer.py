"""Single-writer discipline for the device-mirror tables (BNG040/BNG041);
the port's copy of `bng_tpu/analysis/passes/single_writer.py`, its
allowlist naming the port's modules.

The fast-path tables have exactly one consistency story: host mirrors
are mutated by a small set of owner modules, deltas drain through the
bounded update batch into ONE fused step that updates the device
tables in place, and everything else
reads. The chaos auditor proves the runtime half (host == device after
drain); this pass pins the static half — a new module that starts
calling `fastpath.add_subscriber(...)` or assigning `engine.tables`
bypasses the event-log replay and the auditor's assumptions.

* **BNG040** — a fast-path/device-mirror mutator called outside the
  allowlisted writer modules.
* **BNG041** — direct assignment to an engine's `.tables` outside the
  engine/restore modules (rebinding the device table pytree is the
  engine's own job; everyone else goes through resync/restore).

The allowlist is part of the invariant, reviewed like code: each entry
says WHY that module writes.
"""

from __future__ import annotations

import ast

from bng_tpu_torch.analysis.core import Finding, Pass, Project, dotted, scope_of

# FastPathTables / QoS / antispoof / garden / pppoe mutating surface +
# the HostTable primitives they wrap
MUTATORS = {
    "add_subscriber", "remove_subscriber", "bulk_add_subscribers",
    "add_vlan_subscriber", "remove_vlan_subscriber",
    "add_pool", "set_server_config",
    "add_circuit_id", "remove_circuit_id",
    "insert", "bulk_insert",
    "set_gardened", "allow_destination",
    "set_subscriber", "bulk_set_subscribers",
    "add_binding", "add_binding_v6", "remove_binding",
    "resync_tables", "restore_arrays",
    "arm_tap", "disarm_tap", "set_tap_filters",
    "set_route", "clear_route",
    "fill_slot", "adopt_cursors",
    "watch", "reset", "reset_peer",
    "set_manifest", "accept_chunk",
}

# writer modules (path suffix -> why it is allowed to write)
ALLOWED_WRITERS = {
    "bng_tpu_torch/runtime/tables.py": "the host authority itself",
    "bng_tpu_torch/runtime/engine.py": "owns the device mirrors + drain",
    "bng_tpu_torch/runtime/checkpoint.py": "restore hydration path",
    "bng_tpu_torch/runtime/verify.py": "lowering verification builds fixtures",
    "bng_tpu_torch/runtime/scheduler.py": "bulk replica management",
    "bng_tpu_torch/control/dhcp_server.py": "DHCP lease lifecycle writer",
    "bng_tpu_torch/control/fleet.py": "table-event-log replay (single writer)",
    "bng_tpu_torch/control/pool.py": "pool provisioning",
    "bng_tpu_torch/control/agent.py": "provisioning agent (composition root)",
    "bng_tpu_torch/control/subscriber.py": "subscriber lifecycle manager",
    "bng_tpu_torch/control/nat.py": "NAT host authority",
    "bng_tpu_torch/control/statestore.py": "checkpoint store hydration",
    "bng_tpu_torch/parallel/sharded.py": "sharded engine owns its shard tables",
    "bng_tpu_torch/cli.py": "composition root provisioning",
    "bng_tpu_torch/chaos/scenarios.py": "scenario fixtures build table state",
    "bng_tpu_torch/chaos/storms.py": "storm fixtures build table state (same "
                               "role as scenarios.py; the CoA qos_hook "
                               "IS the cli composition-root hook, built "
                               "standalone)",
    "bng_tpu_torch/chaos/invariants.py": "auditor drains pending deltas",
    "bng_tpu_torch/loadtest/harness.py": "loadtest provisioning",
    "bng_tpu_torch/cluster/instance.py": "cluster member composition root: "
                                   "builds its own instance's pools + "
                                   "fastpath from the carved spec "
                                   "(same role as cli.py, per member)",
    # (the reference's `bench.py` entry: the port has no bench driver yet)
    "bng_tpu_torch/edge/tables.py": "edge host authority (tap/route mirrors)",
    "bng_tpu_torch/edge/compile.py": "warrant/route compilers are the edge "
                               "tables' owning managers",
    "bng_tpu_torch/devloop/ring.py": "descriptor-ring host authority: "
                               "fill_slot/adopt_cursors ARE the ring "
                               "cursor mutators",
    "bng_tpu_torch/devloop/host.py": "the devloop pump owns its ring: slot "
                               "fills at admission, cursor adoption at "
                               "retire — a writer outside the pump "
                               "bypasses the quiesce/audit story",
    "bng_tpu_torch/cluster/coordinator.py": "fabric membership authority"
                                      ": watches slots on "
                                      "plan apply, resets the view + "
                                      "transport replay floor on "
                                      "promote — a second writer "
                                      "desyncs verdicts from the HA "
                                      "ladder",
    "bng_tpu_torch/cluster/handoff/protocol.py":
        "state-transfer authority: set_manifest/accept_chunk "
        "advance the receiver's ACK cursor and chunk map — a second "
        "writer could half-hydrate a member past the digest gate",
}

# receiver names that mark the call as a fast-path table mutation
# (x.insert() on a dict-like in unrelated code must not trip the pass)
TABLE_RECEIVERS = {
    "fastpath", "tables", "sub", "vlan", "cid", "bindings", "subscribers",
    "qos", "up", "down", "antispoof", "garden", "pppoe", "by_sid", "by_ip",
    "edge", "tap", "route", "ring", "devloop", "cursors",
    "fabric_detector", "fabric_transport",
    "handoff", "receiver",
}


def _receiver_chain(node: ast.Call) -> list[str]:
    """Attribute names of the receiver: self.fastpath.sub.insert ->
    ["self", "fastpath", "sub"]."""
    parts: list[str] = []
    cur = node.func
    if isinstance(cur, ast.Attribute):
        cur = cur.value
        while isinstance(cur, ast.Attribute):
            parts.append(cur.attr)
            cur = cur.value
        if isinstance(cur, ast.Name):
            parts.append(cur.id)
    return parts


class SingleWriterPass(Pass):
    name = "single-writer"
    description = ("fast-path table mutators called only from the "
                   "allowlisted writer modules")
    codes = {
        "BNG040": "fast-path table mutator outside the writer allowlist",
        "BNG041": "engine.tables rebound outside the engine/restore "
                  "modules",
    }

    def run(self, project: Project) -> list[Finding]:
        out: list[Finding] = []
        for sf in project.files:
            allowed = any(sf.path.endswith(suffix)
                          for suffix in ALLOWED_WRITERS)
            if allowed:
                continue
            for node in ast.walk(sf.tree):
                if isinstance(node, ast.Call):
                    out.extend(self._check_call(sf, node))
                elif isinstance(node, ast.Assign):
                    out.extend(self._check_tables_assign(sf, node))
        return out

    def _check_call(self, sf, node: ast.Call):
        if not isinstance(node.func, ast.Attribute):
            return
        if node.func.attr not in MUTATORS:
            return
        chain = _receiver_chain(node)
        if not any(p in TABLE_RECEIVERS for p in chain):
            return
        yield Finding(
            "BNG040", sf.path, node.lineno,
            f"`{dotted(node.func)}()` mutates a fast-path table from a "
            f"non-writer module — route it through the owning manager "
            f"(or extend the reviewed allowlist in "
            f"analysis/passes/single_writer.py with a justification)",
            scope=scope_of(node), detail=node.func.attr)

    def _check_tables_assign(self, sf, node: ast.Assign):
        for tgt in node.targets:
            if (isinstance(tgt, ast.Attribute) and tgt.attr == "tables"
                    and not isinstance(tgt.value, ast.Name)
                    or isinstance(tgt, ast.Attribute)
                    and tgt.attr == "tables"
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id != "self"):
                yield Finding(
                    "BNG041", sf.path, node.lineno,
                    "rebinding `<engine>.tables` outside the engine — "
                    "the device table pytree has one writer; use "
                    "resync_tables()/restore paths",
                    scope=scope_of(node), detail="tables-assign")

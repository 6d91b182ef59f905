#!/usr/bin/env python3
"""The control of the PPPoE box's comparison: the reference put in the
program's place with one of the configuration's guarantees broken, judged
by the same comparison (`gpubench/pppoe_check.py`) at the cell's own size.
It has to come out not correct.

    python3 gpubench/control_pppoe.py --workload pppoe_qinq_64k.bidir_mtu \
        --seed <n> --batches 200 --variant bf16_tokens

Variants:
- `bf16_tokens`: both directions' token buckets computed in bfloat16, the
  precision below the float32 the configuration states for the token words;
- `tags_not_written`: downstream frames encapsulated without the line's
  S/C tags (they reach no access node);
- `tags_left_on`: upstream frames decapsulated with the line's tags left
  on (the core side gets tagged frames);
- `c_tag_swapped`: downstream frames on the next line's C-tag (another
  subscriber's line).

The history is `--batches` batches of the cell's mix at its batch size,
`now` advancing 50 ms a batch. The benchmark's own runs never run this;
`gpubench/tests/test_gpubench_pppoe.py` runs it small.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np

VARIANTS = ("bf16_tokens", "tags_not_written", "tags_left_on", "c_tag_swapped")


def control_reference(ds, variant: str):
    from gpubench.control import bf16
    from gpubench.reference import pppoe as R

    class Control(R.Reference):
        if variant == "bf16_tokens":
            rnd = staticmethod(bf16)

        def encap_rows(self, flows, frame_len, width):
            rows, lens = super().encap_rows(flows, frame_len, width)
            if variant == "tags_not_written":
                rows = np.concatenate([rows[:, :12], rows[:, 20:],
                                       np.zeros((len(rows), 8), dtype=np.uint8)], axis=1)
                lens = lens - R.QINQ
            elif variant == "c_tag_swapped":
                c = self.ds.c_tags[self.ds.flow_session[flows]]
                rows[:, 18:20] = R.P.be(c % 4094 + 1, 2)
            return rows, lens

        def snat_rows(self, flows, frame_len, width):
            rows, lens = super().snat_rows(flows, frame_len, width)
            if variant == "tags_left_on":
                s = self.ds.flow_session[flows]
                tags = R.line_header(np.zeros(len(s)), np.zeros(len(s)), self.ds.s_tags[s],
                                     self.ds.c_tags[s])[:, 12:20]
                rows = np.concatenate([rows[:, :12], tags, rows[:, 12:width - R.QINQ]], axis=1)
                lens = lens + R.QINQ
            return rows, lens

    return Control(ds)


def simulate(cfg: dict, mix: dict, seed: int, n_batches: int, variant: str) -> dict:
    """The control's checks over `n_batches` batches of the cell's mix."""
    from gpubench import pppoe_check, pppoe_data
    from gpubench.reference.pppoe import FWD, KIND_DOWN, KIND_UP, Reference

    B, L = int(cfg["batch"]), int(cfg["pkt_slot"])
    ds = pppoe_data.build(cfg, seed)
    traffic = pppoe_data.closed_loop(mix, ds, B, seed, L)
    ctrl = control_reference(ds, variant)
    hist = [(k * B, B, float(ds.now0 + 60) + 0.05 * k) for k in range(n_batches)]
    pos = np.arange(n_batches * B) % len(traffic)
    got = ctrl.run(traffic.kind[pos], traffic.ref[pos], traffic.lens[pos], hist)
    v = got["verdict"]
    batches = []
    for k, (g0, n, now) in enumerate(hist):
        rec = {"g0": g0, "n": n, "now": now, "verdict": v[g0:g0 + n], "extra": 0}
        if k % 8 == 0:
            p = g0 + np.nonzero(v[g0:g0 + n] == FWD)[0]
            q = p % len(traffic)
            rows, lens = ctrl.expected_rows(traffic.kind[q], traffic.ref[q], traffic.lens[q],
                                            v[p], L)
            rec.update(out_pos=p, out_verdict=v[p], out_rows=rows, out_lens=lens)
        batches.append(rec)
    flows = np.arange(ds.n_flows)
    vals = ctrl.session_rows(flows, got).astype(np.uint32)
    qrows = {}
    for d in (KIND_UP, KIND_DOWN):
        q = np.zeros((ds.n_sessions, 8), dtype=np.uint32)
        q[:, 0], q[:, 1] = ds.sub_ips, 1
        q[:, 6] = got["tokens"][d].astype(np.float32).view(np.uint32)
        q[:, 7] = got["last_us"][d]
        qrows[d] = q
    obs = pppoe_check.Tables(pppoe_check.session_keys(ds, flows),
                             np.ones(ds.n_flows, dtype=bool), vals, qrows)
    return pppoe_check.ring_checks(Reference(ds), traffic, batches, obs)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--batches", type=int, default=200)
    ap.add_argument("--variant", default="bf16_tokens", choices=VARIANTS + ("none",))
    args = ap.parse_args()
    sys.path[0] = str(Path(__file__).resolve().parents[1])
    from gpubench import harness

    _, cell, cfg, mix = harness.load_cell(args.workload)
    checks = simulate(cfg, mix, args.seed, args.batches, args.variant)
    correct = all(v <= lim for v, lim in checks.values())
    print(json.dumps({"workload": args.workload, "seed": args.seed, "variant": args.variant,
                      "correct": correct,
                      "checks": {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

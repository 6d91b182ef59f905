#!/usr/bin/env python3
"""The control of the comparison: the reference put in the program's
place with one of the configuration's guarantees broken, judged by the
same comparison at the cell's own size. It has to come out not correct.

    python3 gpubench/control.py --workload ipoe_1m.mix_80_20 --seed <n> \
        --batches 200 --variant bf16_tokens

Variants:
- `bf16_tokens`: the token bucket computed in bfloat16, the precision
  below the float32 the configuration states for the token words;
- `udp_checksum_kept`: the SNAT rewrite leaves the UDP checksum as the
  frame came (a tempting saving: the checksum is then wrong);
- `offer_xid_zero`: OFFERs from a template whose xid is never patched (the
  client cannot match the reply to its DISCOVER).

The history is `--batches` batches of the cell's mix at its batch size
(an open mix's frames in its own proportion), `now` advancing 50 ms a
batch. The benchmark's own runs never
run this; `gpubench/tests/test_gpubench_control.py` runs it small.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np


def bf16(x):
    """Round float32 values to bfloat16 (to nearest, ties to even), kept
    in float32."""
    u = np.asarray(x, dtype=np.float32).reshape(-1).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    out = u.astype(np.uint32).view(np.float32)
    return out[0] if np.ndim(x) == 0 else out


def control_reference(ds, variant: str):
    from gpubench import packets as P
    from gpubench.dataset import flow_mac
    from gpubench.reference.bng import F32, M32, Reference

    class Control(Reference):
        def _tbf(self, pols, flens, now_us, tokens, last_us):
            if variant != "bf16_tokens":
                return super()._tbf(pols, flens, now_us, tokens, last_us)
            drop = np.zeros(len(pols), dtype=bool)
            for p in np.unique(pols):
                lanes = np.nonzero(pols == p)[0]
                burst = bf16(F32(self.q_burst[p]))
                elapsed = bf16(F32((now_us - int(last_us[p])) & M32))
                refill = bf16(bf16(elapsed * bf16(F32(self.q_rate[p]) / F32(8.0))) * F32(1e-6))
                avail = min(bf16(bf16(tokens[p]) + refill), burst)
                ok = np.cumsum(flens[lanes]).astype(F32) <= avail
                drop[lanes] = ~ok
                tokens[p] = min(max(bf16(avail - F32(int(flens[lanes][ok].sum()))), F32(0)), burst)
                last_us[p] = now_us
            return drop

        def offer_rows(self, subs, xids):
            if variant == "offer_xid_zero":
                xids = np.zeros_like(xids)
            return super().offer_rows(subs, xids)

        def snat_rows(self, flows, frame_lens):
            rows, lens = super().snat_rows(flows, frame_lens)
            if variant == "udp_checksum_kept":
                orig, _ = P.flow_rows(flow_mac(self.ds.flow_src[flows]), self.ds.flow_src[flows],
                                      self.ds.flow_dst[flows], self.ds.flow_sport[flows],
                                      self.ds.flow_dport[flows], frame_lens)
                u = P.ETH + P.IP4
                rows[:, u + 6:u + 8] = orig[:, u + 6:u + 8]
            return rows, lens

    return Control(ds)


def simulate(cfg: dict, mix: dict, seed: int, n_batches: int, variant: str) -> dict:
    """The control's checks over `n_batches` batches of the cell's mix."""
    from gpubench import check, dataset, generator
    from gpubench.check import Tables
    from gpubench.reference.bng import FWD, TX, Reference

    B = int(cfg["batch"])
    ds = dataset.build(cfg, seed)
    if mix["loop"] == "open":
        # an open mix's frames in batches of the bulk lane's size, in its
        # own proportion of DISCOVERs
        d, f = float(mix["discover_rate_per_s"]), float(mix["flow_rate_per_s"])
        mix = dict(mix, discover_share=d / (d + f), pool_batches=8)
    traffic = generator.closed_loop(mix, ds, B, seed)
    ctrl = control_reference(ds, variant)
    hist = [(k * B, B, float(ds.now0 + 60) + 0.05 * k) for k in range(n_batches)]
    pos = np.arange(n_batches * B) % len(traffic)
    got = ctrl.run(traffic.kind[pos], traffic.ref[pos], traffic.lens[pos], hist)
    v = got["verdict"]
    batches = []
    for k, (g0, n, now) in enumerate(hist):
        rec = {"g0": g0, "n": n, "now": now, "verdict": v[g0:g0 + n], "extra": 0}
        if k % 8 == 0:
            p = g0 + np.nonzero((v[g0:g0 + n] == TX) | (v[g0:g0 + n] == FWD))[0]
            rows, lens = check.expected_rows(ctrl, traffic, p, v[p])
            rec.update(out_pos=p, out_verdict=v[p], out_rows=rows, out_lens=lens)
        batches.append(rec)
    flows = np.arange(ds.n_flows)
    vals = ctrl.session_rows(flows, got["fwd_count"], got["fwd_bytes"],
                             got["last_seen"]).astype(np.uint32)
    qrows = np.zeros((len(ds.qos_ips), 8), dtype=np.uint32)
    qrows[:, 0], qrows[:, 1] = ds.qos_ips, 1
    qrows[:, 6] = got["tokens"].astype(np.float32).view(np.uint32)
    qrows[:, 7] = got["last_us"]
    obs = Tables(check.session_keys(ds, flows), np.ones(ds.n_flows, dtype=bool), vals, qrows)
    return check.ring_checks(Reference(ds), traffic, batches, obs)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--batches", type=int, default=200)
    ap.add_argument("--variant", default="bf16_tokens")
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

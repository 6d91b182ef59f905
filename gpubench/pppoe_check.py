"""The comparison that decides `correct` for the PPPoE-over-QinQ box.

The same counts as `gpubench/check.py`'s, each limited to 0 (every
guarantee of the configuration is exact):

- `unanswered`: frames sent whose batch never gave its verdicts back;
- `verdicts_off`: over every frame of every batch, those whose verdict
  (FWD, DROP or PASS) differs from the reference's, and output frames that
  belong to no frame of their batch;
- `bytes_off`: in the batches the seed samples, output frames that differ
  from the reference's frame for the same input frame (every byte of the
  frame and its length: the tags, the PPPoE framing, the addresses);
- `nat_words_off`: sampled NAT sessions whose words differ (half of them
  touched in the run);
- `qos_words_off`: QoS buckets, both directions, whose token or last_us
  word differs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from gpubench.check import LIMITS, QW_FLAGS, QW_KEY, QW_LAST_US, QW_TOKENS, find_rows, rows_off
from gpubench.reference.pppoe import KIND_DOWN, KIND_UP, M32

SESSION_SAMPLE = 4096


@dataclass
class Tables:
    """What the judge reads of the program's tables once the run is over."""

    session_keys: np.ndarray  # [S, 4] uint32
    session_live: np.ndarray  # [S] bool
    session_vals: np.ndarray  # [S, 16] uint32
    qos_rows: dict  # {KIND_UP, KIND_DOWN: [R, 8] uint32}


def read_tables(eng, tables) -> Tables:
    """Quiesce the engine and read its tables back (a synchronising read,
    after the window)."""
    eng.quiesce()
    nat = tables["nat"]
    rows = {d: t.rows.cpu().numpy().view(np.uint32)
            for d, t in ((KIND_UP, eng.tables.qos_up), (KIND_DOWN, eng.tables.qos_down))}
    return Tables(nat.sessions.keys, nat.sessions.used != 0, eng.fetch_session_vals(), rows)


def session_keys(ds, flows) -> np.ndarray:
    return np.stack([ds.sub_ips[ds.flow_session[flows]], ds.flow_dst[flows],
                     ((ds.flow_sport[flows] & np.uint64(0xFFFF)) << np.uint64(16))
                     | (ds.flow_dport[flows] & np.uint64(0xFFFF)),
                     np.full(len(flows), 17, dtype=np.uint64)], axis=1).astype(np.uint32)


def ring_checks(ref, traffic, batches, obs: Tables) -> dict:
    """Replay every batch the program ran through the reference and count
    what differs. `batches` are the retired batches in order (as
    `gpubench/check.ring_checks` takes them)."""
    n_sent = batches[-1]["g0"] + batches[-1]["n"] if batches else 0
    pos_all = np.arange(n_sent) % len(traffic)
    hist = [(b["g0"], b["n"], b["now"]) for b in batches]
    exp = ref.run(traffic.kind[pos_all], traffic.ref[pos_all], traffic.lens[pos_all], hist)
    v = exp["verdict"]
    verdicts_off = bytes_off = 0
    for b in batches:
        verdicts_off += int((b["verdict"] != v[b["g0"]:b["g0"] + b["n"]]).sum()) + b["extra"]
        if "out_rows" in b:
            p = b["out_pos"]
            same = b["out_verdict"] == v[p]  # a frame of the wrong kind is a verdict off
            q = p[same] % len(traffic)
            er, el = ref.expected_rows(traffic.kind[q], traffic.ref[q], traffic.lens[q],
                                       v[p[same]], b["out_rows"].shape[1])
            bytes_off += rows_off(b["out_rows"][same], b["out_lens"][same], er, el)
    checks = {"unanswered": n_sent - sum(b["n"] for b in batches),
              "verdicts_off": verdicts_off, "bytes_off": bytes_off}
    checks.update(table_checks(ref, exp, obs))
    return {k: (int(val), LIMITS[k]) for k, val in checks.items()}


def table_checks(ref, exp, obs: Tables) -> dict:
    """NAT session words of a seeded sample of flows (half of them touched
    in the run), and the token words of every QoS bucket both ways."""
    ds = ref.ds
    rng = np.random.default_rng(int(ds.now0) ^ len(exp["verdict"]))
    touched = np.nonzero(exp["pkts"][KIND_UP] + exp["pkts"][KIND_DOWN])[0]
    pick = np.concatenate([rng.choice(touched, min(len(touched), SESSION_SAMPLE // 2),
                                      replace=False) if len(touched) else touched,
                           rng.integers(0, ds.n_flows, SESSION_SAMPLE // 2)])
    want = ref.session_rows(pick, exp)
    slots = find_rows(obs.session_keys, obs.session_live, session_keys(ds, pick))
    dev = obs.session_vals.astype(np.int64)
    nat_off = int((slots < 0).sum())
    ok = slots >= 0
    nat_off += int((dev[slots[ok], :15] != (want[ok, :15] & M32)).any(1).sum())

    qos_off = 0
    for d in (KIND_UP, KIND_DOWN):
        rows = obs.qos_rows[d]
        used = (rows[:, QW_FLAGS] & 1) != 0
        qslot = find_rows(rows[:, QW_KEY:QW_KEY + 1], used, ds.sub_ips.astype(np.uint32)[:, None])
        tok_bits = exp["tokens"][d].astype(np.float32).view(np.uint32)
        qos_off += int((qslot < 0).sum())
        ok = qslot >= 0
        qos_off += int(((rows[qslot[ok], QW_TOKENS] != tok_bits[ok])
                        | (rows[qslot[ok], QW_LAST_US] != (exp["last_us"][d][ok] & M32))).sum())
    return {"nat_words_off": nat_off, "qos_words_off": qos_off}

"""The comparison that decides `correct`.

Every number compared is a count of answers that differ from the
reference's, and every limit is 0: the configuration's guarantees are
exact (verdicts, bytes, table words).

- `unanswered`: frames sent whose batch never gave its verdicts back;
- `verdicts_off`: over every frame of every batch, those whose verdict
  (TX, FWD, DROP or PASS) differs from the reference's, and output frames
  that belong to no frame of their batch;
- `bytes_off`: in the batches the seed samples, output frames that differ
  from the reference's frame for the same input frame;
- `nat_words_off`: sampled NAT sessions whose words differ;
- `qos_words_off`: QoS buckets whose token or last_us word differs.

A frame's punt flag (a PASS the program hands to NAT44 as a new flow) is
judged through its verdict: the mixes hold established flows only, so
the reference expects no PASS and every punt is a PASS it counts.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from gpubench import packets as P
from gpubench.reference.bng import FWD, M32, TX

SESSION_SAMPLE = 4096
LIMITS = {"unanswered": 0, "verdicts_off": 0, "bytes_off": 0, "nat_words_off": 0,
          "qos_words_off": 0}
QW_KEY, QW_FLAGS, QW_TOKENS, QW_LAST_US = 0, 1, 6, 7


def expected_rows(ref, traffic, pos, verdict) -> tuple[np.ndarray, np.ndarray]:
    """The reference's output frame for each send position in `pos`: the
    OFFER where `verdict` is TX, the SNAT rewrite where it is FWD (rows of
    other verdicts stay empty)."""
    q = np.asarray(pos) % len(traffic)
    rows = np.zeros((len(q), P.ROW), dtype=np.uint8)
    lens = np.zeros(len(q), dtype=np.int64)
    tx, fw = verdict == TX, verdict == FWD
    if tx.any():
        rows[tx], lens[tx] = ref.offer_rows(traffic.ref[q[tx]], traffic.xid[q[tx]])
    if fw.any():
        rows[fw], lens[fw] = ref.snat_rows(traffic.ref[q[fw]], traffic.lens[q[fw]])
    return rows, lens


def rows_off(got_rows, got_lens, exp_rows, exp_lens) -> int:
    """Frames, paired one to one, whose length or live bytes differ."""
    w = got_rows.shape[1]
    live = np.arange(w)[None, :] < exp_lens[:, None]
    diff = ((got_rows != exp_rows[:, :w]) & live).any(1) | (got_lens != exp_lens)
    return int(diff.sum())


@dataclass
class Tables:
    """What the judge reads of the program's tables once the run is over:
    the NAT session table's keys, which rows are live and its device words,
    and the upstream QoS rows as the device left them."""

    session_keys: np.ndarray  # [S, 4] uint32
    session_live: np.ndarray  # [S] bool
    session_vals: np.ndarray  # [S, 16] uint32
    qos_rows: np.ndarray  # [R, 8] uint32


def read_tables(eng, tables) -> Tables:
    """Quiesce the engine and read its tables back (a synchronising read,
    after the window)."""
    eng.quiesce()
    nat = tables["nat"]
    return Tables(nat.sessions.keys, nat.sessions.used != 0, eng.fetch_session_vals(),
                  eng.tables.qos_up.rows.cpu().numpy().view(np.uint32))


def ring_checks(ref, traffic, batches, obs: Tables) -> dict:
    """Replay every batch the program ran through the reference and count
    what differs (see the module docstring). `batches` are the retired
    batches in order: first position, frames, now, each frame's verdict
    as the program gave it, output frames that matched no frame, and for
    sampled batches the output frames with their send positions."""
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
            er, el = expected_rows(ref, traffic, p[same], v[p[same]])
            bytes_off += rows_off(b["out_rows"][same], b["out_lens"][same], er, el)
    checks = {"unanswered": n_sent - sum(b["n"] for b in batches),
              "verdicts_off": verdicts_off, "bytes_off": bytes_off}
    checks.update(table_checks(ref, exp, obs))
    return {k: (int(val), LIMITS[k]) for k, val in checks.items()}


def session_keys(ds, flows) -> np.ndarray:
    return np.stack([ds.flow_src[flows], ds.flow_dst[flows],
                     ((ds.flow_sport[flows] & np.uint64(0xFFFF)) << np.uint64(16))
                     | (ds.flow_dport[flows] & np.uint64(0xFFFF)),
                     np.full(len(flows), 17, dtype=np.uint64)], axis=1).astype(np.uint32)


def table_checks(ref, exp, obs: Tables) -> dict:
    """NAT session words of a seeded sample of flows (half of them touched
    in the run), and the token words of every QoS bucket."""
    ds = ref.ds
    rng = np.random.default_rng(int(ds.now0) ^ len(exp["verdict"]))
    touched = np.nonzero(exp["fwd_count"])[0]
    pick = np.concatenate([rng.choice(touched, min(len(touched), SESSION_SAMPLE // 2),
                                      replace=False) if len(touched) else touched,
                           rng.integers(0, ds.n_flows, SESSION_SAMPLE // 2)])
    want = ref.session_rows(pick, exp["fwd_count"], exp["fwd_bytes"], exp["last_seen"])
    slots = find_rows(obs.session_keys, obs.session_live, session_keys(ds, pick))
    dev = obs.session_vals.astype(np.int64)
    nat_off = int((slots < 0).sum())
    ok = slots >= 0
    nat_off += int((dev[slots[ok], :15] != (want[ok, :15] & M32)).any(1).sum())

    rows = obs.qos_rows
    used = (rows[:, QW_FLAGS] & 1) != 0
    qslot = find_rows(rows[:, QW_KEY:QW_KEY + 1], used, ds.qos_ips.astype(np.uint32)[:, None])
    tok_bits = exp["tokens"].astype(np.float32).view(np.uint32)
    qos_off = int((qslot < 0).sum())
    ok = qslot >= 0
    qos_off += int(((rows[qslot[ok], QW_TOKENS] != tok_bits[ok])
                    | (rows[qslot[ok], QW_LAST_US] != (exp["last_us"][ok] & M32))).sum())
    return {"nat_words_off": nat_off, "qos_words_off": qos_off}


def find_rows(table_keys: np.ndarray, live: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """Row of each query key among the live rows of the program's table,
    -1 where it has none."""
    k = np.ascontiguousarray(table_keys.astype(np.uint32))
    q = np.ascontiguousarray(queries.astype(np.uint32))
    vt = np.dtype((np.void, 4 * k.shape[1]))
    kv = k.view(vt).ravel()
    qv = q.view(vt).ravel()
    idx = np.nonzero(live)[0]
    order = idx[np.argsort(kv[idx])]
    j = np.searchsorted(kv[order], qv)
    j = np.minimum(j, len(order) - 1)
    hit = kv[order][j] == qv
    return np.where(hit, order[j], -1)

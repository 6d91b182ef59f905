"""The plain reference: what the IPoE box answers, worked out in NumPy.

It reads the benchmark's dataset (`gpubench/dataset.py`) and the frames
the benchmark sent, and imports nothing of the program. From them it
works out again what the program derives at set-up and on the timed path:

- NAT44 port blocks: one block of `nat_ports_per_subscriber` ports per
  subscriber, carved in address order, public addresses filled one after
  the other (RFC 6431 port-set allocation, as `bpf/nat44.c` carves them);
  endpoint-independent mapping, so a subscriber's flows take the block's
  ports in source-port order;
- DHCP OFFERs (RFC 2131/2132) from the subscriber's pool, byte for byte;
- antispoof: a bound MAC must send from its bound address (strict), any
  other source must lie in the loose range;
- QoS: a token bucket per subscriber and direction, refilled at the
  policy's rate in float32 and capped at its burst; within a batch a frame
  passes when the bytes of its subscriber's frames up to and including it
  fit the tokens at the batch's start;
- the NAT session words a forwarded frame advances (packets, bytes,
  last_seen) and the QoS token words a batch leaves.
"""

from __future__ import annotations

import numpy as np

from gpubench import packets as P
from gpubench.dataset import Dataset, flow_mac, ip, ip_shard

PASS, DROP, TX, FWD = 0, 1, 2, 3
M32 = 0xFFFFFFFF
KIND_DISCOVER, KIND_FLOW = 0, 1
F32 = np.float32

# NAT session row words (the configuration's table layout)
SV_NAT_IP, SV_NAT_PORT, SV_ORIG_IP, SV_ORIG_PORT, SV_DEST_IP, SV_DEST_PORT = range(6)
SV_CREATED, SV_LAST_SEEN, SV_STATE, SV_PROTO = 6, 7, 8, 9
SV_PKTS_OUT, SV_BYTES_OUT = 11, 13
SESSION_WORDS = 16
CREATE_LEN = 100  # bytes the session's creating packet counted


class Reference:
    def __init__(self, ds: Dataset):
        self.ds = ds
        cfg = ds.cfg
        self.lease = int(cfg["lease_s"])
        self.expiry = (ds.now0 + self.lease) & M32
        # NAT: subscribers in address order, one block each
        n = int(cfg["nat_ports_per_subscriber"])
        lo, hi = (int(x) for x in cfg["nat_port_range"])
        per_ip = (hi - lo + 1) // n
        # a sharded box carves on each subscriber's affinity shard, from the
        # shard's own public addresses
        n_sh = int(cfg.get("shards", 1))
        per_shard = int(cfg.get("nat_public_ips_per_shard", len(ds.nat_public_ips)))
        subs = np.unique(ds.flow_src)
        shard = ip_shard(subs, n_sh) if n_sh > 1 else np.zeros(len(subs), dtype=np.int64)
        by = np.lexsort((subs, shard))
        first_of = np.searchsorted(shard[by], shard[by], side="left")
        sub_rank = np.empty(len(subs), dtype=np.int64)
        sub_rank[by] = np.arange(len(subs)) - first_of
        if (sub_rank // per_ip >= per_shard).any():
            raise ValueError("the configuration's public addresses hold too few blocks")
        i = np.searchsorted(subs, ds.flow_src)
        rank = sub_rank[i]
        start = lo + (rank % per_ip) * n
        # the flows of one subscriber in source-port order
        order = np.lexsort((ds.flow_sport, ds.flow_src))
        k = np.empty(len(order), dtype=np.int64)
        grp = ds.flow_src[order]
        first = np.r_[True, grp[1:] != grp[:-1]]
        starts = np.maximum.accumulate(np.where(first, np.arange(len(grp)), 0))
        k[order] = np.arange(len(grp)) - starts
        if (k >= n).any():
            raise ValueError("a subscriber has more flows than its block has ports")
        self.nat_ip = ds.nat_public_ips[shard[i] * per_shard + rank // per_ip]
        self.nat_port = (start + k).astype(np.uint64)
        # QoS policies (the upstream direction: every flow frame is from access)
        pol, gen = cfg["qos_policed"], cfg["qos_generous"]
        self.qos_order = np.argsort(ds.qos_ips)
        self.qos_sorted = ds.qos_ips[self.qos_order]
        self.q_rate = np.where(ds.qos_policed, pol["rate_bps"], gen["up_bps"]).astype(np.int64)
        self.q_burst = np.where(ds.qos_policed, pol["burst"], gen["up_burst"]).astype(np.int64)
        self.bound = np.unique(ds.bind_ips)
        net, plen = cfg["antispoof_loose_range"]
        self.loose_mask = (M32 << (32 - int(plen))) & M32
        self.loose_net = ip(net) & self.loose_mask

    # -- per-frame answers ------------------------------------------------

    def policy_of(self, src_ips) -> np.ndarray:
        """Index of each address's QoS policy, -1 for none."""
        j = np.searchsorted(self.qos_sorted, src_ips)
        j = np.minimum(j, len(self.qos_sorted) - 1)
        hit = self.qos_sorted[j] == src_ips
        return np.where(hit, self.qos_order[j], -1)

    def antispoof_ok(self, flows) -> np.ndarray:
        """Flow frames carry their address's flow MAC: a bound MAC must send
        from its binding (it does), anything else from the loose range."""
        src = self.ds.flow_src[flows]
        bound = np.isin(src, self.bound)
        in_range = (src & np.uint64(self.loose_mask)) == np.uint64(self.loose_net)
        return bound | in_range

    def offer_rows(self, subs, xids) -> tuple[np.ndarray, np.ndarray]:
        """The OFFER for each DISCOVER: broadcast from the server to
        255.255.255.255:68, yiaddr the subscriber's address, options 53,
        54, 51 (the pool's lease), 1, 3, 6, 58 (T1 = lease/2), 59
        (T2 = 7/8 lease), 255."""
        ds, cfg = self.ds, self.ds.cfg
        n = len(subs)
        rows = np.zeros((n, P.ROW), dtype=np.uint8)
        rows[:, 0:6] = 0xFF
        rows[:, 6:12] = P.mac_bytes(np.full(n, ds.server_mac))
        rows[:, 12:14] = (0x08, 0x00)
        opt_len = P.OFFER_OPTIONS
        udp_len = P.UDP + P.BOOTP + opt_len
        rows[:, P.ETH:P.ETH + P.IP4] = P.ipv4_header(ds.server_ip, M32, udp_len, 17, n)
        u = P.ETH + P.IP4
        rows[:, u:u + 8] = P.be(np.array([67, 68, udp_len, 0]), 2).reshape(-1)
        d = u + P.UDP
        rows[:, d:d + 4] = (2, 1, 6, 0)
        rows[:, d + 4:d + 8] = P.be(xids, 4)
        rows[:, d + 16:d + 20] = P.be(ds.sub_ips[subs], 4)
        rows[:, d + 20:d + 24] = P.be(np.full(n, ds.server_ip), 4)
        rows[:, d + 28:d + 34] = P.mac_bytes(ds.sub_macs[subs])
        rows[:, d + 236:d + 240] = P.be([P.DHCP_MAGIC], 4)
        plen = int(cfg["pool_prefix_len"])
        mask = (M32 << (32 - plen)) & M32
        dns1, dns2 = (ip(x) for x in cfg["pool_dns"])
        lease = self.lease
        opts = ([53, 1, 2, 54, 4] + list(P.be([ds.server_ip], 4)[0])
                + [51, 4] + list(P.be([lease], 4)[0]) + [1, 4] + list(P.be([mask], 4)[0])
                + [3, 4] + list(P.be([ip(cfg["pool_gateway"])], 4)[0])
                + [6, 8] + list(P.be([dns1, dns2], 4).reshape(-1))
                + [58, 4] + list(P.be([lease // 2], 4)[0])
                + [59, 4] + list(P.be([((lease * 7) & M32) // 8], 4)[0]) + [255])
        assert len(opts) == opt_len
        rows[:, d + 240:d + 240 + opt_len] = np.array(opts, dtype=np.uint8)
        return rows, np.full(n, P.OFFER_LEN, dtype=np.int64)

    def snat_rows(self, flows, frame_lens) -> tuple[np.ndarray, np.ndarray]:
        """A forwarded flow frame of the length it was sent at: source
        address and port from the subscriber's block, IPv4 and UDP
        checksums valid."""
        ds = self.ds
        return P.flow_rows(flow_mac(ds.flow_src[flows]), self.nat_ip[flows], ds.flow_dst[flows],
                           self.nat_port[flows], ds.flow_dport[flows], frame_lens)

    # -- the history of a run ----------------------------------------------

    def run(self, kind, ref, lens, batches) -> dict:
        """Expected verdict of every frame sent, and the table words left.

        kind, ref, lens: [G] the frame at each position of the send order
        (a DISCOVER of subscriber `ref`, or a frame of flow `ref`) and its
        length in bytes; batches:
        [(first position, frames, now)] in the order the program ran them.
        Returns {"verdict": [G], "tokens", "last_us": [Q] each bucket's
        words, "fwd_count", "fwd_bytes", "last_seen": [F] each session's}."""
        G = len(kind)
        verdict = np.full(G, PASS, dtype=np.int8)
        flows_all = np.where(kind == KIND_FLOW, ref, 0)
        spoof_ok = np.zeros(G, dtype=bool)
        fl_pos = np.nonzero(kind == KIND_FLOW)[0]
        spoof_ok[fl_pos] = self.antispoof_ok(ref[fl_pos])
        pol_all = np.full(G, -1, dtype=np.int64)
        pol_all[fl_pos] = self.policy_of(self.ds.flow_src[ref[fl_pos]])
        tokens = self.q_burst.astype(F32)  # buckets start full
        last_us = np.zeros(len(tokens), dtype=np.int64)
        last_seen = np.full(self.ds.n_flows, self.ds.now0 & M32, dtype=np.int64)
        fwd_count = np.zeros(self.ds.n_flows, dtype=np.int64)
        fwd_bytes = np.zeros(self.ds.n_flows, dtype=np.int64)
        lens = np.asarray(lens, dtype=np.int64)
        for g0, n, now in batches:
            sl = slice(g0, g0 + n)
            now_s, now_us = int(now) & M32, int(now * 1e6) & M32
            k = kind[sl]
            v = np.full(n, PASS, dtype=np.int8)
            v[(k == KIND_DISCOVER) & (now_s <= self.expiry)] = TX
            isf = k == KIND_FLOW
            allowed = isf & spoof_ok[sl]
            v[isf & ~spoof_ok[sl]] = DROP
            pol = pol_all[sl]
            lanes = np.nonzero(allowed & (pol >= 0))[0]
            qdrop = np.zeros(n, dtype=bool)
            if len(lanes):
                qdrop[lanes] = self._tbf(pol[lanes], lens[sl][lanes], now_us, tokens, last_us)
            v[allowed & qdrop] = DROP
            v[allowed & ~qdrop] = FWD
            verdict[sl] = v
            fw = flows_all[sl][v == FWD]
            np.add.at(fwd_count, fw, 1)
            np.add.at(fwd_bytes, fw, lens[sl][v == FWD])
            last_seen[fw] = now_s
        return {"verdict": verdict, "tokens": tokens, "last_us": last_us,
                "fwd_count": fwd_count, "fwd_bytes": fwd_bytes, "last_seen": last_seen}

    def _tbf(self, pols, flens, now_us: int, tokens, last_us) -> np.ndarray:
        """One batch's frames of policed subscribers and their lengths, in
        lane order; returns which drop, and leaves each bucket's tokens and
        last_us."""
        drop = np.zeros(len(pols), dtype=bool)
        for p in np.unique(pols):
            lanes = np.nonzero(pols == p)[0]
            burst = F32(self.q_burst[p])
            elapsed = F32((now_us - int(last_us[p])) & M32)
            refill = F32(F32(elapsed * F32(F32(self.q_rate[p]) / F32(8.0))) * F32(1e-6))
            avail = min(F32(tokens[p] + refill), burst)
            cum = np.cumsum(flens[lanes])
            ok = cum.astype(F32) <= avail
            drop[lanes] = ~ok
            consumed = F32(int(flens[lanes][ok].sum()))
            tokens[p] = min(max(F32(avail - consumed), F32(0.0)), burst)
            last_us[p] = now_us
        return drop

    def session_rows(self, flows, fwd_count, fwd_bytes, last_seen) -> np.ndarray:
        """The NAT session words of these flows after the run."""
        ds = self.ds
        rows = np.zeros((len(flows), SESSION_WORDS), dtype=np.int64)
        rows[:, SV_NAT_IP] = self.nat_ip[flows]
        rows[:, SV_NAT_PORT] = self.nat_port[flows]
        rows[:, SV_ORIG_IP] = ds.flow_src[flows]
        rows[:, SV_ORIG_PORT] = ds.flow_sport[flows]
        rows[:, SV_DEST_IP] = ds.flow_dst[flows]
        rows[:, SV_DEST_PORT] = ds.flow_dport[flows]
        rows[:, SV_CREATED] = ds.now0 & M32
        rows[:, SV_LAST_SEEN] = last_seen[flows]
        rows[:, SV_PROTO] = 17
        rows[:, SV_PKTS_OUT] = (1 + fwd_count[flows]) & M32
        rows[:, SV_BYTES_OUT] = (CREATE_LEN + fwd_bytes[flows]) & M32
        return rows

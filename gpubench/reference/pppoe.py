"""The plain reference of the PPPoE-over-QinQ box, worked out in NumPy.

It reads the benchmark's PPPoE dataset (`gpubench/pppoe_data.py`: the
configuration's numbers and the seed's placement) and the frames the
benchmark sent, and imports nothing of the program. What it derives:

- framing: the access side is 802.1ad with 1:1 VLANs (BBF TR-101): a
  subscriber's line is an S-tag (TPID 0x88a8) and a C-tag (0x8100); on it
  the subscriber runs PPPoE (RFC 2516) to the access concentrator (AC):
  ethertype 0x8864, ver/type 0x11, code 0, the session id, the payload
  length (PPP protocol field included), PPP protocol 0x0021 for IPv4
  (RFC 1332). An upstream data frame of an open session, on its own line,
  leaves for the core as plain Ethernet + IPv4: the tags and the PPPoE
  header are gone. A downstream frame to a session's address gets them:
  the line's S/C tags, the PPPoE header and PPP protocol, the AC's MAC as
  source and the subscriber's as destination;
- NAT44 (RFC 3022, RFC 6431 port sets as `bpf/nat44.c` carves them): one
  block of `nat_ports_per_subscriber` ports per session address, carved
  in address order, public addresses filled one after the other;
  endpoint-independent mapping, so a session's flows take the block's
  ports in source-port order. Upstream SNAT rewrites the source address
  and port, downstream DNAT the destination; IPv4 and UDP checksums are
  computed afresh (RFC 791, RFC 768);
- antispoof: an upstream source must lie in the loose range;
- QoS: a token bucket per session and direction, refilled at the tier's
  rate in float32 and capped at its burst; within a batch a frame passes
  when the bytes of its session's frames of that direction up to and
  including it fit the tokens at the batch's start;
- the NAT session words a forwarded frame advances (packets and bytes
  each way, last_seen) and both QoS tables' token words.

Departures from the RFCs, each the configuration's choice:
- a forwarded upstream frame keeps the L2 addresses it came with (the
  AC's MAC as destination, the subscriber's as source): the next-hop
  rewrite is the edge stage's, which this deployment leaves off;
- no hop decrements the IPv4 TTL (RFC 1812 §5.3.1 would);
- an LCP Echo-Request is handed to the host's control plane (PASS),
  which answers it (RFC 1661 §5.8), not answered on the device;
- a session's upstream frame from another line than its own is handed
  to the control plane too (PASS), not dropped;
- byte counters and token buckets count the frame at the NAT stage:
  upstream the decapsulated frame (Ethernet header and IPv4 datagram),
  downstream the frame as it came from the core, not the bytes on the
  access wire;
- written tags carry priority 0 (PCP and DEI bits clear); frames carry
  no FCS (rows end before it), as everywhere in the benchmark.
"""

from __future__ import annotations

import numpy as np

from gpubench import packets as P
from gpubench.dataset import ip

PASS, DROP, TX, FWD = 0, 1, 2, 3
M32 = 0xFFFFFFFF
F32 = np.float32
KIND_UP, KIND_DOWN, KIND_LCP = 0, 1, 2

ETH, IP4, UDP = 14, 20, 8
QINQ = 8  # S-tag + C-tag
PPPOE = 8  # PPPoE header (6) + PPP protocol (2)
TPID_S, TPID_C = 0x88A8, 0x8100
ETH_PPPOE_SESSION, ETH_IP = 0x8864, 0x0800
PPP_IPV4, PPP_LCP = 0x0021, 0xC021
LCP_ECHO_REQUEST = 9
MIN_FRAME = 60  # an Ethernet frame without its FCS is padded to this
CORE_ROUTER_MAC = 0x040404040404  # the core side's next hop, downstream source
PAYLOAD = ord("x")  # every data byte after the UDP header

# NAT session row words (the configuration's table layout)
(SV_NAT_IP, SV_NAT_PORT, SV_ORIG_IP, SV_ORIG_PORT, SV_DEST_IP, SV_DEST_PORT,
 SV_CREATED, SV_LAST_SEEN, SV_STATE, SV_PROTO, SV_FLAGS,
 SV_PKTS_OUT, SV_PKTS_IN, SV_BYTES_OUT, SV_BYTES_IN) = range(15)
SESSION_WORDS = 16
CREATE_LEN = 100  # bytes the session's creating packet counted


def ones_sum(rows: np.ndarray) -> np.ndarray:
    """One's complement sum, folded to 16 bits, of each row's big-endian
    16-bit words (a row of odd width is padded with a zero byte)."""
    if rows.shape[1] & 1:
        rows = np.concatenate([rows, np.zeros((len(rows), 1), dtype=np.uint8)], axis=1)
    s = (rows[:, 0::2].astype(np.uint64) << np.uint64(8)
         | rows[:, 1::2].astype(np.uint64)).sum(axis=1)
    while (s >> np.uint64(16)).any():
        s = (s & np.uint64(0xFFFF)) + (s >> np.uint64(16))
    return s


def datagrams(src, dst, sport, dport, ip_len: int) -> np.ndarray:
    """[n, ip_len] IPv4/UDP datagrams (RFC 791: no options, TTL 64, id 0;
    RFC 768: checksum over the pseudo-header, 0 sent as 0xFFFF) whose
    payload is all PAYLOAD bytes."""
    n = len(src)
    pay = ip_len - IP4 - UDP
    rows = np.zeros((n, ip_len), dtype=np.uint8)
    rows[:, :IP4] = P.ipv4_header(src, dst, UDP + pay, 17, n)
    rows[:, IP4:IP4 + 2] = P.be(sport, 2)
    rows[:, IP4 + 2:IP4 + 4] = P.be(dport, 2)
    rows[:, IP4 + 4:IP4 + 6] = P.be(np.full(n, UDP + pay), 2)
    rows[:, IP4 + UDP:] = PAYLOAD
    # the payload's words are the same in every datagram: summed once
    pay_sum = ones_sum(np.full((1, pay), PAYLOAD, dtype=np.uint8))[0]
    head = np.zeros((n, 20), dtype=np.uint8)  # pseudo-header + UDP header
    head[:, 0:8] = rows[:, 12:20]
    head[:, 9] = 17
    head[:, 10:12] = P.be(np.full(n, UDP + pay), 2)
    head[:, 12:20] = rows[:, IP4:IP4 + UDP]
    s = ones_sum(head) + pay_sum
    s = (s & np.uint64(0xFFFF)) + (s >> np.uint64(16))
    c = ~s & np.uint64(0xFFFF)
    rows[:, IP4 + 6:IP4 + 8] = P.be(np.where(c == 0, 0xFFFF, c), 2)
    return rows


def line_header(dst_macs, src_macs, s_tags, c_tags) -> np.ndarray:
    """[n, 22] the L2 head of a frame on a subscriber's line: MACs, the
    S-tag and the C-tag (priority 0), ethertype PPPoE session."""
    n = len(s_tags)
    h = np.zeros((n, ETH + QINQ), dtype=np.uint8)
    h[:, 0:6] = P.mac_bytes(dst_macs)
    h[:, 6:12] = P.mac_bytes(src_macs)
    h[:, 12:14] = P.be([TPID_S], 2)
    h[:, 14:16] = P.be(s_tags, 2)
    h[:, 16:18] = P.be([TPID_C], 2)
    h[:, 18:20] = P.be(c_tags, 2)
    h[:, 20:22] = P.be([ETH_PPPOE_SESSION], 2)
    return h


def pppoe_header(session_ids, ppp_payload_len: int, proto: int) -> np.ndarray:
    """[n, 8] PPPoE session header (ver/type 0x11, code 0, the session id,
    the length of the PPP protocol field and what follows) and the PPP
    protocol."""
    n = len(session_ids)
    h = np.zeros((n, PPPOE), dtype=np.uint8)
    h[:, 0], h[:, 1] = 0x11, 0
    h[:, 2:4] = P.be(session_ids, 2)
    h[:, 4:6] = P.be(np.full(n, 2 + ppp_payload_len), 2)
    h[:, 6:8] = P.be(np.full(n, proto), 2)
    return h


def put(rows: np.ndarray, parts: list[np.ndarray]) -> int:
    """Write the parts one after the other from column 0; returns the
    length written."""
    o = 0
    for p in parts:
        rows[:, o:o + p.shape[1]] = p
        o += p.shape[1]
    return o


class Reference:
    """What the box answers for the dataset `ds` (`pppoe_data.Dataset`)."""

    def __init__(self, ds):
        self.ds = ds
        cfg = ds.cfg
        # NAT: session addresses in address order, one block each
        n = int(cfg["nat_ports_per_subscriber"])
        lo, hi = (int(x) for x in cfg["nat_port_range"])
        per_ip = (hi - lo + 1) // n
        subs = np.unique(ds.sub_ips)
        rank = np.searchsorted(subs, ds.sub_ips)
        if (rank // per_ip >= len(ds.nat_public_ips)).any():
            raise ValueError("the configuration's public addresses hold too few blocks")
        # a session's flows, in source-port order, take its block's ports
        order = np.lexsort((ds.flow_sport, ds.flow_session))
        k = np.empty(ds.n_flows, dtype=np.int64)
        grp = ds.flow_session[order]
        first = np.r_[True, grp[1:] != grp[:-1]]
        starts = np.maximum.accumulate(np.where(first, np.arange(len(grp)), 0))
        k[order] = np.arange(len(grp)) - starts
        if (k >= n).any():
            raise ValueError("a session has more flows than its block has ports")
        r = rank[ds.flow_session]
        self.nat_ip = ds.nat_public_ips[r // per_ip]
        self.nat_port = (lo + (r % per_ip) * n + k).astype(np.uint64)
        # QoS: the tier of each session, each direction
        over, std = cfg["qos_over_quota"], cfg["qos_standard"]
        oq = ds.over_quota
        self.rate = {KIND_UP: np.where(oq, over["rate_bps"], std["up_bps"]).astype(np.int64),
                     KIND_DOWN: np.where(oq, over["rate_bps"], std["down_bps"]).astype(np.int64)}
        self.burst = {KIND_UP: np.where(oq, over["burst"], std["up_burst"]).astype(np.int64),
                      KIND_DOWN: np.where(oq, over["burst"], std["down_burst"]).astype(np.int64)}
        net, plen = cfg["antispoof_loose_range"]
        self.loose_mask = (M32 << (32 - int(plen))) & M32
        self.loose_net = ip(net) & self.loose_mask

    # -- the frames sent ---------------------------------------------------

    def upstream_rows(self, flows, frame_len: int, width: int) -> tuple[np.ndarray, np.ndarray]:
        """A session's data on its line: UDP from its address and source
        port to the flow's far end, in PPPoE over its S/C tags, to the AC."""
        ds = self.ds
        s = ds.flow_session[flows]
        ip_len = frame_len - ETH - QINQ - PPPOE
        rows = np.zeros((len(flows), width), dtype=np.uint8)
        put(rows, [line_header(np.full(len(s), ds.ac_mac), ds.sub_macs[s], ds.s_tags[s],
                               ds.c_tags[s]),
                   pppoe_header(ds.session_ids[s], ip_len, PPP_IPV4),
                   datagrams(ds.sub_ips[s], ds.flow_dst[flows], ds.flow_sport[flows],
                             ds.flow_dport[flows], ip_len)])
        return rows, np.full(len(flows), frame_len, dtype=np.int64)

    def downstream_rows(self, flows, frame_len: int, width: int) -> tuple[np.ndarray, np.ndarray]:
        """The far end's UDP to the flow's public address and port, as it
        arrives from the core: plain Ethernet + IPv4 to the AC's MAC."""
        ds = self.ds
        n = len(flows)
        rows = np.zeros((n, width), dtype=np.uint8)
        rows[:, 0:6] = P.mac_bytes(np.full(n, ds.ac_mac))
        rows[:, 6:12] = P.mac_bytes(np.full(n, CORE_ROUTER_MAC))
        rows[:, 12:14] = P.be([ETH_IP], 2)
        rows[:, ETH:frame_len] = datagrams(ds.flow_dst[flows], self.nat_ip[flows],
                                           ds.flow_dport[flows], self.nat_port[flows],
                                           frame_len - ETH)
        return rows, np.full(n, frame_len, dtype=np.int64)

    def lcp_rows(self, sessions, idents, width: int) -> tuple[np.ndarray, np.ndarray]:
        """An LCP Echo-Request (RFC 1661 §5.8: code 9, the identifier, length
        8, the magic number) on each session's line, padded to 60 bytes."""
        ds = self.ds
        n = len(sessions)
        lcp = np.zeros((n, 8), dtype=np.uint8)
        lcp[:, 0] = LCP_ECHO_REQUEST
        lcp[:, 1] = np.asarray(idents) & 0xFF
        lcp[:, 2:4] = P.be(np.full(n, 8), 2)
        lcp[:, 4:8] = P.be(ds.sub_macs[sessions] & np.uint64(M32), 4)  # the client's magic
        rows = np.zeros((n, width), dtype=np.uint8)
        put(rows, [line_header(np.full(n, ds.ac_mac), ds.sub_macs[sessions],
                               ds.s_tags[sessions], ds.c_tags[sessions]),
                   pppoe_header(ds.session_ids[sessions], 8, PPP_LCP), lcp])
        return rows, np.full(n, MIN_FRAME, dtype=np.int64)

    # -- the frames expected back --------------------------------------------

    def snat_rows(self, flows, frame_len: int, width: int) -> tuple[np.ndarray, np.ndarray]:
        """A forwarded upstream frame: the L2 addresses it came with, no
        tags, no PPPoE, the IPv4 datagram from the session's public
        address and port."""
        ds = self.ds
        s = ds.flow_session[flows]
        n = len(flows)
        ip_len = frame_len - ETH - QINQ - PPPOE
        rows = np.zeros((n, width), dtype=np.uint8)
        rows[:, 0:6] = P.mac_bytes(np.full(n, ds.ac_mac))
        rows[:, 6:12] = P.mac_bytes(ds.sub_macs[s])
        rows[:, 12:14] = P.be([ETH_IP], 2)
        rows[:, ETH:ETH + ip_len] = datagrams(self.nat_ip[flows], ds.flow_dst[flows],
                                              self.nat_port[flows], ds.flow_dport[flows], ip_len)
        return rows, np.full(n, ETH + ip_len, dtype=np.int64)

    def encap_rows(self, flows, frame_len: int, width: int) -> tuple[np.ndarray, np.ndarray]:
        """A forwarded downstream frame: to the session's address and port,
        in PPPoE over the session's S/C tags, from the AC's MAC to the
        subscriber's."""
        ds = self.ds
        s = ds.flow_session[flows]
        ip_len = frame_len - ETH
        rows = np.zeros((len(flows), width), dtype=np.uint8)
        n = put(rows, [line_header(ds.sub_macs[s], np.full(len(s), ds.ac_mac), ds.s_tags[s],
                                   ds.c_tags[s]),
                       pppoe_header(ds.session_ids[s], ip_len, PPP_IPV4),
                       datagrams(ds.flow_dst[flows], ds.sub_ips[s], ds.flow_dport[flows],
                                 ds.flow_sport[flows], ip_len)])
        return rows, np.full(len(flows), n, dtype=np.int64)

    def expected_rows(self, kind, ref, lens, verdict, width: int):
        """The output frame for each frame sent (its kind, flow and length)
        whose verdict is FWD; other rows stay empty."""
        rows = np.zeros((len(kind), width), dtype=np.uint8)
        out_lens = np.zeros(len(kind), dtype=np.int64)
        for k, make in ((KIND_UP, self.snat_rows), (KIND_DOWN, self.encap_rows)):
            for flen in np.unique(lens[(kind == k) & (verdict == FWD)]):
                sel = np.nonzero((kind == k) & (verdict == FWD) & (lens == flen))[0]
                rows[sel], out_lens[sel] = make(ref[sel], int(flen), width)
        return rows, out_lens

    # -- the history of a run ----------------------------------------------

    def accounted_len(self, kind, lens) -> np.ndarray:
        """The bytes a frame counts at the NAT stage: upstream without its
        tags and PPPoE framing, downstream as it came."""
        return np.where(kind == KIND_UP, lens - QINQ - PPPOE, lens).astype(np.int64)

    def run(self, kind, ref, lens, batches) -> dict:
        """Expected verdict of every frame sent, and the table words left.

        kind, ref, lens: [G] the frame at each position of the send order
        (KIND_UP or KIND_DOWN of flow `ref`, KIND_LCP of session `ref`) and
        its length; batches: [(first position, frames, now)] in the order
        the program ran them. Returns {"verdict": [G], "tokens", "last_us":
        {direction: [S] each session's bucket words}, "pkts", "bytes":
        {direction: [F] each flow's forwarded frames and bytes},
        "last_seen": [F]}."""
        ds = self.ds
        G = len(kind)
        verdict = np.full(G, PASS, dtype=np.int8)
        flow = np.where(kind != KIND_LCP, ref, 0)
        sess = ds.flow_session[flow]
        src = ds.sub_ips[sess]
        spoof_ok = (src & np.uint64(self.loose_mask)) == np.uint64(self.loose_net)
        acc = self.accounted_len(kind, np.asarray(lens, dtype=np.int64))
        tokens = {d: self.burst[d].astype(F32) for d in (KIND_UP, KIND_DOWN)}  # buckets start full
        last_us = {d: np.zeros(ds.n_sessions, dtype=np.int64) for d in (KIND_UP, KIND_DOWN)}
        pkts = {d: np.zeros(ds.n_flows, dtype=np.int64) for d in (KIND_UP, KIND_DOWN)}
        nbytes = {d: np.zeros(ds.n_flows, dtype=np.int64) for d in (KIND_UP, KIND_DOWN)}
        last_seen = np.full(ds.n_flows, ds.now0 & M32, dtype=np.int64)
        for g0, n, now in batches:
            sl = slice(g0, g0 + n)
            now_s, now_us = int(now) & M32, int(now * 1e6) & M32
            k = kind[sl]
            v = np.full(n, PASS, dtype=np.int8)
            up_bad = (k == KIND_UP) & ~spoof_ok[sl]
            v[up_bad] = DROP
            for d in (KIND_UP, KIND_DOWN):
                lanes = np.nonzero((k == d) & ~up_bad)[0]
                if not len(lanes):
                    continue
                drop = self._tbf(d, sess[sl][lanes], acc[sl][lanes], now_us, tokens[d],
                                 last_us[d])
                v[lanes] = np.where(drop, DROP, FWD)
                fw = flow[sl][lanes[~drop]]
                np.add.at(pkts[d], fw, 1)
                np.add.at(nbytes[d], fw, acc[sl][lanes[~drop]])
                last_seen[fw] = now_s
            verdict[sl] = v
        return {"verdict": verdict, "tokens": tokens, "last_us": last_us, "pkts": pkts,
                "bytes": nbytes, "last_seen": last_seen}

    @staticmethod
    def rnd(x):
        """Each token-bucket value as it is kept: float32 (the control
        rounds it lower)."""
        return x

    def _tbf(self, d: int, subs, flens, now_us: int, tokens, last_us) -> np.ndarray:
        """One batch's frames of direction d (their sessions and lengths, in
        lane order); returns which drop, and leaves each bucket's tokens and
        last_us. Every bucket's arithmetic is float32, as a scalar one
        would be, on all of the batch's sessions at once."""
        r = self.rnd
        order = np.argsort(subs, kind="stable")
        s, fl = subs[order], flens[order]
        first = np.r_[True, s[1:] != s[:-1]]
        starts = np.flatnonzero(first)
        grp = np.cumsum(first) - 1  # each lane's session, among the batch's
        p = s[starts]
        burst = r(self.burst[d][p].astype(F32))
        elapsed = r(((now_us - last_us[p]) & M32).astype(F32))
        refill = r(r(elapsed * r(self.rate[d][p].astype(F32) / F32(8.0))) * F32(1e-6))
        avail = np.minimum(r(r(tokens[p]) + refill), burst)
        cum = np.cumsum(fl)
        cum -= (cum - fl)[starts][grp]  # bytes of the session's lanes up to this one
        ok = cum.astype(F32) <= avail[grp]
        consumed = np.bincount(grp, weights=np.where(ok, fl, 0), minlength=len(p))
        tokens[p] = np.minimum(np.maximum(r(avail - consumed.astype(np.int64).astype(F32)),
                                          F32(0.0)), burst)
        last_us[p] = now_us
        drop = np.empty(len(subs), dtype=bool)
        drop[order] = ~ok
        return drop

    def session_rows(self, flows, exp: dict) -> np.ndarray:
        """The NAT session words of these flows after the run."""
        ds = self.ds
        rows = np.zeros((len(flows), SESSION_WORDS), dtype=np.int64)
        rows[:, SV_NAT_IP] = self.nat_ip[flows]
        rows[:, SV_NAT_PORT] = self.nat_port[flows]
        rows[:, SV_ORIG_IP] = ds.sub_ips[ds.flow_session[flows]]
        rows[:, SV_ORIG_PORT] = ds.flow_sport[flows]
        rows[:, SV_DEST_IP] = ds.flow_dst[flows]
        rows[:, SV_DEST_PORT] = ds.flow_dport[flows]
        rows[:, SV_CREATED] = ds.now0 & M32
        rows[:, SV_LAST_SEEN] = exp["last_seen"][flows]
        rows[:, SV_PROTO] = 17
        rows[:, SV_PKTS_OUT] = (1 + exp["pkts"][KIND_UP][flows]) & M32
        rows[:, SV_PKTS_IN] = exp["pkts"][KIND_DOWN][flows] & M32
        rows[:, SV_BYTES_OUT] = (CREATE_LEN + exp["bytes"][KIND_UP][flows]) & M32
        rows[:, SV_BYTES_IN] = exp["bytes"][KIND_DOWN][flows] & M32
        return rows

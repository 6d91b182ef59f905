"""Cluster carve plan: disjoint address ownership across N instances.

The cluster address space is split into equal power-of-two blocks (each
block is a well-formed `Pool` network). The plan assigns whole blocks to
instances and keeps unassigned blocks on a free list — a block is always
owned by exactly one instance or free, never split and never shared.
Re-carving on join/leave follows the `SlowPathFleet.resize` transfer
discipline one level up: a leaving instance's blocks return to the free
list only after its leases drained, and a member's blocks never move
while it stays a member (never-half-allocate).

NAT public ranges ride on the same block index: block `i` of the space
implies NAT slice `i` of the NAT range, so NAT disjointness is inherited
from block disjointness instead of being tracked separately.

Steering uses the same FNV-1a32 family as `fleet.shard_for_mac` — one
placement function across worker sharding, device sharding and the
cluster front door. `steer_macs_u48` is the bit-exact vectorized form
for storm-scale steering (millions of MACs in one numpy pass).

A copy of `bng_tpu/cluster/plan.py` with its imports renamed.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from bng_tpu_torch.utils.net import FNV1A32_OFFSET, FNV1A32_PRIME, fnv1a32

_U32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# steering
# ---------------------------------------------------------------------------

def instance_for_mac(mac: bytes, member_ids: tuple) -> str:
    """Steer a subscriber MAC to a member instance id. `member_ids`
    MUST be sorted — every caller (coordinator, storm, audit) sorts the
    same way, so placement is a pure function of (mac, membership)."""
    if not member_ids:
        raise ValueError("no cluster members to steer to")
    return member_ids[fnv1a32(mac[:6]) % len(member_ids)]


def steer_macs_u48(mac_u48, n: int):
    """Vectorized FNV-1a32 over big-endian 6-byte MACs packed as u48
    ints -> member index array. Bit-exact vs `fnv1a32(mac[:6]) % n`
    (pinned by tests on a seeded sample)."""
    import numpy as np

    if n <= 0:
        raise ValueError("n must be positive")
    m = np.asarray(mac_u48, dtype=np.uint64)
    h = np.full(m.shape, FNV1A32_OFFSET, dtype=np.uint32)
    prime = np.uint32(FNV1A32_PRIME)
    with np.errstate(over="ignore"):
        for shift in (40, 32, 24, 16, 8, 0):
            h = (h ^ ((m >> np.uint64(shift)) & np.uint64(0xFF)).astype(
                np.uint32)) * prime
    return (h % np.uint32(n)).astype(np.int64)


# ---------------------------------------------------------------------------
# plan structures
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CarvedBlock:
    """One power-of-two slice of the cluster space. `index` is the
    block's position in the split (ties the NAT slice to it); `pool_id`
    is stable for the block's lifetime so a Pool built from it keeps
    its identity across instances."""

    network: int
    prefix_len: int
    index: int

    @property
    def pool_id(self) -> int:
        return self.index + 1  # pool ids are 1-based everywhere else

    @property
    def size(self) -> int:
        return 1 << (32 - self.prefix_len)

    @property
    def last(self) -> int:
        return self.network + self.size - 1

    def contains(self, ip: int) -> bool:
        return self.network <= ip <= self.last

    def to_dict(self) -> dict:
        return {"network": self.network, "prefix_len": self.prefix_len,
                "index": self.index}

    @classmethod
    def from_dict(cls, d: dict) -> "CarvedBlock":
        return cls(network=int(d["network"]), prefix_len=int(d["prefix_len"]),
                   index=int(d["index"]))


@dataclass
class InstancePlan:
    """One instance's carve: whole blocks plus the NAT slices they
    imply. `host` is the placement axis the fabric added: which machine
    the instance runs on ("" = unplaced, the single-host legacy)."""

    instance_id: str
    blocks: list = field(default_factory=list)  # list[CarvedBlock]
    host: str = ""

    def addresses(self) -> int:
        return sum(b.size for b in self.blocks)

    def contains(self, ip: int) -> bool:
        return any(b.contains(ip) for b in self.blocks)

    def to_dict(self) -> dict:
        return {"instance_id": self.instance_id,
                "blocks": [b.to_dict() for b in self.blocks],
                "host": self.host}

    @classmethod
    def from_dict(cls, d: dict) -> "InstancePlan":
        return cls(instance_id=d["instance_id"],
                   blocks=[CarvedBlock.from_dict(b) for b in d["blocks"]],
                   host=str(d.get("host", "")))


@dataclass
class ClusterPlan:
    """The carve authority: which instance owns which blocks.

    `epoch` increments on every assignment change — instances compare it
    to decide whether to re-apply, and checkpoints carry it so a
    restarted coordinator resumes from the same carve.
    """

    space_network: int
    space_prefix_len: int
    block_prefix_len: int
    nat_base: int = 0
    nat_total: int = 0
    epoch: int = 0
    members: dict = field(default_factory=dict)  # id -> InstancePlan
    free: list = field(default_factory=list)     # list[CarvedBlock]

    # -- derived ----------------------------------------------------------
    @property
    def n_blocks(self) -> int:
        return 1 << (self.block_prefix_len - self.space_prefix_len)

    def member_ids(self) -> tuple:
        return tuple(sorted(self.members))

    def serving_ids(self) -> tuple:
        """Members that own blocks — the steering set. A joiner waiting
        on free blocks is a member but not yet a steering target (it
        has no addresses to answer with)."""
        return tuple(sorted(i for i, p in self.members.items() if p.blocks))

    def hosts(self) -> dict:
        return {i: p.host for i, p in sorted(self.members.items())}

    @property
    def n_hosts(self) -> int:
        """Distinct placement hosts in the carve ("" counts as one host:
        the unplaced single-machine legacy)."""
        return max(1, len({p.host for p in self.members.values()}))

    def total_addresses(self) -> int:
        return sum(p.addresses() for p in self.members.values())

    def nat_range(self, block: CarvedBlock) -> tuple[int, int]:
        """(start_ip, count) NAT slice implied by a block's index."""
        if self.nat_total <= 0:
            return (0, 0)
        per = self.nat_total // self.n_blocks
        return (self.nat_base + block.index * per, per)

    def owner_of(self, ip: int) -> str | None:
        for iid, p in self.members.items():
            if p.contains(ip):
                return iid
        return None

    # -- serialization (checkpoint / nexus payload) -----------------------
    def to_dict(self) -> dict:
        return {
            "space_network": self.space_network,
            "space_prefix_len": self.space_prefix_len,
            "block_prefix_len": self.block_prefix_len,
            "nat_base": self.nat_base,
            "nat_total": self.nat_total,
            "epoch": self.epoch,
            "members": {k: v.to_dict()
                        for k, v in sorted(self.members.items())},
            "free": [b.to_dict() for b in self.free],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ClusterPlan":
        return cls(
            space_network=int(d["space_network"]),
            space_prefix_len=int(d["space_prefix_len"]),
            block_prefix_len=int(d["block_prefix_len"]),
            nat_base=int(d.get("nat_base", 0)),
            nat_total=int(d.get("nat_total", 0)),
            epoch=int(d["epoch"]),
            members={k: InstancePlan.from_dict(v)
                     for k, v in d["members"].items()},
            free=[CarvedBlock.from_dict(b) for b in d["free"]],
        )


# ---------------------------------------------------------------------------
# carving
# ---------------------------------------------------------------------------

def _split_blocks(space_network: int, space_prefix_len: int,
                  block_prefix_len: int) -> list[CarvedBlock]:
    n = 1 << (block_prefix_len - space_prefix_len)
    size = 1 << (32 - block_prefix_len)
    return [CarvedBlock(network=space_network + i * size,
                        prefix_len=block_prefix_len, index=i)
            for i in range(n)]


def default_block_prefix(space_prefix_len: int, n_members: int) -> int:
    """Smallest power-of-two block count that covers the membership
    (minimum 4 blocks so a small cluster still has free blocks to grow
    into)."""
    want = max(4, n_members)
    bits = 0
    while (1 << bits) < want:
        bits += 1
    block_prefix = space_prefix_len + bits
    if block_prefix > 30:  # a /31-/32 block cannot hold a usable pool
        raise ValueError(
            f"space /{space_prefix_len} too small for {n_members} members")
    return block_prefix


def _deal_order(ids: list, hosts: dict | None) -> list:
    """Dealing order for round-robin block assignment. Without a host
    map this is plain sorted-id order (the single-host legacy). With
    hosts, consecutive deals alternate across sorted host groups, so an
    N-host cluster spreads each stretch of the space over machines —
    losing one host takes out interleaved blocks, not a contiguous run.
    Deterministic: pure function of (ids, hosts)."""
    if not hosts or not any(hosts.get(i, "") for i in ids):
        return list(ids)
    groups: dict[str, list] = {}
    for i in ids:
        groups.setdefault(hosts.get(i, ""), []).append(i)
    hkeys = sorted(groups)
    order: list = []
    cursors = {h: 0 for h in hkeys}
    while len(order) < len(ids):
        for h in hkeys:
            g = groups[h]
            if cursors[h] < len(g):
                order.append(g[cursors[h]])
                cursors[h] += 1
    return order


def initial_plan(space_network: int, space_prefix_len: int,
                 member_ids: list, *, block_prefix_len: int | None = None,
                 nat_base: int = 0, nat_total: int = 0,
                 hosts: dict | None = None) -> ClusterPlan:
    """Carve the space for the founding membership: blocks dealt
    round-robin in sorted-id order — deterministic, so every elected
    carver computes the identical plan. With a `hosts` map (instance id
    -> host name) the deal interleaves across hosts-of-processes."""
    ids = sorted(member_ids)
    if block_prefix_len is None:
        block_prefix_len = default_block_prefix(space_prefix_len,
                                                max(1, len(ids)))
    blocks = _split_blocks(space_network, space_prefix_len, block_prefix_len)
    hosts = hosts or {}
    plan = ClusterPlan(space_network=space_network,
                       space_prefix_len=space_prefix_len,
                       block_prefix_len=block_prefix_len,
                       nat_base=nat_base, nat_total=nat_total, epoch=1,
                       members={i: InstancePlan(i, host=hosts.get(i, ""))
                                for i in ids},
                       free=[])
    if ids:
        order = _deal_order(ids, hosts)
        for i, b in enumerate(blocks):
            plan.members[order[i % len(order)]].blocks.append(b)
    else:
        plan.free = blocks
    return plan


def replan(plan: ClusterPlan, member_ids: list,
           hosts: dict | None = None) -> ClusterPlan:
    """Re-carve for a new membership. Discipline:

    - a surviving member's blocks NEVER move (never-half-allocate);
    - a departed member's blocks go to the free list — the coordinator
      only calls this after that instance drained, so the transfer is
      whole-block and lease-free;
    - free blocks deal round-robin to members that hold NO blocks yet
      (joiners), interleaved across hosts when a host map is given.
      Members already serving keep exactly their carve — rebalancing an
      occupied block would mean moving live leases, the half-allocate
      this plan exists to forbid. A joiner arriving with nothing free
      stays pending until a leaver returns blocks.

    Returns a NEW plan (epoch+1) when anything changed, else the same
    plan object.
    """
    ids = sorted(member_ids)
    old_ids = plan.member_ids()
    carried = {i: plan.members[i].host for i in ids if i in plan.members}
    hosts = {**carried, **(hosts or {})}

    members = {i: InstancePlan(i, list(plan.members[i].blocks),
                               host=hosts.get(i, ""))
               if i in plan.members else InstancePlan(i,
                                                      host=hosts.get(i, ""))
               for i in ids}
    free = list(plan.free)
    for iid in old_ids:
        if iid not in members:
            free.extend(plan.members[iid].blocks)
    free.sort(key=lambda b: b.index)

    changed = tuple(ids) != old_ids
    changed = changed or any(plan.members[i].host != members[i].host
                             for i in ids if i in plan.members)
    joiners = _deal_order(sorted(i for i in ids if not members[i].blocks),
                          hosts)
    k = 0
    while free and joiners:
        members[joiners[k % len(joiners)]].blocks.append(free.pop(0))
        k += 1
        changed = True

    if not changed:
        return plan
    return ClusterPlan(space_network=plan.space_network,
                       space_prefix_len=plan.space_prefix_len,
                       block_prefix_len=plan.block_prefix_len,
                       nat_base=plan.nat_base, nat_total=plan.nat_total,
                       epoch=plan.epoch + 1, members=members, free=free)


def elect_carver(member_ids) -> str | None:
    """Lowest sorted id carves — the same deterministic election every
    member computes locally from the membership list."""
    ids = sorted(member_ids)
    return ids[0] if ids else None

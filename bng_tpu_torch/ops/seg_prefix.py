"""K2: same-slot inclusive prefix sums and segment totals — CUDA kernel
and plain version.

Replaces the Pallas kernel `bng_tpu/ops/pallas_qos.py:seg_prefix_total`
(`pl.pallas_call` at :127, body `_seg_kernel` :54-93). For each lane i,
over the lanes j with slot_j == slot_i (lane order is arrival order):

    prefix[i] = sum_{j <= i} vec[j]        total[i] = sum_j vec[j]

`vec` holds non-negative integer counts as int32 words (uint32 bits).
Both versions accumulate in integers and write float32, so they equal
the Pallas kernel wherever its f32 matmul is exact (sums < 2^24) and the
JAX sort path (`ops/qos.py:93-142`, exact to 2^32) on every input.
Unique negative slot ids group with nobody. `compute` is "prefix",
"total" or "both"; the output not asked for is zeros.

`seg_prefix_total` is the wrapper: a CUDA tensor launches
`csrc/seg_prefix.cu` (or raises) on its tensors' card and stream, a CPU
tensor takes `seg_prefix_plain`.
The kernel takes one of two routes by B alone: up to `B_ONE` lanes one
CTA settles the lanes alone in their slot and sorts and scans the rest;
above it an equality sweep.
"""

from __future__ import annotations

import torch

from bng_tpu_torch import kernels
from bng_tpu_torch.ops.hashing import u32

COMPUTE = ("prefix", "total", "both")
B_ONE = kernels.DEFINES["seg_prefix"]["BNG_B_ONE"]  # largest B of the one-CTA route


def seg_prefix_plain(slot, vec, compute: str = "both"):
    """Plain PyTorch version: stable sort + segmented int64 cumsum."""
    if compute not in COMPUTE:
        raise ValueError(f"compute must be one of {COMPUTE}, got {compute!r}")
    B = slot.shape[0]
    dev = slot.device
    zeros = torch.zeros((B,), dtype=torch.float32, device=dev)
    if B == 0:
        return zeros, zeros.clone()
    order = torch.sort(slot, stable=True).indices
    s = slot[order]
    v = u32(vec)[order]
    csum = torch.cumsum(v, dim=0)
    pos = torch.arange(B, device=dev)
    change = s[1:] != s[:-1]
    true1 = torch.ones((1,), dtype=torch.bool, device=dev)
    head = torch.cat([true1, change])
    last = torch.cat([change, true1])
    head_at = torch.cummax(torch.where(head, pos, 0), dim=0).values
    base = (csum - v)[head_at]  # exclusive cumsum at the segment head
    tail_at = torch.flip(torch.cummin(torch.flip(torch.where(last, pos, B), [0]),
                                      dim=0).values, [0])
    pref = zeros
    tot = zeros.clone()
    if compute in ("prefix", "both"):
        pref = torch.empty_like(zeros)
        pref[order] = (csum - base).to(torch.float32)
    if compute in ("total", "both"):
        tot[order] = (csum[tail_at] - base).to(torch.float32)
    return pref, tot


def seg_prefix_cuda(slot, vec, compute: str = "both"):
    """Launch K2 on the card. Raises for anything it does not take."""
    if compute not in COMPUTE:
        raise ValueError(f"compute must be one of {COMPUTE}, got {compute!r}")
    dev = slot.device
    if dev.type != "cuda" or vec.device != dev:
        raise ValueError(f"seg_prefix_cuda: slot on {dev}, vec on {vec.device}")
    for t, name in ((slot, "slot"), (vec, "vec")):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"seg_prefix_cuda: {name} must be contiguous 1-d int32")
    B = slot.shape[0]
    if vec.shape[0] != B:
        raise ValueError("seg_prefix_cuda: slot and vec lengths differ")
    pref = torch.empty((B,), dtype=torch.float32, device=dev)
    tot = torch.empty((B,), dtype=torch.float32, device=dev)
    if B == 0:
        return pref, tot
    card = dev.index  # a tensor's CUDA device always names its card
    err = kernels.entry("seg_prefix")(slot.data_ptr(), vec.data_ptr(), B, int(compute != "total"),
             int(compute != "prefix"), pref.data_ptr(), tot.data_ptr(),
             kernels.stream_ptr(dev), card)
    kernels.check(err, "seg_prefix")
    kernels.count("seg_prefix", card)
    return pref, tot


def seg_prefix_total(slot, vec, compute: str = "both"):
    """K2 by tensor device: the CUDA kernel on the card, else the plain version."""
    if slot.device.type == "cuda":
        return seg_prefix_cuda(slot, vec, compute)
    if slot.device.type != "cpu":
        raise ValueError(f"seg_prefix_total: no kernel for device {slot.device}")
    return seg_prefix_plain(slot, vec, compute)

"""K1: the bucketized-cuckoo table probe — CUDA kernel and plain version.

Replaces the Pallas kernel `bng_tpu/ops/pallas_table.py:_probe_jit`
(`pl.pallas_call` at :261) and its plain twin `ops/table.py:xla_lookup`.

For each query row (K key words): b1, b2 = lowbias32(key, SEED1/SEED2)
& (nbuckets-1); candidates in order b1 ways 0-3, b2 ways 0-3, then the
stash; a way matches when its K key words equal the query and its word K
("used") is non-zero; the first match wins. Outputs found [B] bool,
slot [B] int32 (bucket*4+way, or nbuckets*4+stash index; on a miss
b1*4) and vals [B, V] int32 words (zeros on a miss).

`probe` is the wrapper: a CUDA tensor launches `csrc/probe.cu` (or the
launch raises) on the card and stream its tensors live on, a CPU tensor
takes `probe_plain`. There is no fallback from the kernel to the plain
version.
"""

from __future__ import annotations

import torch

from bng_tpu_torch import kernels
from bng_tpu_torch.ops.hashing import SEED1, SEED2, hash_words, u32

WAYS = 4  # slots per bucket


def probe_plain(krows, stash_rows, vals, query, nbuckets: int, stash: int):
    """Plain PyTorch version (the `xla_lookup` translation)."""
    B, K = query.shape
    KW = stash_rows.shape[1]
    dev = query.device
    words = [u32(query[:, k]) for k in range(K)]
    mask = nbuckets - 1
    b1 = hash_words(words, SEED1) & mask
    b2 = hash_words(words, SEED2) & mask

    cand = torch.cat([krows[b1].view(B, WAYS, KW), krows[b2].view(B, WAYS, KW)],
                     dim=1)  # [B, 2W, KW]
    match = (cand[:, :, :K] == query[:, None, :]).all(dim=-1) & (cand[:, :, K] != 0)
    ways = torch.arange(WAYS, device=dev)[None, :]
    slots = torch.cat([b1[:, None] * WAYS + ways, b2[:, None] * WAYS + ways], dim=1)

    if stash > 0:
        sm = ((stash_rows[None, :, :K] == query[:, None, :]).all(dim=-1)
              & (stash_rows[None, :, K] != 0))  # [B, stash]
        s_slots = (nbuckets * WAYS + torch.arange(stash, device=dev))[None, :]
        slots = torch.cat([slots, s_slots.expand(B, stash)], dim=1)
        match = torch.cat([match, sm], dim=1)

    found = match.any(dim=1)
    first = match.to(torch.uint8).argmax(dim=1)  # first True (0 when none)
    slot = slots.gather(1, first[:, None])[:, 0]
    out = torch.where(found[:, None], vals[slot], torch.zeros((), dtype=vals.dtype, device=dev))
    return found, slot.to(torch.int32), out


def _check(t, name, ndim, device):
    if t.device != device:
        raise ValueError(f"probe: {name} on {t.device}, query on {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"probe: {name} must be int32 words, got {t.dtype}")
    if t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"probe: {name} must be a contiguous {ndim}-d tensor")


def probe_cuda(krows, stash_rows, vals, query, nbuckets: int, stash: int):
    """Launch K1 on the card. Raises for anything it does not take."""
    dev = query.device
    if dev.type != "cuda":
        raise ValueError(f"probe_cuda: query is on {dev}, not a CUDA device")
    for t, name, nd in ((krows, "krows", 2), (stash_rows, "stash_rows", 2),
                        (vals, "vals", 2), (query, "query", 2)):
        _check(t, name, nd, dev)
    B, K = query.shape
    KW = stash_rows.shape[1]
    V = vals.shape[1]
    if not 1 <= K < KW or KW not in (8, 16) or K > 8:
        raise ValueError(f"probe_cuda: unsupported key width K={K}, KW={KW}")
    if nbuckets & (nbuckets - 1) or krows.shape != (nbuckets, WAYS * KW):
        raise ValueError(f"probe_cuda: krows {tuple(krows.shape)} != ({nbuckets}, {WAYS * KW})")
    if stash_rows.shape[0] != stash or vals.shape[0] != nbuckets * WAYS + stash:
        raise ValueError("probe_cuda: stash/vals rows do not match the geometry")
    if stash > 256:
        raise ValueError(f"probe_cuda: stash {stash} > 256")
    if V % 4 or krows.data_ptr() % 16 or vals.data_ptr() % 16:
        raise ValueError("probe_cuda: the kernel reads 16-byte vectors: V must be a multiple "
                         "of 4, krows and vals must start on a 16-byte boundary")
    found = torch.empty((B,), dtype=torch.bool, device=dev)
    slot = torch.empty((B,), dtype=torch.int32, device=dev)
    out = torch.empty((B, V), dtype=torch.int32, device=dev)
    if B == 0:
        return found, slot, out
    card = dev.index  # a tensor's CUDA device always names its card
    err = kernels.entry("probe")(krows.data_ptr(), stash_rows.data_ptr(), vals.data_ptr(), query.data_ptr(),
             B, K, KW, V, nbuckets, stash,
             found.data_ptr(), slot.data_ptr(), out.data_ptr(), kernels.stream_ptr(dev), card)
    kernels.check(err, "probe")
    kernels.count("probe", card)
    return found, slot, out


def probe(krows, stash_rows, vals, query, nbuckets: int, stash: int):
    """K1 by tensor device: the CUDA kernel on the card, else the plain version."""
    if query.device.type == "cuda":
        return probe_cuda(krows, stash_rows, vals, query, nbuckets, stash)
    if query.device.type != "cpu":
        raise ValueError(f"probe: no kernel for device {query.device}")
    return probe_plain(krows, stash_rows, vals, query, nbuckets, stash)

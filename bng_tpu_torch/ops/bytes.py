"""Per-lane byte loads and writes over `[B, L]` uint8 packet batches.

Port of `bng_tpu/ops/bytes.py`. Offsets are per-lane int64 tensors; loads
clamp the offset into [0, L-1] before the gather (the clamp is part of
the semantics: an out-of-range read returns the edge byte, as JAX's
`jnp.clip` + `take_along_axis` does). Loaded values come back as int64 in
[0, 2^32). Writes are selects over the row (a byte lands at column
off + k; columns outside [0, L) are simply never matched), so a masked or
out-of-range lane writes nothing.
"""

from __future__ import annotations

import functools

import torch


def u8_at(pkt, offs):
    """One byte per lane at per-lane offsets -> [B] int64."""
    idx = offs.clamp(0, pkt.shape[1] - 1).to(torch.int64)
    return pkt.gather(1, idx[:, None])[:, 0].to(torch.int64)


def be16_at(pkt, offs):
    return (u8_at(pkt, offs) << 8) | u8_at(pkt, offs + 1)


def be32_at(pkt, offs):
    return (be16_at(pkt, offs) << 16) | be16_at(pkt, offs + 2)


def bytes_at(pkt, offs, n: int):
    """n consecutive bytes per lane -> [B, n] uint8."""
    idx = offs.to(torch.int64)[:, None] + torch.arange(n, device=pkt.device)[None, :]
    return pkt.gather(1, idx.clamp(0, pkt.shape[1] - 1))


def _select_write(pkt, offs, val, nbytes: int, mask=None):
    """Write an nbytes big-endian field at per-lane offsets (select form)."""
    col = torch.arange(pkt.shape[1], device=pkt.device)[None, :]
    off = offs.to(torch.int64)
    if mask is not None:
        # a masked-out lane's field starts left of column 0: never matched
        off = torch.where(mask, off, torch.full_like(off, -8))
    off = off[:, None]
    val = val.to(torch.int64)
    out = pkt
    for k in range(nbytes):
        byte = ((val >> (8 * (nbytes - 1 - k))) & 0xFF).to(pkt.dtype)
        out = torch.where(col == off + k, byte[:, None], out)
    return out


def scatter_u8_at(pkt, offs, val):
    return _select_write(pkt, offs, val, 1)


def scatter_be16_at(pkt, offs, val):
    return _select_write(pkt, offs, val, 2)


def scatter_be32_at(pkt, offs, val):
    return _select_write(pkt, offs, val, 4)


def scatter_u8_at_masked(pkt, offs, val, mask):
    return _select_write(pkt, offs, val, 1, mask)


def scatter_be16_at_masked(pkt, offs, val, mask):
    return _select_write(pkt, offs, val, 2, mask)


def scatter_be32_at_masked(pkt, offs, val, mask):
    return _select_write(pkt, offs, val, 4, mask)


# ---- segment builders (reply compose by concatenation) ----


@functools.lru_cache(maxsize=64)
def _const_row(vals: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """One uploaded row per (constants, device): a per-step host-to-device
    copy from pageable memory would stall the host mid-step."""
    return torch.tensor(vals, dtype=torch.uint8, device=device)


def const_seg(Bsz: int, *vals: int, device=None):
    """[B, len(vals)] uint8 segment of per-batch constants."""
    return _const_row(vals, torch.device(device or "cpu"))[None, :].expand(Bsz, len(vals))


def be16_seg(val):
    v = val.to(torch.int64)
    return torch.stack([(v >> 8) & 0xFF, v & 0xFF], dim=1).to(torch.uint8)


def be32_seg(val):
    v = val.to(torch.int64)
    return torch.stack(
        [(v >> 24) & 0xFF, (v >> 16) & 0xFF, (v >> 8) & 0xFF, v & 0xFF], dim=1
    ).to(torch.uint8)


def u8_seg(val):
    return (val.to(torch.int64) & 0xFF).to(torch.uint8)[:, None]

"""The zero-copy ring's movers: a batch's frames between a packet ring's
UMEM and a ring program's [B, L] buffers, by descriptor — CUDA kernels and
plain versions.

Replaces no TPU kernel: the JAX reference moves frames with host copies
(the ring's batch assemble into a staging buffer, the upload, the
download of every output row and the ring's batch complete). Here the
ring's UMEM is registered with the card as pinned host memory mapped into
the card's address space (`register`, from `runtime/ring.NativeRing`), and:

- `gather` fills a program's static inputs from the UMEM: lane i < n of
  `pkt` [B, L] gets min(len_i, L) bytes at addr_i and zeros to L,
  `length` that count and, for the fused step, `fa` the descriptor's
  from-access bit, which are the bytes, lengths and flags the ring's batch
  assemble stages; lanes >= n get length 0, zeros and no flag. It also
  writes the batch's clock into `now_s` / `now_us`;
- `scatter` writes each TX and FWD lane's `out_pkt` row back over its
  frame: min(out_len_i as u32, frame_size - addr_i % frame_size, L)
  bytes, the clamp of the ring's batch complete, which then takes no
  output bytes (`NativeRing.complete(..., out=None, ...)`). PASS and DROP
  lanes are never written.

A batch's descriptors lie in one pinned host buffer of B lanes
(`DescStage`): addrs u64 [B], lens u32 [B], flags u32 [B], back to back
(`DESC_BYTES` a lane). The ring writes them; the gather's entry copies
them into the program's device buffer `desc` (one H2D) and launches the
kernel behind the copy, so a batch's upload is one call; the scatter reads
the addrs from `desc`.

Each wrapper launches `csrc/umem.cu` for tensors on a card (the UMEM at
`Umem.base` there) and takes the plain version for CPU tensors (the UMEM
at `Umem.host`); there is no fallback from the kernel. `LAUNCHES` counts
the kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from bng_tpu_torch import kernels
from bng_tpu_torch.ops.hashing import MASK32
from bng_tpu_torch.ops.pipeline import VERDICT_FWD, VERDICT_TX
from bng_tpu_torch.ops.table import PinnedStage
from bng_tpu_torch.utils.devenv import card_of

DESC_BYTES = 16  # a lane's descriptor: addr u64, len u32, flags u32
DESC_FROM_ACCESS = 0x1  # BNG_DESC_F_FROM_ACCESS (runtime/ring.FLAG_FROM_ACCESS)

LAUNCHES = {"gather": 0, "scatter": 0}


class Umem(NamedTuple):
    """A ring's UMEM as a device reads it: `base` its address on the card
    (0 for the CPU, which reads `host`), `host` the whole UMEM as the host
    sees it, `frame_size` the bytes of each chunk."""

    base: int
    host: np.ndarray
    frame_size: int


class DescStage:
    """One batch's descriptors in a persistent pinned buffer (`PinnedStage`:
    rewritten only once the copy the gather queued from it has run), with
    numpy views of its three fields for the ring to write."""

    def __init__(self, batch: int, device):
        self.batch = batch
        self.stage = PinnedStage((DESC_BYTES * batch,), np.uint8, card_of(device))
        host = self.stage.host
        self.addrs = host[: 8 * batch].view(np.uint64)
        self.lens = host[8 * batch: 12 * batch].view(np.uint32)
        self.flags = host[12 * batch:].view(np.uint32)

    def acquire(self) -> "DescStage":
        self.stage.acquire()
        return self


def desc_addrs(desc: torch.Tensor, batch: int) -> torch.Tensor:
    """The addrs of a descriptor buffer as int64 [batch] (a view)."""
    return desc[: 8 * batch].view(torch.int64)


def desc_fields(desc: torch.Tensor, batch: int):
    """(addrs, lens, flags) of a descriptor buffer, each as int64 [batch]."""
    addrs = desc[: 8 * batch].view(torch.int64)
    lens = desc[8 * batch: 12 * batch].view(torch.int32).to(torch.int64) & MASK32
    flags = desc[12 * batch: 16 * batch].view(torch.int32).to(torch.int64) & MASK32
    return addrs, lens, flags


# ---- plain versions (the UMEM and the descriptors as CPU tensors) -------------

def gather_plain(umem: torch.Tensor, desc_host: torch.Tensor, desc: torch.Tensor, n: int,
                 pkt: torch.Tensor, length: torch.Tensor, fa: torch.Tensor | None,
                 now_s: torch.Tensor, now_s_val: int, now_us: torch.Tensor | None,
                 now_us_val: int) -> None:
    B, L = pkt.shape
    desc.copy_(desc_host)
    addrs, lens, flags = desc_fields(desc, B)
    j = torch.arange(L)
    live = torch.clamp(lens[:n], max=L)
    inside = j[None, :] < live[:, None]
    idx = torch.where(inside, addrs[:n, None] + j[None, :], 0)
    pkt[:n] = torch.where(inside, umem[idx], 0)
    pkt[n:] = 0
    length[:n] = live
    length[n:] = 0
    if fa is not None:
        fa[:n] = (flags[:n] & DESC_FROM_ACCESS) != 0
        fa[n:] = False
    now_s.fill_(now_s_val)
    if now_us is not None:
        now_us.fill_(now_us_val)


def scatter_plain(umem: torch.Tensor, addrs: torch.Tensor, n: int, frame_size: int,
                  verdict: torch.Tensor, out_pkt: torch.Tensor, out_len: torch.Tensor) -> None:
    B, L = out_pkt.shape
    a = addrs[:n]
    v = verdict[:n]
    out = (v == VERDICT_TX) | (v == VERDICT_FWD)
    room = frame_size - a % frame_size
    w = torch.clamp(torch.minimum(out_len[:n].to(torch.int64) & MASK32, room), max=L)
    j = torch.arange(L)
    inside = out[:, None] & (j[None, :] < w[:, None])
    umem[(a[:, None] + j[None, :])[inside]] = out_pkt[:n][inside]


# ---- the kernels ------------------------------------------------------------

def _check(t: torch.Tensor, name: str, dtype, device, shape) -> None:
    if (t.device != device or t.dtype != dtype or not t.is_contiguous()
            or tuple(t.shape) != shape):
        raise ValueError(f"umem: {name} must be a contiguous {dtype} tensor of shape {shape} "
                         f"on {device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def gather_cuda(umem: Umem, stage: DescStage, desc: torch.Tensor, n: int, pkt: torch.Tensor,
                length: torch.Tensor, fa: torch.Tensor | None, now_s: torch.Tensor,
                now_s_val: int, now_us: torch.Tensor | None, now_us_val: int) -> None:
    dev = pkt.device
    B, L = pkt.shape
    for t, name, dtype, shape in ((pkt, "pkt", torch.uint8, (B, L)),
                                  (length, "length", torch.int64, (B,)),
                                  (fa, "fa", torch.bool, (B,)),
                                  (desc, "desc", torch.uint8, (DESC_BYTES * B,)),
                                  (now_s, "now_s", torch.int64, ()),
                                  (now_us, "now_us", torch.int64, ())):
        if t is not None:
            _check(t, name, dtype, dev, shape)
    if stage.batch != B or stage.stage.device != dev or not 0 <= n <= B:
        raise ValueError(f"umem: {n} lanes of {B} from a descriptor buffer of {stage.batch} "
                         f"staged for {stage.stage.device}")
    err = kernels.entry("umem_gather")(
        umem.base, stage.stage.tensor.data_ptr(), desc.data_ptr(), n, B, L, pkt.data_ptr(),
        length.data_ptr(), fa.data_ptr() if fa is not None else None, now_s.data_ptr(),
        now_s_val, now_us.data_ptr() if now_us is not None else None, now_us_val,
        kernels.stream_ptr(dev), dev.index)
    kernels.check(err, "umem_gather")
    LAUNCHES["gather"] += 1


def scatter_cuda(umem: Umem, addrs: torch.Tensor, n: int, verdict: torch.Tensor,
                 out_pkt: torch.Tensor, out_len: torch.Tensor) -> None:
    dev = out_pkt.device
    B, L = out_pkt.shape
    for t, name, dtype, shape in ((out_pkt, "out_pkt", torch.uint8, (B, L)),
                                  (verdict, "verdict", torch.int32, (B,)),
                                  (out_len, "out_len", torch.int64, (B,)),
                                  (addrs, "addrs", torch.int64, (B,))):
        _check(t, name, dtype, dev, shape)
    if not 0 <= n <= B:
        raise ValueError(f"umem: {n} lanes of {B}")
    err = kernels.entry("umem_scatter")(umem.base, addrs.data_ptr(), n, L, umem.frame_size,
                                        verdict.data_ptr(), out_pkt.data_ptr(),
                                        out_len.data_ptr(), kernels.stream_ptr(dev), dev.index)
    kernels.check(err, "umem_scatter")
    LAUNCHES["scatter"] += 1


def gather(umem: Umem, stage: DescStage, desc: torch.Tensor, n: int, pkt: torch.Tensor,
           length: torch.Tensor, fa: torch.Tensor | None, now_s: torch.Tensor, now_s_val: int,
           now_us: torch.Tensor | None = None, now_us_val: int = 0) -> None:
    """The staged descriptors into `desc`, then lanes [0, n) of the
    program's inputs from the UMEM by descriptor, the rest zero, and its
    clock: the copy and the kernel on the card, else the plain version.
    `stage` may be rewritten once the copy has run (`stage.acquire()`)."""
    if pkt.device.type == "cuda":
        gather_cuda(umem, stage, desc, n, pkt, length, fa, now_s, now_s_val, now_us,
                    now_us_val)
    elif pkt.device.type == "cpu":
        gather_plain(torch.from_numpy(umem.host), stage.stage.tensor, desc, n, pkt, length, fa,
                     now_s, now_s_val, now_us, now_us_val)
    else:
        raise ValueError(f"umem: no kernel for device {pkt.device}")
    stage.stage.guard()


def scatter(umem: Umem, addrs: torch.Tensor, n: int, verdict: torch.Tensor,
            out_pkt: torch.Tensor, out_len: torch.Tensor) -> None:
    """Each TX/FWD lane of [0, n) written back over its frame (`addrs`: the
    gather's descriptors, `desc_addrs`): the kernel on the card, else the
    plain version."""
    if out_pkt.device.type == "cuda":
        return scatter_cuda(umem, addrs, n, verdict, out_pkt, out_len)
    if out_pkt.device.type != "cpu":
        raise ValueError(f"umem: no kernel for device {out_pkt.device}")
    return scatter_plain(torch.from_numpy(umem.host), addrs, n, umem.frame_size, verdict,
                         out_pkt, out_len)


# ---- registration -------------------------------------------------------------

def register(host_ptr: int, size: int, card: torch.device) -> int:
    """Pin `size` bytes of host memory at `host_ptr` and map them for every
    card; returns their address on `card`. Raises with the CUDA error if
    the card refuses."""
    dev_ptr = ctypes.c_void_p()
    err = kernels.entry("umem_register")(host_ptr, size, ctypes.byref(dev_ptr), card.index)
    if err != 0:
        raise RuntimeError(f"umem: cudaHostRegister of {size} B at {host_ptr:#x} refused by "
                           f"{card}: CUDA error {err}")
    return dev_ptr.value


def unregister(host_ptr: int) -> None:
    """Undo `register`; raises with the CUDA error if the driver refuses."""
    err = kernels.entry("umem_unregister")(host_ptr)
    if err != 0:
        raise RuntimeError(f"umem: cudaHostUnregister at {host_ptr:#x}: CUDA error {err}")

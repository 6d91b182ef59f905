"""PyTorch/CUDA port of the bng_tpu fused IPoE dataplane.

The port serves the same fused step as `bng_tpu` (parse -> antispoof ->
DHCP responder -> NAT44 -> QoS up/down) through its own `Engine.process`,
with the two device kernels of that step written by hand in CUDA C++ for
Hopper (`csrc/probe.cu`, `csrc/seg_prefix.cu`). It imports nothing of
`bng_tpu` and nothing of JAX: every helper it needs is a copy kept here.

Word convention (fixed for the whole port):

- Device tables, table keys and table values are `torch.int32` tensors
  that hold the uint32 bit pattern of each word. They are byte-identical
  to the JAX package's uint32 arrays, and the CUDA kernels read them as
  `uint32_t*`. Convert with `.view(torch.int32)` / `np.ndarray.view`,
  never with a value cast.
- Per-lane arithmetic (shifts, products, sums, ordered compares) widens
  to `torch.int64` holding values in [0, 2^32) (`ops.hashing.u32`) and
  masks with `& MASK32` wherever uint32 wraps, so every result keeps the
  uint32 bits of the reference. Stats come out as int64 in [0, 2^32).
- Packets are `[B, L]` uint8. QoS tokens are float32 bit patterns inside
  int32 rows (`.view(torch.float32)` / `.view(torch.int32)`).

In place where JAX returns new tables: the JAX step donates its tables
and returns new ones. The port updates the engine's own tensors in place
(applied host updates, NAT session counters, QoS token rows) and returns
the same table objects.

Devices: every entry point takes an explicit `device`. `None` means the
card; with no CUDA device present it raises and names `device="cpu"` as
the way to ask for the CPU. Kernel wrappers launch their CUDA kernel for
a CUDA tensor and take their plain PyTorch version only for a CPU tensor.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` -> the CUDA card; raises when none is present."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)

"""The devloop: k express batches per device dispatch (port of
`bng_tpu/devloop/`).

- `ring`   - the descriptor ring: [k, B, XD_WORDS] express rows staged on
  the host in cycling pinned buffers, and the cursor words.
- `kernel` - the ring program: the express probe cascade over each of the
  k slots, on the card one CUDA graph (3k K1 launches) per geometry.
- `host`   - the pump: fills slots from closed express batches, dispatches
  once per k batches (or on the ring deadline, or at flush), retires each
  slot through the scheduler's express retire, and falls back loudly to
  the per-batch lane on a geometry miss or an injected fault.

Selected per scheduler by `express_loop` / `BNG_EXPRESS_LOOP`
(`aot|devloop|auto`); the default stays `aot`.
"""

from bng_tpu_torch.devloop.ring import CUR_EPOCH, CUR_SEQ, CUR_TAIL, CUR_WORDS, DescriptorRing

__all__ = ["CUR_EPOCH", "CUR_SEQ", "CUR_TAIL", "CUR_WORDS", "DescriptorRing"]

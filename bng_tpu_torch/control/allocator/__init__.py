"""The port's copy of `bng_tpu/control/allocator/__init__.py` (jax-free)."""
from bng_tpu_torch.control.allocator.bitmap import IPAllocator  # noqa: F401
from bng_tpu_torch.control.allocator.epoch_bitmap import EpochBitmapAllocator  # noqa: F401
from bng_tpu_torch.control.allocator.store import (  # noqa: F401
    AllocationRecord,
    AllocationStore,
    MemoryAllocationStore,
)
from bng_tpu_torch.control.allocator.distributed import DistributedAllocator  # noqa: F401
from bng_tpu_torch.control.allocator.modes import (  # noqa: F401
    Allocator,
    HybridAllocator,
    LocalAllocator,
)

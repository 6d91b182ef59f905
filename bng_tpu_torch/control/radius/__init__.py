"""RADIUS: the packet codec, the client, policies, accounting and CoA (the
port's copy of `bng_tpu/control/radius/`, jax-free)."""

from bng_tpu_torch.control.radius.packet import RadiusPacket  # noqa: F401
from bng_tpu_torch.control.radius.client import RadiusClient, RadiusServerConfig  # noqa: F401
from bng_tpu_torch.control.radius.policy import PolicyManager, QoSPolicy, DEFAULT_POLICIES  # noqa: F401
from bng_tpu_torch.control.radius.accounting import AccountingManager  # noqa: F401
from bng_tpu_torch.control.radius.coa import CoAProcessor, CoAServer  # noqa: F401

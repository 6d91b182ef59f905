"""The device guard: where an entry point of the port runs, decided once.

The port's counterpart of `bng_tpu/utils/jaxenv.py`. The reference probes
its accelerator in a subprocess because an in-process backend init can
hang; it then falls back to the CPU so a run always prints a line. The
port keeps the subprocess probe (`probe_cuda`), but never falls back:
an entry point (`BNGApp`, `cli.main`, a `DHCPBenchmark` over an engine
built without a device) runs on the card unless its caller asks for the
CPU, and with no card and no such request it raises (`resolve_device`).

`force_cpu` and `enable_compilation_cache` have no counterpart. The
first pins JAX to a virtual CPU mesh; the port's entry points take
`device="cpu"` instead. The second is JAX's persistent compilation
cache; the port's kernels are built once into `bng_tpu_torch/_build/`,
which plays that role.
"""

from __future__ import annotations

import subprocess
import sys

_PROBE_SRC = (
    "import torch; assert torch.cuda.is_available(), 'torch.cuda.is_available() is false'; "
    "torch.zeros(8, device='cuda').sum().item(); "
    "print(torch.cuda.device_count()); print(torch.cuda.get_device_name(0))"
)


class NoCardError(RuntimeError):
    """An entry point was asked to run on the card and there is none."""


def power_limit(timeout_s: float = 30.0) -> str:
    """The first card's power limit as `nvidia-smi` reports it, or "" when
    it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=timeout_s)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else ""


def probe_cuda(timeout_s: float = 120.0) -> dict:
    """Probe the card in a subprocess with a hard timeout (the counterpart
    of `probe_accelerator`). Returns {"name", "power_limit", "count"} when
    a CUDA card answered, or {"error": reason}."""
    try:
        res = subprocess.run([sys.executable, "-c", _PROBE_SRC], capture_output=True,
                             text=True, timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return {"error": f"probe timed out after {timeout_s:.0f}s"}
    except OSError as e:
        return {"error": f"probe spawn failed: {e!r}"}
    if res.returncode != 0:
        tail = (res.stderr or res.stdout or "").strip().splitlines()[-3:]
        return {"error": f"probe rc={res.returncode}: " + " | ".join(tail)}
    count, name = (res.stdout.strip().splitlines() + ["", ""])[:2]
    return {"name": name, "power_limit": power_limit(), "count": int(count)}


def resolve_device(device=None):
    """The one place where an entry point picks its device: the card
    (`None` -> `torch.device("cuda")`) unless the caller passes "cpu".
    Raises NoCardError, naming device='cpu', when the card is wanted and
    absent."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise NoCardError(
                "no CUDA device is available; pass device='cpu' (--device cpu on "
                "the command line) to run the plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def card_of(device):
    """The memory `device` names, as a `torch.device` that compares equal
    for two spellings of it: a bare "cuda" is the current card (its index
    spelled out), and every "cpu:i" is the one host memory, "cpu"."""
    import torch

    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    if device.type == "cpu":
        return torch.device("cpu")
    return device

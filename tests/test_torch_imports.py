"""The port's boundary: it imports neither JAX nor the JAX package, its
entry points run on the card unless the CPU is asked for, and a kernel
wrapper given a CUDA-only call never falls back to its plain version."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bng_tpu_torch.ops import probe as probe_mod
from bng_tpu_torch.ops import seg_prefix as seg_mod

pytestmark = pytest.mark.torch_port

REPO = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, pkgutil, sys
import bng_tpu_torch
mods = ["bng_tpu_torch"] + [m.name for m in pkgutil.walk_packages(
    bng_tpu_torch.__path__, "bng_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "bng_tpu."))
             or m == "bng_tpu")
print(sorted(mods))
print(len(mods), bad)
"""

# the modules each slice added; the subprocess probe must import every one
SLICE_MODULES = (
    "bng_tpu_torch.entry", "bng_tpu_torch.ops.pppoe", "bng_tpu_torch.ops.garden",
    "bng_tpu_torch.edge.ops", "bng_tpu_torch.edge.tables", "bng_tpu_torch.runtime.ring",
    "bng_tpu_torch.runtime.tables", "bng_tpu_torch.runtime.engine", "bng_tpu_torch.ops.pipeline",
    "bng_tpu_torch.control.dhcp_codec", "bng_tpu_torch.control.pool",
    "bng_tpu_torch.control.dhcp_server", "bng_tpu_torch.ops.express", "bng_tpu_torch.runtime.lanes",
    "bng_tpu_torch.runtime.scheduler", "bng_tpu_torch.utils.structlog",
    "bng_tpu_torch.chaos", "bng_tpu_torch.chaos.faults", "bng_tpu_torch.runtime.hostpath",
    "bng_tpu_torch.runtime.nativelib", "bng_tpu_torch.devloop", "bng_tpu_torch.devloop.ring",
    "bng_tpu_torch.devloop.kernel", "bng_tpu_torch.devloop.host",
    "bng_tpu_torch.parallel", "bng_tpu_torch.parallel.sharded", "bng_tpu_torch.parallel.exchange",
    "bng_tpu_torch.control.nat_logging", "bng_tpu_torch.telemetry", "bng_tpu_torch.telemetry.hist",
    "bng_tpu_torch.runtime.checkpoint", "bng_tpu_torch.runtime.ops",
    "bng_tpu_torch.control.statestore", "bng_tpu_torch.chaos.invariants",
    "bng_tpu_torch.telemetry.spans", "bng_tpu_torch.edge.compile",
    "bng_tpu_torch.cli", "bng_tpu_torch.__main__", "bng_tpu_torch.loadtest",
    "bng_tpu_torch.loadtest.harness", "bng_tpu_torch.runtime.verify",
    "bng_tpu_torch.utils.devenv", "bng_tpu_torch.utils.profiling", "bng_tpu_torch.analysis",
    "bng_tpu_torch.analysis.sanitize", "bng_tpu_torch.telemetry.ledger",
    "bng_tpu_torch.control.intercept", "bng_tpu_torch.control.routing",
    "bng_tpu_torch.control.walledgarden", "bng_tpu_torch.control.subscriber",
    "bng_tpu_torch.control.radius", "bng_tpu_torch.control.radius.policy",
    "bng_tpu_torch.control.nexus", "bng_tpu_torch.parallel.hashring",
    "bng_tpu_torch.control.opsctl",
    "bng_tpu_torch.control.dhcpv6", "bng_tpu_torch.control.dhcpv6.protocol",
    "bng_tpu_torch.control.dhcpv6.server", "bng_tpu_torch.control.slaac",
    "bng_tpu_torch.control.slowpath", "bng_tpu_torch.control.radius.packet",
    "bng_tpu_torch.control.radius.client", "bng_tpu_torch.control.radius.accounting",
    "bng_tpu_torch.control.radius.coa", "bng_tpu_torch.control.pppoe",
    "bng_tpu_torch.control.pppoe.auth", "bng_tpu_torch.control.pppoe.codec",
    "bng_tpu_torch.control.pppoe.fsm", "bng_tpu_torch.control.pppoe.ipcp",
    "bng_tpu_torch.control.pppoe.ipv6cp", "bng_tpu_torch.control.pppoe.lcp",
    "bng_tpu_torch.control.pppoe.server", "bng_tpu_torch.control.pppoe.session",
)


def test_port_and_chip_smoke_import_no_jax():
    """In a fresh interpreter (this process has JAX loaded by conftest)."""
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA", "PYTHON"))}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    n, bad = lines[-1].split(" ", 1)
    assert int(n) >= 71  # every module of the package was imported
    assert bad == "[]", bad
    assert set(SLICE_MODULES) <= set(eval(lines[-2]))  # noqa: S307 — our own repr


def test_engine_without_device_needs_cuda(monkeypatch):
    from bng_tpu_torch import resolve_device
    from bng_tpu_torch.control.nat import NATManager
    from bng_tpu_torch.runtime.engine import Engine
    from bng_tpu_torch.runtime.tables import FastPathTables

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    fp = FastPathTables(sub_nbuckets=64, vlan_nbuckets=16, cid_nbuckets=16, max_pools=4)
    nat = NATManager(public_ips=[1], sessions_nbuckets=64, sub_nat_nbuckets=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(fp, nat)
    assert Engine(fp, nat, device="cpu").device == torch.device("cpu")


def test_entry_and_full_stack_engine_need_cuda_unless_cpu(monkeypatch):
    from bng_tpu_torch.edge.tables import EdgeTables
    from bng_tpu_torch.entry import entry
    from bng_tpu_torch.control.nat import NATManager
    from bng_tpu_torch.runtime.engine import Engine, GardenTables
    from bng_tpu_torch.runtime.tables import FastPathTables, PPPoEFastPathTables

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()
    fn, args = entry(device="cpu")
    assert all(t.device.type == "cpu" for t in args[1:])
    fp = FastPathTables(sub_nbuckets=64, vlan_nbuckets=16, cid_nbuckets=16, max_pools=4)
    nat = NATManager(public_ips=[1], sessions_nbuckets=64, sub_nat_nbuckets=16)
    stages = dict(garden=GardenTables(nbuckets=16), pppoe=PPPoEFastPathTables(nbuckets=16),
                  edge=EdgeTables(nbuckets=16))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(fp, nat, **stages)
    eng = Engine(fp, nat, **stages, device="cpu")
    assert eng.tables.route.vals.device.type == "cpu"
    assert eng.tables.pppoe_server_mac.device.type == "cpu"


def test_sharded_cluster_and_dryrun_need_cuda_unless_cpu(monkeypatch):
    from bng_tpu_torch.entry import dryrun_multichip
    from bng_tpu_torch.parallel.exchange import DeviceLocalExchange
    from bng_tpu_torch.parallel.sharded import ShardedCluster

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ShardedCluster(2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun_multichip(2)
    cl = ShardedCluster(2, device="cpu")
    assert cl.shard_devices == [torch.device("cpu")] * 2
    # the exchange keeps every shard on one device
    with pytest.raises(NotImplementedError, match="several devices"):
        DeviceLocalExchange(["cpu", "meta"])


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel entry points have no CPU fallback: a CPU tensor raises
    instead of silently taking the plain version."""
    z = torch.zeros((4, 32), dtype=torch.int32)
    q = torch.zeros((8, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="not a CUDA device"):
        probe_mod.probe_cuda(z, torch.zeros((0, 8), dtype=torch.int32),
                             torch.zeros((16, 8), dtype=torch.int32), q, 4, 0)
    s = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="slot on cpu"):
        seg_mod.seg_prefix_cuda(s, s, "both")
    with pytest.raises(ValueError, match="compute"):
        seg_mod.seg_prefix_cuda(s, s, "sum")


def test_wrappers_refuse_unknown_devices():
    meta = torch.empty((8, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        probe_mod.probe(meta, meta, meta, meta, 4, 0)
    with pytest.raises(ValueError, match="no kernel"):
        seg_mod.seg_prefix_total(meta[:, 0], meta[:, 0])


def test_cpu_dispatch_takes_plain_versions_and_counts_no_launch():
    from bng_tpu_torch import kernels

    before = dict(kernels.LAUNCHES)
    rng = np.random.default_rng(0)
    slot = torch.from_numpy(rng.integers(0, 3, size=16).astype(np.int32))
    vec = torch.from_numpy(rng.integers(0, 100, size=16).astype(np.int32))
    got = seg_mod.seg_prefix_total(slot, vec, "both")
    ref = seg_mod.seg_prefix_plain(slot, vec, "both")
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert kernels.LAUNCHES == before

"""The port's device authentication, zero-touch provisioning and on-OLT
agent (`bng_tpu_torch/control/{deviceauth,ztp,agent}.py`) against the JAX
package's.

- The reference's own cases run on the port: every test of
  `tests/test_deviceauth.py`, the device-auth, mTLS, ZTP and agent cases of
  `tests/test_provisioning.py` (the device-auth ones repeat
  `test_deviceauth.py`'s, so all are one parametrised test) and
  `tests/test_qinq_ztp.py::TestZTP*`. Each case's code is rebound so that
  every name and import of the JAX package resolves to the port's module
  of the same path (`port_twin`); its assertions, which pin exact values,
  then hold on the port.
- Across packages, from the same inputs: PSK headers and signatures
  byte-equal, each package verifying the other's; certificate
  fingerprints and expiry; Option 43 encodes byte-equal and the parse of
  seeded random option blobs equal; the bootstrap client's sleeps,
  attempts and configuration under the same scripted transport; the
  agent's state sequence, caches and health over the same Nexus store.
- `run --device-auth-method psk|mtls` builds in both packages' apps (the
  port's on the CPU) with the same authenticator.

Tolerance: exact.
"""

import builtins
import dataclasses
import importlib
import inspect
import types

import numpy as np
import pytest

import test_deviceauth as ref_da
import test_provisioning as ref_prov
import test_qinq_ztp as ref_qz
from test_provisioning import cert_pair  # noqa: F401 — the mTLS cases' fixture

from bng_tpu.control import agent as j_agent
from bng_tpu.control import deviceauth as j_da
from bng_tpu.control import nexus as j_nexus
from bng_tpu.control import ztp as j_ztp
from bng_tpu_torch.control import agent as t_agent
from bng_tpu_torch.control import deviceauth as t_da
from bng_tpu_torch.control import nexus as t_nexus
from bng_tpu_torch.control import ztp as t_ztp

pytestmark = pytest.mark.torch_port


# ---- rebinding a reference test onto the port ----------------------------

def _is_ref(name: str) -> bool:
    return name == "bng_tpu" or name.startswith("bng_tpu.")


def _port_name(name: str) -> str:
    return "bng_tpu_torch" + name[len("bng_tpu"):]


def _port_import(name, globals=None, locals=None, fromlist=(), level=0):
    if level == 0 and _is_ref(name):
        name = _port_name(name)
    return builtins.__import__(name, globals, locals, fromlist, level)


class _Unported:
    """Stands for a JAX-package name whose module the port does not have:
    a case that touches it fails loudly instead of running the reference."""

    def __init__(self, what):
        self._what = what

    def __getattr__(self, name):
        raise AssertionError(f"{self._what} is not in the port")

    def __call__(self, *a, **kw):
        raise AssertionError(f"{self._what} is not in the port")


def _port_value(v):
    """A module, class or function of the JAX package -> the port's object
    at the same path; anything else unchanged."""
    if isinstance(v, types.ModuleType):
        name = v.__name__
    else:
        mod = getattr(v, "__module__", None)
        if not (isinstance(mod, str) and (inspect.isclass(v) or inspect.isfunction(v))):
            return v
        name = mod
    if not _is_ref(name):
        return v
    try:
        obj = importlib.import_module(_port_name(name))
    except ModuleNotFoundError:
        return _Unported(_port_name(name))
    if not isinstance(v, types.ModuleType):
        for part in v.__qualname__.split("."):
            obj = getattr(obj, part)
    return obj


def port_twin(module, name: str):
    """The test module's class or function `name` with its code rebound to
    globals where every JAX-package name is the port's, and `import
    bng_tpu...` inside a body imports the port. The module's own helper
    functions and classes (fakes, test doubles) are rebound the same way."""
    src = vars(module)
    g = {k: _port_value(v) for k, v in src.items()}
    g["__builtins__"] = {**vars(builtins), "__import__": _port_import}

    def rebind(f):
        nf = types.FunctionType(f.__code__, g, f.__name__, f.__defaults__, f.__closure__)
        nf.__kwdefaults__ = f.__kwdefaults__
        return nf

    def rebind_class(c):
        body = {k: rebind(v) if isinstance(v, types.FunctionType) else v
                for k, v in vars(c).items() if k not in ("__dict__", "__weakref__")}
        return type(c.__name__, c.__bases__, body)

    for k, v in src.items():
        if isinstance(v, types.FunctionType) and v.__globals__ is src:
            g[k] = rebind(v)
        elif inspect.isclass(v) and v.__module__ == module.__name__:
            g[k] = rebind_class(v)
    return g[name]


def run_on_port(module, case: str, request):
    """Run `Class::method` (or a module-level test) of a reference test
    module on the port, its fixtures from this module's scope."""
    if "::" in case:
        cls_name, meth = case.split("::")
        fn = getattr(port_twin(module, cls_name)(), meth)
    else:
        fn = port_twin(module, case)
    kw = {p: request.getfixturevalue(p) for p in inspect.signature(fn).parameters}
    fn(**kw)


def reference_cases(module, classes):
    return [f"{c}::{m}" for c in classes for m in vars(getattr(module, c))
            if m.startswith("test_")]


# ---- the reference's cases on the port ------------------------------------

DA_CASES = reference_cases(ref_da, ("TestIdentity", "TestNoneAuth", "TestPSK",
                                     "TestCertHelpers", "TestMTLS", "TestWiring"))
PROV_CASES = reference_cases(ref_prov, ("TestDeviceAuth", "TestMTLS", "TestZTP", "TestAgent"))
QZ_CASES = reference_cases(ref_qz, ("TestZTPDiscovery", "TestZTPBootstrap"))
CASES = ([(ref_da, c) for c in DA_CASES] + [(ref_prov, c) for c in PROV_CASES]
         + [(ref_qz, c) for c in QZ_CASES])


@pytest.mark.parametrize("module,case", CASES,
                         ids=[f"{m.__name__}::{c}" for m, c in CASES])
def test_reference_case_holds_on_the_port(module, case, request):
    run_on_port(module, case, request)


def test_rebinding_reaches_the_port():
    """The harness itself: a rebound case sees the port's classes, and an
    import inside its body imports the port."""
    twin = port_twin(ref_prov, "TestAgent")
    assert twin._nexus.__globals__["NexusClient"] is t_nexus.NexusClient
    assert twin._nexus.__globals__["Agent"] is t_agent.Agent
    g = port_twin(ref_da, "fake_cert_pem").__globals__
    assert g["cert_not_after"] is t_da.cert_not_after
    assert g["FakeClock"] is not ref_da.FakeClock  # the module's classes rebound too
    assert g["__builtins__"]["__import__"]("bng_tpu.control.nexus", fromlist=["x"]) is t_nexus
    assert len(DA_CASES) >= 20 and len(PROV_CASES) >= 17 and len(QZ_CASES) == 10


# ---- across packages, from the same inputs --------------------------------

PKGS = [(j_da, j_ztp, j_agent, j_nexus), (t_da, t_ztp, t_agent, t_nexus)]
NOW = 1_700_000_000.0


def test_psk_headers_equal_and_cross_verify():
    out = []
    for da, *_ in PKGS:
        a = da.PSKAuthenticator(psk="correct-horse-battery-staple", clock=lambda: NOW,
                                identity=da.DeviceIdentity(device_id="dev-p", serial="S1",
                                                           mac="02:00:00:00:00:01"))
        out.append((a, a.http_headers(), a.sign_message("dev-p:2023-11-14T22:13:20Z")))
    (ja, jh, js), (ta, th, ts) = out
    assert th == jh and ts == js
    ts_hdr = jh[j_da.PSK_TIMESTAMP_HEADER]
    ta.verify_signature("dev-p", ts_hdr, jh[j_da.PSK_SIGNATURE_HEADER])
    ja.verify_signature("dev-p", ts_hdr, th[t_da.PSK_SIGNATURE_HEADER])
    with pytest.raises(ValueError, match="signature mismatch"):
        ta.verify_signature("dev-q", ts_hdr, jh[j_da.PSK_SIGNATURE_HEADER])


def test_certificate_helpers_equal(tmp_path):
    rng = np.random.default_rng(7)
    got = []
    for da, *_ in PKGS:
        rows = []
        for yy, mm in zip(rng.integers(0, 99, 8), rng.integers(1, 13, 8)):
            pem = ref_da.fake_cert_pem(f"{int(yy):02d}{int(mm):02d}01000000Z")
            rows.append((da.cert_fingerprint(pem), da.cert_not_after(pem)))
        cert = tmp_path / f"{da.__name__}.crt"
        cert.write_text(ref_da.fake_cert_pem("270101000000Z"))
        m = da.MTLSAuthenticator(str(cert), "", clock=lambda: NOW,
                                 identity=da.DeviceIdentity(device_id="dev-m"))
        got.append((rows, m.http_headers(), m.authenticate().success,
                    m.expires_within(86400.0 * 365 * 4)))
        rng = np.random.default_rng(7)
    assert got[1] == got[0]


def test_option_43_encode_and_parse_equal():
    rng = np.random.default_rng(11)
    blobs = [bytes(rng.integers(0, 256, int(n), dtype=np.uint8))
             for n in rng.integers(0, 40, 64)]
    urls = [f"https://nexus-{i}.isp.example:{8000 + i}/v1" for i in range(8)]
    got = []
    for _da, ztp, *_ in PKGS:
        enc = [ztp.build_vendor_option(u) for u in urls]
        parsed = [ztp.parse_vendor_options(b) for b in blobs + [bytes([9, 2, 0, 0]) + e
                                                              for e in enc]]
        picks = [ztp.extract_nexus_url({224: u.encode(), 43: e}) for u, e in zip(urls, enc)]
        picks += [ztp.extract_nexus_url({43: e}) for e in enc]
        leases = [dataclasses.asdict(ztp.discover_from_lease(
            ip=f"10.0.0.{i}", gateway="10.0.0.1", options={43: e})) for i, e in enumerate(enc)]
        got.append((enc, parsed, picks, leases))
    assert got[1] == got[0]
    assert got[0][1][-8:] == urls


def _script():
    """A scripted transport: errors, pending with and without a hint, then
    configured."""
    return [ConnectionError("down"), ConnectionError("down"),
            {"status": "pending", "retry_after": 7}, ConnectionError("down"),
            {"status": "pending"},
            {"status": "configured", "node_id": "bng-7", "site_id": "s1", "role": "edge",
             "pools": [{"id": 1}]}]


@pytest.mark.parametrize("max_retries", [0, 3], ids=["configured", "max_retries"])
def test_bootstrap_sleeps_and_config_equal(max_retries):
    got = []
    for da, ztp, *_ in PKGS:
        script, sleeps, seen, clk = _script(), [], [], [100.0]

        def transport(req, script=script, seen=seen):
            seen.append(dataclasses.asdict(req))
            r = script.pop(0)
            if isinstance(r, Exception):
                raise r
            return r

        def sleep(dt, sleeps=sleeps, clk=clk):
            sleeps.append(dt)
            clk[0] += dt

        c = ztp.BootstrapClient(
            ztp.BootstrapConfig(nexus_url="https://n", initial_backoff=2.0, max_backoff=5.0,
                                max_retries=max_retries),
            transport, identity=da.DeviceIdentity(device_id="d", serial="SER-1",
                                                  mac="02:00:00:00:00:01", model="m"),
            clock=lambda clk=clk: clk[0], sleep=sleep)
        try:
            res = ("ok", dataclasses.asdict(c.bootstrap()))
        except TimeoutError as e:
            res = ("timeout", str(e))
        got.append((res, sleeps, seen, c.attempts))
    assert got[1] == got[0]


def test_agent_states_caches_and_health_equal():
    got = []
    for _da, _ztp, agent, nexus in PKGS:
        clk = [1000.0]
        n = nexus.NexusClient(clock=lambda: clk[0])
        n.devices.put("dev-1", nexus.DeviceEntity(id="dev-1", state="approved"))
        rng = np.random.default_rng(5)
        for i in range(24):
            n.subscribers.put(f"s{i}", nexus.SubscriberEntity(
                id=f"s{i}", mac=f"02:aa:00:00:00:{i:02x}", isp_id=f"isp-{int(rng.integers(3))}",
                nte_id=f"ONT{i % 5}"))
        for i in range(5):
            n.ntes.put(f"ONT{i}", nexus.NTEEntity(id=f"ONT{i}", serial=f"ONT{i}"))
        a = agent.Agent(agent.AgentConfig(device_id="dev-1", degraded_after=60), n,
                        clock=lambda: clk[0])
        states, churns = [], []
        a.on_state_change = lambda old, new: states.append((old.value, new.value))
        a.on_isp_churn = lambda sid, old, new: churns.append((sid, old, new))
        a.start()
        n.subscribers.put("s3", nexus.SubscriberEntity(id="s3", mac="02:aa:00:00:00:03",
                                                        isp_id="isp-z", nte_id="ONT3"))
        n.subscribers.delete("s4")
        hb = [a.heartbeat()]
        clk[0] += 120
        a.tick()
        hb.append(a.heartbeat())
        h = a.health()
        got.append((states, churns, hb, h, a.subscriber_count(), a.nte_count(),
                    a.subscriber_count_by_isp(),
                    [getattr(a.get_subscriber_by_mac(f"02:AA:00:00:00:{i:02X}"), "id", None)
                     for i in range(24)],
                    [getattr(a.get_subscriber_by_nte(f"ONT{i}"), "id", None) for i in range(5)]))
    assert got[1] == got[0]


@pytest.mark.parametrize("method", ["psk", "mtls"])
def test_run_builds_device_auth_like_the_reference(method, tmp_path):
    """`run --device-auth-method psk|mtls` builds in both packages (the
    port on the CPU) and keeps the same authenticator: the mode, the
    header names and, for mTLS, the certificate's fingerprint and expiry."""
    from bng_tpu import cli as j_cli
    from bng_tpu_torch import cli as t_cli

    (tmp_path / "psk").write_text("0123456789abcdef-psk\n")
    (tmp_path / "dev.crt").write_text(ref_da.fake_cert_pem("270101000000Z"))
    (tmp_path / "dev.key").write_text("not-a-real-key")
    got = []
    for cli, kw in ((j_cli, {}), (t_cli, {"device": "cpu"})):
        app = cli.BNGApp(cli.BNGConfig(
            device_auth_method=method, device_auth_psk_file=str(tmp_path / "psk"),
            device_auth_cert=str(tmp_path / "dev.crt"), device_auth_key=str(tmp_path / "dev.key"),
            metrics_enabled=False, dhcpv6_enabled=False, slaac_enabled=False), **kw)
        try:
            da = app.components["deviceauth"]
            h = da.http_headers()
            got.append((type(da).__name__, da.mode.value, sorted(h),
                        h.get("X-Device-Cert-Fingerprint"), getattr(da, "_not_after", None)))
        finally:
            app.close()
    assert got[1] == got[0]
    assert got[0][1] == method

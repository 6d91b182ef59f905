"""The port's kernel gate against the reference's lowering gate.

- `verify_cuda_kernels(cuda=False)` runs every check that is not CUDA-only
  on the CPU and reports no error: the gate's own harness (engine and
  table builders, the express and ring programs, the fused and sharded
  steps, the kernel cases) works.
- Its check names map one-to-one onto the reference's `CHECKS`, and a
  check is CUDA-only exactly where the reference's is TPU-only.
- A check that fails is reported with its traceback and the gate goes on
  to the next, as the reference's does.

Tolerance: exact (the checks compare bit for bit where they compare).
"""

import pytest

from bng_tpu.runtime import verify as j_verify
from bng_tpu_torch.runtime import verify as t_verify

pytestmark = pytest.mark.torch_port


def test_cpu_gate_runs_clean():
    got = t_verify.verify_cuda_kernels(verbose=False, cuda=False)
    assert [n for n, err in got if err] == []
    assert [n for n, _ in got] == [n for n, _, cuda_only in t_verify.CHECKS if not cuda_only]


def test_checks_map_one_to_one_onto_the_reference():
    port = {n: cuda_only for n, _, cuda_only in t_verify.CHECKS}
    ref = {n: tpu_only for n, _, tpu_only in j_verify.CHECKS}
    assert set(t_verify.REFERENCE_NAMES) == set(port)
    assert sorted(t_verify.REFERENCE_NAMES.values()) == sorted(ref)
    for name, ref_name in t_verify.REFERENCE_NAMES.items():
        assert port[name] == ref[ref_name], name


def test_a_failing_check_is_reported_and_the_gate_goes_on(monkeypatch):
    def broken(device):
        raise ValueError("planted drift")

    monkeypatch.setattr(t_verify, "_check_table", broken)
    got = dict(t_verify.verify_cuda_kernels(verbose=False, cuda=False))
    assert "planted drift" in got["table_lookup[plain]"]
    assert got["sharded_step"] is None and len(got) == 7

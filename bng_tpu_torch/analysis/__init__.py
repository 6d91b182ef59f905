"""bngcheck over the port: dataplane-invariant static analysis + runtime
sanitizers (the port's copy of `bng_tpu/analysis/`).

Static half (stdlib `ast`, no torch or jax import):
`python -m bng_tpu_torch check` / `python -m bng_tpu_torch.analysis` runs
eight passes over `bng_tpu_torch/**/*.py` and compares findings against
the port's own baseline (`analysis/baseline.json`) —

    hotpath         BNG001-004  dispatch scope never forces the card
                                (`.item()`, `.cpu()`, `.tolist()`,
                                `.numpy()`, a synchronize, `np.asarray`
                                of a step result); disarmed hooks
                                guard-first, allocation-free; the
                                batch-native serving path loop-free
    jit-discipline  BNG010      CUDA graphs captured and kernels loaded
                                only in cached builders (BNG011/012 are
                                listed and do not apply to the port:
                                `--codes` says why)
    handler-audit   BNG020-021  no swallowed broad excepts (Yuan '14)
    registry        BNG030-035  span/fault/metric/checkpoint/trigger
                                vocabularies consistent
    single-writer   BNG040-041  table mutators only from allowlisted
                                writer modules
    fencing         BNG050      no wall-clock over an asynchronous
                                launch without a synchronize or force
    concurrency     BNG060-064  the `_ctl` thread-ownership discipline
    gather          BNG014      table value rows and torch-built arrays
                                gathered in ops/ are >= 8 words wide

Runtime half (`BNG_SANITIZE=1`, `analysis/sanitize.py`): the CUDA sync
debug mode as the device-to-host guard, the QoS NaN check and the
`@owned_by` ownership assertions.
"""

from bng_tpu_torch.analysis.core import (Finding, Project, Report,  # noqa: F401
                                         run_passes)
from bng_tpu_torch.analysis.passes import ALL_PASSES, all_codes, build  # noqa: F401


def run_analysis(root, paths=None, select=None) -> "Report":
    """Programmatic entry: scan `root` and return the Report (no
    baseline applied — callers split against a baseline themselves)."""
    project = Project.load(root, paths)
    return run_passes(project, build(set(select) if select else None))

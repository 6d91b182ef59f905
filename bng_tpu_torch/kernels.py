"""Build, load and count the port's hand-written CUDA kernels.

Each `csrc/*.cu` source is compiled by `nvcc` for `sm_90a` into a shared
library with a plain C interface and loaded with `ctypes` (no PyTorch
headers: a build takes seconds). Builds happen at first use, never at
import, into `bng_tpu_torch/_build/`, keyed by a hash of the source, the
shared headers (`csrc/*.cuh`) and the flags, so a fresh checkout builds
everything it needs by itself. The missing sources build together, one
`nvcc` each, started at once.

`LAUNCHES` counts kernel launches per kernel name, and `LAUNCHES_ON` the
same launches per card: each wrapper adds one (`count`) where it
launches, and a captured CUDA graph (`runtime/engine.py`'s
`ExpressProgram`, the devloop's ring program, both captured by
`capture_graph`) adds the launches it recorded each time it replays (the
capture itself counts none). A ring program (`runtime/ringprog.py`)
launches its kernels eagerly at each replay, where the wrappers count
them; the runs that build it count none (`recording`).

Every C entry takes the index of the card its inputs live on and makes
that card current for the launch, restoring the caller's after
(`csrc/device_scope.cuh`), so a kernel runs on its inputs' card and
stream whichever card the calling thread has current.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# source name -> (C entry point, its argument types); every entry returns
# cudaGetLastError() as an int
SIGNATURES = {
    # krows, stash_rows, vals, query, B, K, KW, V, nbuckets, stash,
    # found, slot, out, stream, device
    "probe": ("bng_probe", [_P] * 4 + [_I] * 6 + [_P] * 4 + [_I]),
    # slot, vec, B, want_prefix, want_total, pref, tot, stream, device
    "seg_prefix": ("bng_seg_prefix", [_P, _P, _I, _I, _I, _P, _P, _P, _I]),
}

# The ring's UMEM movers and their registration (`csrc/umem.cu`,
# `ops/umem.py`): entry name -> (source, C entry point, argument types).
# They move frames, not table rows: `LAUNCHES` counts K1 and K2 alone, and
# `ops/umem.LAUNCHES` the movers.
_L = ctypes.c_longlong
MOVERS = {
    # umem, desc_host, desc, n, B, L, pkt, length, fa, now_s, its value, now_us, its value,
    # stream, device
    "umem_gather": ("umem", "bng_umem_gather",
                    [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _L, _P, _L, _P, _I]),
    # umem, addrs, n, L, frame_size, verdict, out_pkt, out_len, stream, device
    "umem_scatter": ("umem", "bng_umem_scatter", [_P, _P] + [_I] * 3 + [_P] * 4 + [_I]),
    # host, size, &device pointer, device
    "umem_register": ("umem", "bng_umem_register", [_P, ctypes.c_size_t, _P, _I]),
    "umem_unregister": ("umem", "bng_umem_unregister", [_P]),
}
# every CUDA source, built together
SOURCES = (*SIGNATURES, *dict.fromkeys(src for src, _, _ in MOVERS.values()))

# source name -> its -D macros; the Python side reads its numbers from here,
# so the kernel and its callers agree on them by construction
DEFINES = {
    "seg_prefix": {"BNG_B_ONE": 8192},  # largest B of K2's one-CTA route
}

LAUNCHES = {name: 0 for name in SIGNATURES}
LAUNCHES_ON: dict[int, dict[str, int]] = {}  # card index -> {name: launches there}
_RECORDING: dict[str, int] | None = None  # a graph capture's launches, while it records

_ENTRIES = {}  # source name -> its loaded C entry point


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LAUNCHES_ON.clear()


def count(name: str, card: int, n: int = 1) -> None:
    """Tally `n` launches of kernel `name` on card `card`; while a graph is
    being captured, into the capture's record instead."""
    if _RECORDING is not None:
        _RECORDING[name] += n
        return
    LAUNCHES[name] += n
    per = LAUNCHES_ON.get(card)
    if per is None:
        per = LAUNCHES_ON[card] = {k: 0 for k in SIGNATURES}
    per[name] += n


@contextlib.contextmanager
def recording():
    """Tally the launches made inside the block into a record of their own
    (yielded), not into `LAUNCHES`: a graph's capture, and the runs that
    build a ring program (`runtime/ringprog.py`), are no launches of the
    path; a replay counts its own. The record is the process's, not the
    thread's: a build must not overlap launches from other threads, whose
    counts it would take out of `LAUNCHES`."""
    global _RECORDING
    outer, _RECORDING = _RECORDING, {k: 0 for k in SIGNATURES}
    try:
        yield _RECORDING
    finally:
        _RECORDING = outer


def capture_graph(dev, run):
    """Capture `run()` as a CUDA graph on card `dev`. It is warmed twice on a
    side stream first (loads the kernels, fills the caching allocator), as
    CUDA graph capture asks, then captured under that card on a capture
    stream of it: torch's default capture stream is made once, on the card
    current at the process's first capture. Returns (graph, its outputs,
    {kernel: launches it recorded}): those run, and are counted, at each
    replay; the capture itself counts none."""
    with torch.cuda.device(dev):
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(2):
                run()
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with recording() as recorded:
            with torch.cuda.graph(graph, stream=torch.cuda.Stream(dev)):
                out = run()
    return graph, out, recorded


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _flags(name: str) -> list[str]:
    return NVCC_FLAGS + [f"-D{k}={v}" for k, v in DEFINES.get(name, {}).items()]


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))  # shared headers
    key = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def build() -> dict[str, tuple[list[str], str]]:
    """Compile every source whose library is missing, all at once.

    Returns {name: (nvcc command, compiler output)} for what it compiled;
    raises with the compiler output if any build fails."""
    missing = [n for n in SOURCES if not _lib_path(n).exists()]
    if not missing:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in missing:
        tmp = _lib_path(name).with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (cmd, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (cmd, tmp, proc) in procs.items():
        logs[name] = (cmd, proc.communicate()[0])
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{logs[name][1]}")
        else:
            os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def entry(name: str):
    """The C entry point of one kernel source, or of a mover (`MOVERS`), its
    argument types declared (builds the sources on first use)."""
    if name not in _ENTRIES:
        build()
        source, symbol, argtypes = MOVERS[name] if name in MOVERS else (name, *SIGNATURES[name])
        fn = getattr(ctypes.CDLL(str(_lib_path(source))), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _ENTRIES[name] = fn
    return _ENTRIES[name]


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_ptr(device) -> int:
    """The current stream of `device`'s card (a capture's stream while a
    CUDA graph is captured there)."""
    return torch.cuda.current_stream(device).cuda_stream

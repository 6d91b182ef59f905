"""Build, load and count the port's hand-written CUDA kernels.

Each `csrc/*.cu` source is compiled by `nvcc` for `sm_90a` into a shared
library with a plain C interface and loaded with `ctypes` (no PyTorch
headers: a build takes seconds). Builds happen at first use, never at
import, into `bng_tpu_torch/_build/`, keyed by a hash of the source and
the flags, so a fresh checkout builds everything it needs by itself.
The missing sources build together, one `nvcc` each, started at once.

`LAUNCHES` counts kernel launches per kernel name: each wrapper adds one
where it launches, and a captured CUDA graph (`runtime/engine.py`'s
`ExpressProgram`) adds the launches it recorded each time it replays
(the capture itself counts none).
"""

from __future__ import annotations

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
    # found, slot, out, stream
    "probe": ("bng_probe", [_P] * 4 + [_I] * 6 + [_P] * 4),
    # slot, vec, B, want_prefix, want_total, pref, tot, stream
    "seg_prefix": ("bng_seg_prefix", [_P, _P, _I, _I, _I, _P, _P, _P]),
}

# source name -> its -D macros; the Python side reads its numbers from here,
# so the kernel and its callers agree on them by construction
DEFINES = {
    "seg_prefix": {"BNG_B_ONE": 8192},  # largest B of K2's one-CTA route
}

LAUNCHES = {name: 0 for name in SIGNATURES}

_ENTRIES = {}  # source name -> its loaded C entry point


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
    key = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def build() -> dict[str, tuple[list[str], str]]:
    """Compile every source whose library is missing, all at once.

    Returns {name: (nvcc command, compiler output)} for what it compiled;
    raises with the compiler output if any build fails."""
    missing = [n for n in SIGNATURES if not _lib_path(n).exists()]
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
    """The C entry point of one kernel source, its argument types declared
    (builds the sources on first use)."""
    if name not in _ENTRIES:
        build()
        symbol, argtypes = SIGNATURES[name]
        fn = getattr(ctypes.CDLL(str(_lib_path(name))), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _ENTRIES[name] = fn
    return _ENTRIES[name]


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream

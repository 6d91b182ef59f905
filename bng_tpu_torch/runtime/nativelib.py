"""Build-on-demand loader for the port's C++ host libraries (port of
`bng_tpu/runtime/nativelib.py`).

`load("bngring", configure)` compiles `bng_tpu_torch/csrc/bngring.cpp`
with `g++` at first use into `bng_tpu_torch/_build/` (never into the
package directory), keyed by a hash of the source, its header and the
flags, so a fresh checkout builds what it needs and a changed source
builds anew. The library is loaded with ctypes and `configure(lib)`
declares its argument and result types once. When no toolchain exists
(or the build fails) it returns None, and callers take their Python path.
"""

from __future__ import annotations

import ctypes as C
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Callable

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

CXX_FLAGS = ["-O2", "-g", "-Wall", "-fPIC", "-std=c++17", "-shared"]

_libs: dict[str, object] = {}
_lock = threading.Lock()


def lib_path(src_name: str) -> Path:
    """Where the library of csrc/<src_name>.cpp is built (hash-keyed)."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for suffix in (".cpp", ".h"):
        src = CSRC / f"{src_name}{suffix}"
        if src.exists():
            h.update(src.read_bytes())
    return BUILD_DIR / f"lib{src_name}-{h.hexdigest()[:16]}.so"


def _build(src_name: str) -> Path | None:
    src = CSRC / f"{src_name}.cpp"
    out = lib_path(src_name)
    if out.exists():
        return out
    if not src.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a private name, then rename: concurrent builds (test
    # workers) never load a half-written library
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(src)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, out)
    return out


def load(src_name: str, configure: Callable[[C.CDLL], None]):
    """The loaded library of csrc/<src_name>.cpp (built if missing), its
    types declared by `configure`; None when it cannot be built."""
    with _lock:
        if src_name in _libs:
            return _libs[src_name]
        path = _build(src_name)
        if path is None:
            return None
        try:
            lib = C.CDLL(str(path))
        except OSError:
            return None
        configure(lib)
        _libs[src_name] = lib
        return lib

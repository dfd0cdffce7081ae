"""Build the hand-written CUDA kernels under `csrc/` at first use.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by `nvcc`
into its own shared library, loaded with `ctypes` (no PyTorch headers: a
build takes seconds, not minutes).  Libraries land in
`build/kernels/<hash>/` at the repository root — a directory `.gitignore`
lists — where the hash covers every source under `csrc/` and the compiler
flags, so an edited kernel never loads a stale library.

The wrappers pass every pointer and the stream as `ctypes.c_void_p`
(`tensor.data_ptr()`, `torch.cuda.current_stream().cuda_stream`) and every
size as `ctypes.c_int`; each C entry returns `cudaGetLastError()` after its
launches, and `check` raises if that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_funcs: Dict[tuple, ctypes._CFuncPtr] = {}


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / _source_hash()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cands = [shutil.which("nvcc")]
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (on PATH or under the CUDA toolkit "
                       "torch was built against): the CUDA kernels cannot "
                       "be built")


def _start(name: str, out: Path):
    """Launch nvcc for one source into a temporary name; returns the
    process and the paths it writes."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = out.with_suffix(".log")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, log


def load(*names: str) -> Sequence[ctypes.CDLL]:
    """The shared libraries for `names`, building the missing ones with
    concurrent nvcc processes.  Raises with the compiler's output if a
    build fails."""
    if all(n in _libs for n in names):
        return [_libs[n] for n in names]
    with _lock:
        d = build_dir()
        todo = [n for n in names if n not in _libs
                and not (d / f"lib{n}.so").exists()]
        running = {n: _start(n, d / f"lib{n}.so") for n in todo}
        for n, (proc, tmp, log) in running.items():
            text, _ = proc.communicate()
            log.write_text(text)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for csrc/{n}.cu:\n{text}")
            os.replace(tmp, d / f"lib{n}.so")
        for n in names:
            if n not in _libs:
                _libs[n] = ctypes.CDLL(str(d / f"lib{n}.so"))
        return [_libs[n] for n in names]


def function(lib: str, name: str, argtypes,
             restype=ctypes.c_int) -> ctypes._CFuncPtr:
    """C entry `name` of library `lib`, typed once: `restype` (an int error
    code unless said otherwise), `argtypes` (ctypes.c_void_p for pointers
    and the stream, c_int/c_float for scalars — untyped, ctypes would pass
    a pointer as a 32-bit int)."""
    key = (lib, name)
    if key not in _funcs:
        (cdll,) = load(lib)
        fn = getattr(cdll, name)
        fn.restype = restype
        fn.argtypes = list(argtypes)
        _funcs[key] = fn
    return _funcs[key]


def compiler_log(name: str) -> str:
    """nvcc's output (`-Xptxas -v`: registers, shared memory, spills) kept
    beside the library `name`, or '' if there is none."""
    log = build_dir() / f"lib{name}.log"
    return log.read_text() if log.exists() else ""


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch "
                           "(cudaGetLastError)")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream() -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

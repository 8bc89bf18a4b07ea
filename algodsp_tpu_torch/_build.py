"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface and is compiled on first
use by `nvcc` for Hopper (`sm_90a`) into a shared library under
`_build/` beside this file (listed in .gitignore), then loaded with
`ctypes`. Nothing here runs at import time: the CPU tests import every
module of the port on a machine without `nvcc`.

Every exported kernel entry returns the `cudaGetLastError()` code right
after its launch; `check()` turns a nonzero code into a RuntimeError, so
a refused launch (too much shared memory, too many threads) is never
silent.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
KERNEL_SOURCES = ("biquad_cascade", "envelope", "fdlconv", "moog")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
_entries: dict[str, ctypes._CFuncPtr] = {}


def nvcc_path() -> str:
    """The CUDA compiler: `$CUDA_HOME/bin/nvcc`, `/usr/local/cuda/bin/nvcc`
    or the first `nvcc` on PATH."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("algodsp_tpu_torch: nvcc not found; the CUDA "
                           "kernels can only be built where the toolkit is")
    return found


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    src = os.path.join(CSRC, f"{name}.cu")
    return (not os.path.exists(lib)
            or os.path.getmtime(lib) < os.path.getmtime(src))


def _start_build(name: str) -> tuple[subprocess.Popen, str]:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = _lib_path(name) + f".{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish_build(name: str, proc: subprocess.Popen, tmp: str) -> None:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    os.replace(tmp, _lib_path(name))


def build_all(names=KERNEL_SOURCES) -> None:
    """Compile every stale kernel source, one `nvcc` per source, all
    started together."""
    with _lock:
        jobs = [(n, *_start_build(n)) for n in names if _stale(n)]
        errors = []
        for name, proc, tmp in jobs:
            try:
                _finish_build(name, proc, tmp)
            except RuntimeError as exc:
                errors.append(str(exc))
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, building it first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        if _stale(name):
            build_all((name,))
        with _lock:
            lib = _loaded.get(name)
            if lib is None:
                lib = ctypes.CDLL(_lib_path(name))
                lib.algodsp_error_string.argtypes = [ctypes.c_int]
                lib.algodsp_error_string.restype = ctypes.c_char_p
                _loaded[name] = lib
    return lib


def entry(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The kernel entry `symbol` of library `name`, its argument types set
    once, when it is first asked for, and its result an int (the
    `cudaGetLastError()` code)."""
    key = f"{name}.{symbol}"
    fn = _entries.get(key)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _entries[key] = fn
    return fn


def check(name: str, code: int, what: str) -> None:
    """Raise if a kernel entry of library `name` reported a CUDA error."""
    if code != 0:
        msg = load(name).algodsp_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code}: {msg}")


def stream_of(t) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on `t`'s device, as a ctypes pointer."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())

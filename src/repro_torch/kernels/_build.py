"""Build and load the package's CUDA kernels.

Each source under `csrc/` is compiled at first use with `nvcc` for Hopper
(`sm_90a`) into a shared library with a plain C interface, which `ctypes`
loads.  Libraries go to `build/` beside this file (listed in .gitignore),
named by the hash of their source, so an edited source is rebuilt and an
unchanged one is loaded as it is.  Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "build"
# shared memory one Hopper block can opt in to (227 KB), the one figure that
# the wrappers' launch plans and csrc/ns_rhs_cluster.cu's `kMaxSmemBytes`
# share; the kernel audit holds it to the card's
# `shared_memory_per_block_optin`
SMEM_OPTIN_BYTES = 232_448
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
# nvcc's report (registers, shared memory, spills) for each library built by
# this process, keyed like `_loaded`.
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit (set CUDA_HOME)")


def library_path(source: str) -> pathlib.Path:
    digest = hashlib.sha256((CSRC / source).read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{pathlib.Path(source).stem}_{digest}.so"


def build(source: str) -> pathlib.Path:
    """Compile `csrc/<source>` unless its library is already built."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source} ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    build_logs[source] = proc.stdout + proc.stderr
    os.replace(tmp, out)  # atomic: a concurrent builder sees all or nothing
    return out


def load(source: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<source>`, built at first use."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            _loaded[source] = lib
        return lib


@functools.cache
def launcher(source: str, name: str, argtypes: tuple):
    """`<name>_launch` of `csrc/<source>` with its C signature `argtypes`,
    wrapped so that a nonzero cudaError_t it returns raises RuntimeError
    with `<name>_error_string`'s message."""
    lib = load(source)
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p

    def launch(*args) -> None:
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"{name} kernel launch failed: "
                               f"{err(rc).decode()} ({rc})")

    return launch

"""Build the hand-written CUDA kernels and bind them through ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
its own by ``nvcc`` for ``sm_90a`` into a shared library under
``build/repro_torch/`` at the root of the checkout.  The file name
carries a hash of the source and the flags, so an edited source builds
anew and an unchanged one is reused.  Nothing is built at import time:
the first launch of a kernel (or ``build_all``) builds it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" \
    / "repro_torch"
KERNELS = ("rmsnorm", "flash_attention", "chunked_reduce",
           "all_gather_matmul", "ssm_scan", "reduce_scatter_rmsnorm",
           "reduce_scatter_adamw")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# a kernel's own flags: ssm_scan's 28 instantiations are compiled on
# parallel threads (14 s instead of 32 s on the card's machine)
EXTRA_FLAGS = {"ssm_scan": ("--split-compile=0",)}

_LOADED: dict = {}
_ENTRIES: dict = {}


def nvcc_path() -> str:
    """``nvcc`` from ``$CUDA_HOME``, the ``PATH`` or ``/usr/local/cuda``."""
    candidates = [os.path.join(os.environ.get("CUDA_HOME", ""), "bin",
                               "nvcc"),
                  shutil.which("nvcc") or "",
                  "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def library_path(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    flags = NVCC_FLAGS + EXTRA_FLAGS.get(name, ())
    key = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{key[:16]}.so"


def _start(name: str):
    """Start ``nvcc`` for one kernel; returns (process, tmp, final) or
    None when the library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, *EXTRA_FLAGS.get(name, ()), "-o",
           str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)      # atomic: a reader never sees half a file


def build_all(names=KERNELS) -> float:
    """Build every kernel in parallel (one ``nvcc`` per source, all
    started together); returns the wall seconds it took."""
    t0 = time.perf_counter()
    started = {n: _start(n) for n in names}
    try:
        for n in names:
            _finish(n, started.pop(n))
    finally:
        for s in started.values():       # a failure stops the others
            if s is not None:
                s[0].kill()
                s[0].wait()
                s[1].unlink(missing_ok=True)
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built first if needed (cached per process)."""
    lib = _LOADED.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = ctypes.CDLL(str(library_path(name)))
        _LOADED[name] = lib
    return lib


def entry(name: str, symbol: str, argtypes: list):
    """The kernel library's C entry point ``symbol`` with its argument
    types declared (ctypes would otherwise pass every int and pointer as
    a 32-bit int); the configured function is cached per process."""
    key = (name, symbol)
    fn = _ENTRIES.get(key)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _ENTRIES[key] = fn
    return fn


def check(name: str, err: int) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch of the
    kernel in library ``name``."""
    if err != 0:
        lib = load(name)
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: cudaError "
                           f"{err} ({msg})")

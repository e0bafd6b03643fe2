"""Build the hand-written CUDA kernels at first use and bind them with ctypes.

``library()`` compiles every ``csrc/*.cu`` with ``nvcc`` for ``sm_90a``
(one compiler process per source, all started together), links one shared
library with a plain C interface, and loads it.  The library lands in
``<package>/_build/<hash>/``, keyed by a hash of the sources and flags, so an
unchanged tree builds once.  Nothing here runs on import: the CPU path never
needs ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(_PKG_DIR, "_build")
LIB_NAME = "libgvq_kernels.so"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point -> argument types; every entry point returns a cudaError_t
_SIGNATURES = {
    "gvq_gq_argmax": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "gvq_downsample_conv": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "gvq_upsample_conv": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "gvq_flash_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
}


def _sources() -> list:
    names = sorted(n for n in os.listdir(CSRC_DIR) if n.endswith((".cu", ".cuh")))
    return [os.path.join(CSRC_DIR, n) for n in names]


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build_dir() -> str:
    return os.path.join(BUILD_ROOT, _digest())


def build() -> str:
    """Compile and link the kernels unless this source hash is built; return
    the library path.  The compiler's output (ptxas register and shared
    memory use) is kept in ``nvcc.log`` beside the library."""
    out_dir = build_dir()
    lib_path = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(BUILD_ROOT, exist_ok=True)
    compiler = nvcc()
    work = tempfile.mkdtemp(prefix="build-", dir=BUILD_ROOT)
    try:
        procs = []
        for src in (s for s in _sources() if s.endswith(".cu")):
            obj = os.path.join(work, os.path.basename(src) + ".o")
            cmd = [compiler, *NVCC_FLAGS, "-c", src, "-o", obj]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {os.path.basename(src)}\n{out}")
            if proc.returncode != 0:
                failed.append(os.path.basename(src))
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp_lib = os.path.join(work, LIB_NAME)
        link = subprocess.run(
            [compiler, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
             "-o", tmp_lib, *[obj for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        with open(os.path.join(work, "nvcc.log"), "w") as f:
            f.write("\n".join(log))
        try:
            os.rename(work, out_dir)
        except OSError:
            if not os.path.exists(lib_path):  # not a concurrent build of the same hash
                raise
        else:
            work = None
    finally:
        if work is not None:
            shutil.rmtree(work, ignore_errors=True)
    return lib_path


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build if needed, load, and declare every entry point's signature."""
    lib = ctypes.CDLL(build())
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.gvq_error_string.argtypes = [ctypes.c_int]
    lib.gvq_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        msg = library().gvq_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def stream_of(t) -> int:
    """Raw handle of the current stream on t's device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream

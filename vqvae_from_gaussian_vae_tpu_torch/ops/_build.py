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
import re
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
# C entry point -> argument types; every entry point returns a cudaError_t.
# The flash forward and backward entries (the labs' too) take their launch
# plan (an int64 array, ops/flash_attention.py FlashFwdPlan.as_array,
# FlashBwdPlan.as_array or, for the float32 head-major entries,
# FlashF32Plan.as_array, which follows their scratch pointer) just before
# the stream; the GroupNorm + swish and LayerNorm backward entries take
# theirs (GnBwdPlan.as_array, LnBwdPlan.as_array) before the dtype
_SIGNATURES = {
    "gvq_gq_argmax": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "gvq_downsample_conv": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "gvq_upsample_conv": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "gvq_flash_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P, _P],
    "gvq_flash_fwd_qkv": [_P, _P, _I, _I, _I, _I, _F, _P, _P],
    "gvq_layer_norm_fwd": [_P, _P, _P, _P, _I, _I, _I, _F, _P],
    "gvq_layer_norm_add_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "gvq_flash_fwd_qkv_res": [_P, _P, _P, _I, _I, _I, _I, _F, _P, _P],
    "gvq_flash_bwd_qkv": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P, _P],
    "gvq_layer_norm_bwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _I, _F, _P],
    "gvq_layer_norm_add_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _I, _F, _P],
    "gvq_flash_fwd_res": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P, _P],
    "gvq_flash_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P, _P],
    "gvq_downsample_dgrad": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "gvq_downsample_wgrad": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "gvq_upsample_dgrad": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "gvq_upsample_wgrad": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "gvq_fused_gn_conv": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "gvq_fused_gn_conv_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "gvq_conv3x3_wgrad": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "gvq_gn_swish_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _I, _P],
    "gvq_flash_fwd_hm": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P, _P],
    "gvq_flash_bwd_hm": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P,
                         _P],
    "gvq_flash_fwd_hm_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P, _P],
    "gvq_flash_bwd_hm_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                             _P, _P],
    "gvq_flash_lab_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _I, _I, _P, _P],
    "gvq_flash_lab_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I,
                          _I, _P, _P],
    "gvq_ln_matmul": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "gvq_matmul_bias": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
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


def ptxas_usage(log_text: str) -> dict:
    """Registers and spill bytes of each kernel from ptxas's ``-v`` report in
    ``nvcc.log``: {mangled name: {"registers", "spill_stores", "spill_loads"}}."""
    usage, current = {}, None
    for line in log_text.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )([^' ]+)", line)
        if m:
            current = usage.setdefault(m.group(1), {})
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            current["spill_stores"], current["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            current["registers"] = int(m.group(1))
    return usage


# an anonymous namespace's mangled name carries two hashes of its source
# file ("..._GLOBAL__N__<hash>_<len>_<file>_cu_<hash>"), which move with the
# file's path; the file name alone names it across checkouts
_ANON = re.compile(r"\d+_GLOBAL__N__[0-9a-f]{8}_\d+_(\w+?)_cu_[0-9a-f]{8}")


def kernel_registers(log_text: str) -> dict:
    """{kernel: registers} from ``nvcc.log``, each kernel named as in
    ``ptxas_usage`` with its anonymous namespace written ``<file.cu>``: the
    same kernel has the same name in every checkout."""
    return {_ANON.sub(r"<\1.cu>", name): entry["registers"]
            for name, entry in ptxas_usage(log_text).items() if "registers" in entry}


# one instruction of a cuobjdump -sass listing: its address, the
# instruction, its encoding's first half (the second half is a line alone)
_SASS_INSTRUCTION = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*(?:/\* 0x[0-9a-f]+ \*/)?$")


def parse_sass(listing: str) -> dict:
    """{kernel: its instructions} from ``cuobjdump -sass`` output, each
    kernel named as in ``kernel_registers`` and each instruction without its
    address and encoding, so that two builds compare kernel by kernel.  Only
    instruction lines count: the header of the cubin that follows a
    source's last kernel is not that kernel's."""
    kernels, current = {}, None
    for line in listing.splitlines():
        if "Function : " in line:
            name = _ANON.sub(r"<\1.cu>", line.split("Function : ", 1)[1].strip())
            current = kernels.setdefault(name, [])
        elif current is not None and (m := _SASS_INSTRUCTION.match(line)):
            current.append(m.group(1))
    return kernels


def sass_diff(lib_path: str, other_path: str) -> dict:
    """The kernels two builds of the library share, and those among them
    whose SASS differs (``cuobjdump -sass``, ``parse_sass``)."""
    cuobjdump = os.path.join(os.path.dirname(nvcc()), "cuobjdump")
    mine, other = (parse_sass(subprocess.run([cuobjdump, "-sass", path], stdout=subprocess.PIPE,
                                             text=True, check=True).stdout)
                   for path in (lib_path, other_path))
    common = sorted(set(mine) & set(other))
    return {"common": len(common), "differ": [k for k in common if mine[k] != other[k]],
            "only_here": sorted(set(mine) - set(other)),
            "only_there": sorted(set(other) - set(mine))}


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        msg = library().gvq_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def wants_grad(*tensors) -> bool:
    """True where autograd records an op on these tensors (None skipped):
    the public ops then run their autograd Functions."""
    import torch

    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def refuse_grad(name: str, *tensors) -> None:
    """Raise where a launch with no backward wired to it would be asked for
    a gradient: its output would be cut off from autograd."""
    if wants_grad(*tensors):
        raise RuntimeError(f"{name}: no backward kernel is wired to this call, so its output "
                           "would be cut off from autograd; call it under torch.no_grad() or "
                           "on tensors that do not require grad")


def kernel_operand(t):
    """``t`` itself where a kernel can read it as it lies (contiguous, data
    on 16 bytes, as TMA and 16-byte loads need), else one fresh contiguous
    copy of it (a new allocation is aligned; a strided tensor is copied
    once)."""
    import torch

    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return torch.empty_like(t, memory_format=torch.contiguous_format).copy_(t)


def stream_of(t) -> int:
    """Raw handle of the current stream on t's device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


if __name__ == "__main__":
    # on a machine with nvcc: build, print the register table as JSON; with
    # --sass-diff OTHER_LIB, the kernels whose SASS differs from another
    # build's library (another checkout's _build/<hash>/libgvq_kernels.so)
    import json
    import sys

    lib = build()
    if sys.argv[1:2] == ["--sass-diff"]:
        json.dump(sass_diff(lib, sys.argv[2]), sys.stdout, indent=0)
    else:
        with open(os.path.join(build_dir(), "nvcc.log")) as f:
            json.dump(kernel_registers(f.read()), sys.stdout, indent=0, sort_keys=True)
    print()

"""Build and load the hand-written Hopper kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc`` for ``sm_90a`` into ONE shared
library with a plain C interface and loaded with :mod:`ctypes`. No
PyTorch header is included: that is what keeps a cold build short
(``torch.utils.cpp_extension`` compiles PyTorch's headers into every
build; PERF.md has the measured build time).

The library is built at first use into ``_build/<hash>/`` beside the
package (listed in ``.gitignore``), keyed by a hash of the sources and
flags, so an edited kernel never loads a stale binary. Nothing happens
at import time: the CPU-only test host imports every module without a
compiler.

Calling convention of every C entry point: device pointers and the CUDA
stream are ``void*`` (passed as ``ctypes.c_void_p`` — a plain int would
be truncated to 32 bits), sizes are ``int``, and the return value is
``cudaGetLastError()`` after the launch; :func:`check` raises on a
non-zero code. A failed build raises as well — there is no fallback.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures: name -> argtypes (restype is always int = cudaError_t)
SIGNATURES = {
    "q8_matmul": [_P, _P, _P, _P, _I, _I, _I, _P],
    "q8_layer_fused": [_P] * 16 + [_I] * 5 + [_F, _P],
    "flash_decode_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "flash_decode_i8": [_P] * 7 + [_I] * 6 + [_P],
    "flash_attention_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib = None


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(install the CUDA toolkit or put nvcc on PATH)")


def library_path() -> Path:
    return BUILD_ROOT / _digest() / "libfunasr_kernels.so"


def _run_all(cmds, verbose: bool):
    """Run the commands concurrently; raise with the output of a failure."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}:\n{stdout}\n{stderr}")
        elif verbose and stderr:
            print(stderr)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))


def build(verbose: bool = False) -> Path:
    """Compile the kernel library if it is not cached; return its path.
    Each source compiles in its own ``nvcc``, all started together; one
    more links the objects."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    flags = ["-Xptxas=-v", *NVCC_FLAGS] if verbose else NVCC_FLAGS
    compile_flags = [f for f in flags if f != "-shared"]
    objs, cmds = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = out.with_name(f"{src.stem}.{tag}.o")   # nvcc wants .o
        objs.append(str(obj))
        cmds.append([nvcc, *compile_flags, "-c", str(src), "-o", str(obj)])
    _run_all(cmds, verbose)
    tmp = out.with_name(f"{out.name}.{tag}")
    _run_all([[nvcc, *NVCC_FLAGS, "-o", str(tmp), *objs]], verbose)
    for obj in objs:
        os.remove(obj)
    os.replace(tmp, out)   # atomic: a concurrent builder never loads half a file
    return out


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def check(code: int, name: str):
    """Raise when a launch reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {code}")


def stream_ptr(device) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())

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
_L = ctypes.c_longlong
# C signatures: name -> argtypes (restype is always int = cudaError_t)
SIGNATURES = {
    "q8_matmul": [_P, _P, _P, _P, _I, _I, _I, _P],
    "q8_gemm": [_P, _P, _P, _P] + [_I] * 6 + [_P],
    "q8_layer_fused": [_P] * 18 + [_I] * 5 + [_F] + [_I] * 2 + [_P],
    "q8_decode_all": [_P] * 33 + [_I] * 7 + [_F, _F] + [_I] * 5 + [_P],
    "q8dot_matmul": [_P, _P, _P, _P, _I, _I, _I, _P],
    "q8dot_matmul_bf16": [_P, _P, _P, _P, _I, _I, _I, _P],
    "q8_matvec_plan": [_I] * 4 + [_P] + [_I] * 2 + [_P],
    "q8i_layer_fused": [_P] * 20 + [_I] * 5 + [_F] + [_I] * 2 + [_P],
    "flash_decode_bf16": [_P] * 7 + [_I] * 7 + [_P],
    "flash_decode_i8": [_P] * 9 + [_I] * 7 + [_P],
    "split_kv_probe": [_P] * 9 + [_I] * 4 + [_F, _P],
    "q8_stream_sum": [_P] * 10 + [_I] * 5 + [_P],
    "q8_stream_gemv": [_P] * 10 + [_I] * 10 + [_P],
    "flash_attention_bf16": [_P] * 6 + [_L] + [_I] * 5 + [_P],
    "q8_layer_fused_grid": [_I, _I, _P],
    "q8i_layer_fused_grid": [_I, _I, _P],
    "q8_decode_all_grid": [_I] * 6 + [_P],
    "q8_probe_p2": [_P] * 16 + [_I] * 5 + [_F] + [_I] * 2 + [_P],
    "probe_reshape": [_P] * 2 + [_I] * 4 + [_P],
    "probe_scale_expand": [_P] * 3 + [_I] * 4 + [_P],
    "probe_transpose": [_P] * 2 + [_I] * 2 + [_P],
    "probe_rope_shuffle": [_P] * 4 + [_I] + [_P],
    "probe_rope_matrix": [_P] * 5 + [_I] + [_P],
    "probe_batched_dot": [_P] * 3 + [_I] * 3 + [_P],
    "probe_pair_scale": [_P] * 2 + [_I] + [_P],
    "probe_head_sum": [_P] * 2 + [_I] * 3 + [_P],
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


def grid_blocks(name: str, *args) -> int:
    """The co-resident grid a cooperative kernel launches, from its C
    query ``name`` (``q8_layer_fused_grid``, ``q8i_layer_fused_grid``,
    ``q8_decode_all_grid``, or ``q8_matvec_plan``, which also registers
    the decode-sized product's plan) on the current device."""
    n = ctypes.c_int(0)
    check(getattr(lib(), name)(*args, ctypes.c_void_p(ctypes.addressof(n))),
          name)
    return n.value


def stream_ptr(device) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


_sms = {}
_tickets = {}


def sm_count(device) -> int:
    """The card's SM count (cached per device)."""
    import torch
    idx = torch.device(device).index or 0
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sms[idx]


def tickets(device, n: int):
    """A zeroed int32 buffer of at least ``n`` tickets for the split-KV
    kernels, one per (device, stream): a kernel's last block resets the
    tickets it used, so the buffer is zero again between calls on a
    stream, and calls on one stream never overlap."""
    import torch
    dev = torch.device(device)
    key = (dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    buf = _tickets.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 256), dtype=torch.int32, device=dev)
        _tickets[key] = buf
    return buf

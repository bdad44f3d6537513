"""ctypes bindings for the native host-runtime library.

The TPU compute path is JAX/XLA/Pallas; this module covers the *host*
hot loops the reference runs natively (numba JIT DP, ffmpeg audio decode):

* ``fuzzy_substring_distance`` / batch — hotword coarse retrieval DP;
* ``nw_align`` — Needleman-Wunsch char alignment fill+traceback;
* ``load_wav_mono`` — WAV decode + mono mixdown + resample.

Build with ``make -C native`` (produces ``native/libfunasr_native.so``).
Every entry point has a numpy fallback, so the library is an optional
accelerator, never a hard dependency.
"""

import ctypes
import os
from typing import List, Optional

import numpy as np

_LIB_PATHS = [
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "native", "libfunasr_native.so"),
    os.path.join(os.path.dirname(os.path.abspath(__file__)),
                 "libfunasr_native.so"),
]

_AUDIO_LIB_PATHS = [p.replace("libfunasr_native", "libfunasr_audio")
                    for p in _LIB_PATHS]

_lib = None
_audio_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    for path in _LIB_PATHS:
        if os.path.exists(path):
            try:
                lib = ctypes.CDLL(path)
            except OSError:
                continue
            lib.fuzzy_substring_distance_i32.restype = ctypes.c_float
            lib.fuzzy_substring_distance_i32.argtypes = [
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
            lib.fuzzy_substring_distance_batch.restype = None
            lib.fuzzy_substring_distance_batch.argtypes = [
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float)]
            lib.nw_align_i32.restype = None
            lib.nw_align_i32.argtypes = [
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
                ctypes.POINTER(ctypes.c_int32)]
            lib.load_wav_mono.restype = ctypes.c_int64
            lib.load_wav_mono.argtypes = [
                ctypes.c_char_p, ctypes.c_int,
                ctypes.POINTER(ctypes.c_double), ctypes.c_int64]
            try:
                # q8_0 block quantizers (quant_kernels.cc) — absent in a
                # stale build of the library; callers fall back to numpy
                f32p = ctypes.POINTER(ctypes.c_float)
                i8p = ctypes.POINTER(ctypes.c_int8)
                u16p = ctypes.POINTER(ctypes.c_uint16)
                lib.q8_0_quantize_f32.restype = None
                lib.q8_0_quantize_f32.argtypes = [
                    f32p, ctypes.c_int64, i8p, u16p]
                lib.q8_0_quantize_transpose_f32.restype = None
                lib.q8_0_quantize_transpose_f32.argtypes = [
                    f32p, ctypes.c_int64, ctypes.c_int64, i8p, u16p]
                lib.q8_0_pack_blocks.restype = None
                lib.q8_0_pack_blocks.argtypes = [
                    i8p, u16p, ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_uint8)]
            except AttributeError:
                pass
            _lib = lib
            return _lib
    _lib = False
    return _lib


def _load_audio_lib():
    """libfunasr_audio.so: universal decoder over system FFmpeg libs."""
    global _audio_lib
    if _audio_lib is not None:
        return _audio_lib
    for path in _AUDIO_LIB_PATHS:
        if os.path.exists(path):
            try:
                lib = ctypes.CDLL(path)
            except OSError:
                continue
            lib.fa_decode_audio.restype = ctypes.c_long
            lib.fa_decode_audio.argtypes = [
                ctypes.c_char_p, ctypes.c_int,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_float))]
            lib.fa_free_audio.restype = None
            lib.fa_free_audio.argtypes = [ctypes.POINTER(ctypes.c_float)]
            lib.fa_encode_mp3.restype = ctypes.c_long
            lib.fa_encode_mp3.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_long,
                ctypes.c_int, ctypes.c_char_p]
            _audio_lib = lib
            return _audio_lib
    _audio_lib = False
    return _audio_lib


def available() -> bool:
    return bool(_load())


def audio_decoder_available() -> bool:
    return bool(_load_audio_lib())


def _i32ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def fuzzy_substring_distance_native(main_codes: np.ndarray,
                                    sub_codes: np.ndarray
                                    ) -> Optional[float]:
    lib = _load()
    if not lib:
        return None
    main_c = np.ascontiguousarray(main_codes, dtype=np.int32)
    sub_c = np.ascontiguousarray(sub_codes, dtype=np.int32)
    return float(lib.fuzzy_substring_distance_i32(
        _i32ptr(main_c), len(main_c), _i32ptr(sub_c), len(sub_c)))


def fuzzy_substring_distance_batch_native(main_codes: np.ndarray,
                                          subs: List[np.ndarray]
                                          ) -> Optional[np.ndarray]:
    lib = _load()
    if not lib or not subs:
        return None
    main_c = np.ascontiguousarray(main_codes, dtype=np.int32)
    lens = np.array([len(s) for s in subs], dtype=np.int32)
    max_len = int(lens.max())
    mat = np.zeros((len(subs), max_len), dtype=np.int32)
    for i, s in enumerate(subs):
        mat[i, : len(s)] = s
    out = np.empty(len(subs), dtype=np.float32)
    lib.fuzzy_substring_distance_batch(
        _i32ptr(main_c), len(main_c), _i32ptr(mat), _i32ptr(lens),
        len(subs), max_len, out.ctypes.data_as(
            ctypes.POINTER(ctypes.c_float)))
    return out


def nw_align_native(ctc_chars: List[str], llm_chars: List[str]
                    ) -> Optional[List[Optional[int]]]:
    lib = _load()
    if not lib:
        return None
    ctc = np.array([ord(c.lower()) for c in ctc_chars], dtype=np.int32)
    llm = np.array([ord(c.lower()) for c in llm_chars], dtype=np.int32)
    out = np.empty(len(llm), dtype=np.int32)
    lib.nw_align_i32(_i32ptr(ctc), len(ctc), _i32ptr(llm), len(llm),
                     out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return [None if v < 0 else int(v) for v in out.tolist()]


def decode_audio_native(path: str, sample_rate: int) -> Optional[np.ndarray]:
    """Decode any container/codec to mono float64 at ``sample_rate`` via
    the FFmpeg-library decoder. Returns None when the library is absent
    or the file cannot be decoded (callers fall through to other paths).

    Output is clipped to [-1, 1]: the reference decodes through pydub's
    int16 samples (``nano_audio.py:14-23``), which saturates, and mp3
    synthesis can overshoot full scale.
    """
    lib = _load_audio_lib()
    if not lib:
        return None
    out = ctypes.POINTER(ctypes.c_float)()
    n = lib.fa_decode_audio(path.encode(), int(sample_rate),
                            ctypes.byref(out))
    if n <= 0:
        return None
    audio = np.ctypeslib.as_array(out, shape=(int(n),)).astype(np.float64)
    lib.fa_free_audio(out)
    return np.clip(audio, -1.0, 1.0)


def encode_mp3_native(audio: np.ndarray, sample_rate: int,
                      path: str) -> bool:
    """Encode mono float [-1,1] to MP3 via libmp3lame (test fixtures)."""
    lib = _load_audio_lib()
    if not lib:
        return False
    pcm = np.ascontiguousarray(audio, dtype=np.float32)
    n = lib.fa_encode_mp3(
        pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(pcm),
        int(sample_rate), path.encode())
    return n > 0


def load_wav_mono_native(path: str, sample_rate: int) -> Optional[np.ndarray]:
    lib = _load()
    if not lib:
        return None
    n = lib.load_wav_mono(path.encode(), sample_rate, None, 0)
    if n < 0:
        return None
    out = np.empty(int(n), dtype=np.float64)
    got = lib.load_wav_mono(path.encode(), sample_rate,
                            out.ctypes.data_as(
                                ctypes.POINTER(ctypes.c_double)), n)
    if got != n:
        return None
    return out


def q8_0_quantize_native(x: np.ndarray):
    """Single-pass C++ q8_0 quantize along the last axis (blocks of 32).

    Returns (q int8 [..., K], d float16 [..., K//32]) bit-identical to the
    numpy path in formats/quant_np.py, or None when the library is absent.
    """
    lib = _load()
    if not lib or not hasattr(lib, "q8_0_quantize_f32"):
        return None
    x = np.ascontiguousarray(x, dtype=np.float32)
    k = x.shape[-1]
    if k % 32 != 0:
        return None
    q = np.empty(x.shape, np.int8)
    d = np.empty((*x.shape[:-1], k // 32), np.float16)
    lib.q8_0_quantize_f32(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), x.size // 32,
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        d.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
    return q, d


def q8_0_quantize_transpose_native(x: np.ndarray):
    """Fused transpose+quantize for GGUF export: ``x`` is our [in, out]
    matrix; returns (q int8 [out, in], d float16 [out, in//32]) — i.e.
    ``q8_0_quantize(x.T)`` without materializing the f32 transpose.
    Returns None when the library is absent or in % 32 != 0.
    """
    lib = _load()
    if not lib or not hasattr(lib, "q8_0_quantize_transpose_f32"):
        return None
    x = np.ascontiguousarray(x, dtype=np.float32)
    if x.ndim != 2 or x.shape[0] % 32 != 0:
        return None
    in_dim, out_dim = x.shape
    q = np.empty((out_dim, in_dim), np.int8)
    d = np.empty((out_dim, in_dim // 32), np.float16)
    lib.q8_0_quantize_transpose_f32(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), in_dim, out_dim,
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        d.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
    return q, d


def q8_0_pack_blocks_native(q: np.ndarray, d: np.ndarray):
    """Interleave split (q, d) into the 34-byte-per-block ggml stream."""
    lib = _load()
    if not lib or not hasattr(lib, "q8_0_pack_blocks"):
        return None
    q = np.ascontiguousarray(q, dtype=np.int8)
    d = np.ascontiguousarray(d, dtype=np.float16)
    nb = q.size // 32
    out = np.empty(nb * 34, np.uint8)
    lib.q8_0_pack_blocks(
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        d.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), nb,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out

"""Minimal GGUF v3 reader/writer (numpy memmap).

Implemented from the GGUF format specification; functionally replaces the
parts of the reference's vendored gguf-py that the engine actually uses
(reference ``fun_asr_gguf/gguf/gguf_reader.py`` for runtime embedding
extraction and ``gguf_writer.py`` for export). Covers:

* header / metadata KV parsing (all scalar types, strings, arrays)
* tensor info + lazy memmap views of tensor payloads
* payload decoding for F32 / F16 / BF16 / I8 / I32 and Q8_0
* a writer sufficient to round-trip checkpoints and export q8_0 models

Shapes are exposed in numpy (row-major) order; GGUF stores dims innermost
first, so we reverse on read and write.
"""

import struct
from dataclasses import dataclass
from enum import IntEnum
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .quant_np import (Q8_0_BLOCK, Q8_0_BLOCK_BYTES, QK_K,
                       iq4_nl_dequantize_blocks, iq4_xs_dequantize_blocks,
                       q2_k_dequantize_blocks, q3_k_dequantize_blocks,
                       q4_k_dequantize_blocks, q5_k_dequantize_blocks,
                       q6_k_dequantize_blocks,
                       q2_k_quantize, q3_k_quantize,
                       q4_k_quantize, q5_k_quantize, q6_k_quantize,
                       q4_0_dequantize_blocks, q4_1_dequantize_blocks,
                       q4_0_quantize, q4_1_quantize, q5_0_quantize,
                       q5_1_quantize,
                       q5_0_dequantize_blocks, q5_1_dequantize_blocks,
                       iq4_nl_quantize, iq4_xs_quantize,
                       iq1_m_dequantize_blocks, iq1_s_dequantize_blocks,
                       iq2_s_dequantize_blocks, iq2_xs_dequantize_blocks,
                       iq2_xxs_dequantize_blocks, iq3_s_dequantize_blocks,
                       iq3_xxs_dequantize_blocks,
                       mxfp4_dequantize_blocks, mxfp4_quantize,
                       tq1_0_dequantize_blocks, tq1_0_quantize,
                       tq2_0_dequantize_blocks, tq2_0_quantize,
                       q8_0_dequantize_blocks, q8_0_from_blocks,
                       q8_0_to_blocks)

GGUF_MAGIC = 0x46554747  # b"GGUF" little-endian
GGUF_VERSION = 3
DEFAULT_ALIGNMENT = 32


class GGMLType(IntEnum):
    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q2_K = 10
    Q3_K = 11
    Q4_K = 12
    Q5_K = 13
    Q6_K = 14
    IQ2_XXS = 16
    IQ2_XS = 17
    IQ3_XXS = 18
    IQ1_S = 19
    IQ4_NL = 20
    IQ3_S = 21
    IQ2_S = 22
    IQ4_XS = 23
    I8 = 24
    I16 = 25
    I32 = 26
    I64 = 27
    F64 = 28
    IQ1_M = 29
    BF16 = 30
    TQ1_0 = 34
    TQ2_0 = 35
    MXFP4 = 39


# (block_values, block_bytes, dequantize_fn) per quantized block format
_BLOCK_FORMATS = {}


_NUMPY_FOR_TYPE = {
    GGMLType.F32: np.dtype(np.float32),
    GGMLType.F16: np.dtype(np.float16),
    GGMLType.I8: np.dtype(np.int8),
    GGMLType.I16: np.dtype(np.int16),
    GGMLType.I32: np.dtype(np.int32),
    GGMLType.I64: np.dtype(np.int64),
    GGMLType.F64: np.dtype(np.float64),
    GGMLType.BF16: np.dtype(np.uint16),  # raw bits
}


class GGUFValueType(IntEnum):
    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    UINT32 = 4
    INT32 = 5
    FLOAT32 = 6
    BOOL = 7
    STRING = 8
    ARRAY = 9
    UINT64 = 10
    INT64 = 11
    FLOAT64 = 12


_SCALAR_FMT = {
    GGUFValueType.UINT8: "<B",
    GGUFValueType.INT8: "<b",
    GGUFValueType.UINT16: "<H",
    GGUFValueType.INT16: "<h",
    GGUFValueType.UINT32: "<I",
    GGUFValueType.INT32: "<i",
    GGUFValueType.FLOAT32: "<f",
    GGUFValueType.BOOL: "<?",
    GGUFValueType.UINT64: "<Q",
    GGUFValueType.INT64: "<q",
    GGUFValueType.FLOAT64: "<d",
}


@dataclass
class GGUFTensorInfo:
    name: str
    shape: Tuple[int, ...]        # numpy order
    ggml_type: GGMLType
    offset: int                   # relative to data section
    nbytes: int


_BLOCK_FORMATS.update({
    GGMLType.Q4_0: (32, 18, q4_0_dequantize_blocks),
    GGMLType.Q4_1: (32, 20, q4_1_dequantize_blocks),
    GGMLType.Q5_0: (32, 22, q5_0_dequantize_blocks),
    GGMLType.Q5_1: (32, 24, q5_1_dequantize_blocks),
    GGMLType.Q8_0: (32, Q8_0_BLOCK_BYTES, q8_0_dequantize_blocks),
    GGMLType.Q2_K: (QK_K, 84, q2_k_dequantize_blocks),
    GGMLType.Q3_K: (QK_K, 110, q3_k_dequantize_blocks),
    GGMLType.Q4_K: (QK_K, 144, q4_k_dequantize_blocks),
    GGMLType.Q5_K: (QK_K, 176, q5_k_dequantize_blocks),
    GGMLType.Q6_K: (QK_K, 210, q6_k_dequantize_blocks),
    GGMLType.IQ4_NL: (32, 18, iq4_nl_dequantize_blocks),
    GGMLType.IQ4_XS: (QK_K, 136, iq4_xs_dequantize_blocks),
    GGMLType.IQ2_XXS: (QK_K, 66, iq2_xxs_dequantize_blocks),
    GGMLType.IQ2_XS: (QK_K, 74, iq2_xs_dequantize_blocks),
    GGMLType.IQ2_S: (QK_K, 82, iq2_s_dequantize_blocks),
    GGMLType.IQ3_XXS: (QK_K, 98, iq3_xxs_dequantize_blocks),
    GGMLType.IQ3_S: (QK_K, 110, iq3_s_dequantize_blocks),
    GGMLType.IQ1_S: (QK_K, 50, iq1_s_dequantize_blocks),
    GGMLType.IQ1_M: (QK_K, 56, iq1_m_dequantize_blocks),
    GGMLType.TQ1_0: (QK_K, 54, tq1_0_dequantize_blocks),
    GGMLType.TQ2_0: (QK_K, 66, tq2_0_dequantize_blocks),
    GGMLType.MXFP4: (32, 17, mxfp4_dequantize_blocks),
})

# float → packed-byte-stream quantizers usable from the writer
_QUANTIZERS = {
    GGMLType.Q4_0: q4_0_quantize,
    GGMLType.Q4_1: q4_1_quantize,
    GGMLType.Q5_0: q5_0_quantize,
    GGMLType.Q5_1: q5_1_quantize,
    GGMLType.TQ1_0: tq1_0_quantize,
    GGMLType.TQ2_0: tq2_0_quantize,
    GGMLType.MXFP4: mxfp4_quantize,
    GGMLType.Q2_K: q2_k_quantize,
    GGMLType.Q3_K: q3_k_quantize,
    GGMLType.Q4_K: q4_k_quantize,
    GGMLType.Q5_K: q5_k_quantize,
    GGMLType.Q6_K: q6_k_quantize,
    GGMLType.IQ4_NL: iq4_nl_quantize,
    GGMLType.IQ4_XS: iq4_xs_quantize,
}


def _type_nbytes(ggml_type: GGMLType, n_elements: int) -> int:
    if ggml_type in _BLOCK_FORMATS:
        block_values, block_bytes, _ = _BLOCK_FORMATS[ggml_type]
        if n_elements % block_values != 0:
            raise ValueError(
                f"corrupt GGUF: {ggml_type.name} tensor with {n_elements} "
                f"elements (not a multiple of the {block_values}-wide block)")
        return (n_elements // block_values) * block_bytes
    return n_elements * _NUMPY_FOR_TYPE[ggml_type].itemsize


class _Cursor:
    def __init__(self, buf: np.memmap):
        self.buf = buf
        self.pos = 0

    def read(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.buf):
            raise ValueError(
                f"corrupt GGUF: read of {n} bytes at offset {self.pos} "
                f"exceeds file size {len(self.buf)}")
        out = self.buf[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def scalar(self, fmt: str):
        size = struct.calcsize(fmt)
        (val,) = struct.unpack(fmt, self.read(size))
        return val

    def string(self) -> str:
        n = self.scalar("<Q")
        return self.read(n).decode("utf-8", errors="replace")

    def value(self, vtype: int):
        vtype = GGUFValueType(vtype)
        self.last_etype = None          # element type of the last ARRAY read
        if vtype == GGUFValueType.STRING:
            return self.string()
        if vtype == GGUFValueType.ARRAY:
            etype = self.scalar("<I")
            count = self.scalar("<Q")
            etype = GGUFValueType(etype)
            if etype == GGUFValueType.STRING:
                out = [self.string() for _ in range(count)]
            elif etype == GGUFValueType.ARRAY:
                # nested arrays: recursion clobbers last_etype — restore
                # the OUTER element type afterwards
                out = [self.value(etype) for _ in range(count)]
            else:
                fmt = _SCALAR_FMT[etype]
                size = struct.calcsize(fmt)
                raw = self.read(size * count)
                out = list(struct.unpack(f"<{count}{fmt[-1]}", raw))
            self.last_etype = etype
            return out
        return self.scalar(_SCALAR_FMT[vtype])


class GGUFReader:
    """Memory-mapped GGUF file reader."""

    def __init__(self, path: str):
        self.path = path
        self.data = np.memmap(path, mode="r", dtype=np.uint8)
        cur = _Cursor(self.data)
        magic = cur.scalar("<I")
        if magic != GGUF_MAGIC:
            raise ValueError(f"not a GGUF file: {path}")
        self.version = cur.scalar("<I")
        n_tensors = cur.scalar("<Q")
        n_kv = cur.scalar("<Q")
        if n_tensors > 1_000_000 or n_kv > 1_000_000:
            raise ValueError(
                f"corrupt GGUF: implausible counts (tensors={n_tensors}, "
                f"kv={n_kv})")

        self.fields: Dict[str, Any] = {}
        # declared value type (and array element type) per key — preserved
        # by the metadata-edit tool so rewrites stay byte-faithful
        self.field_types: Dict[str, Tuple[GGUFValueType,
                                          Optional[GGUFValueType]]] = {}
        for _ in range(n_kv):
            key = cur.string()
            vtype = GGUFValueType(cur.scalar("<I"))
            self.fields[key] = cur.value(vtype)
            self.field_types[key] = (vtype, cur.last_etype)

        try:
            self.alignment = int(self.fields.get("general.alignment",
                                                 DEFAULT_ALIGNMENT))
        except (TypeError, ValueError):
            raise ValueError("corrupt GGUF: non-integer general.alignment "
                             f"{self.fields.get('general.alignment')!r}")
        if self.alignment < 1:
            raise ValueError(
                f"corrupt GGUF: general.alignment={self.alignment}")

        self.tensors: List[GGUFTensorInfo] = []
        for _ in range(n_tensors):
            name = cur.string()
            n_dims = cur.scalar("<I")
            ne = [cur.scalar("<Q") for _ in range(n_dims)]
            ggml_type = GGMLType(cur.scalar("<I"))
            offset = cur.scalar("<Q")
            shape = tuple(reversed(ne))
            # pure-python product: np.prod silently wraps at 2^63, letting
            # corrupt huge dims produce nbytes=0 "short view" tensors
            n_elem = 1
            for dim in ne:
                n_elem *= int(dim)
            if n_elem > len(self.data) * Q8_0_BLOCK:   # generous upper bound
                raise ValueError(
                    f"corrupt GGUF: tensor {name!r} claims {n_elem} "
                    f"elements in a {len(self.data)}-byte file")
            self.tensors.append(GGUFTensorInfo(
                name=name, shape=shape, ggml_type=ggml_type, offset=offset,
                nbytes=_type_nbytes(ggml_type, n_elem)))

        pad = -cur.pos % self.alignment
        self.data_start = cur.pos + pad
        self._by_name = {t.name: t for t in self.tensors}

        # a truncated payload must fail loudly, not hand out short views
        if self.tensors:
            end = max(t.offset + t.nbytes for t in self.tensors)
            if self.data_start + end > len(self.data):
                raise ValueError(
                    f"corrupt GGUF: tensor data extends to byte "
                    f"{self.data_start + end} but the file is only "
                    f"{len(self.data)} bytes (truncated?)")

    def tensor_names(self) -> List[str]:
        return [t.name for t in self.tensors]

    def tensor_info(self, name: str) -> GGUFTensorInfo:
        return self._by_name[name]

    def tensor_raw(self, name: str) -> np.ndarray:
        """Raw byte view of a tensor payload (no copy)."""
        t = self._by_name[name]
        start = self.data_start + t.offset
        return self.data[start:start + t.nbytes]

    def tensor(self, name: str, dequantize: bool = True) -> np.ndarray:
        """Decode a tensor to a numpy array.

        Q8_0 is dequantized to float32 when ``dequantize`` is True; otherwise
        returns the raw block byte stream. BF16 is upcast to float32.
        """
        t = self._by_name[name]
        raw = self.tensor_raw(name)
        if t.ggml_type in _BLOCK_FORMATS:
            if not dequantize:
                return np.frombuffer(raw, dtype=np.uint8)
            return _BLOCK_FORMATS[t.ggml_type][2](raw, t.shape)
        dtype = _NUMPY_FOR_TYPE[t.ggml_type]
        arr = np.frombuffer(raw, dtype=dtype).reshape(t.shape)
        if t.ggml_type == GGMLType.BF16:
            from .quant_np import bf16_dequantize
            arr = bf16_dequantize(arr)
        return arr

    def tensor_q8_0(self, name: str) -> Tuple[np.ndarray, np.ndarray]:
        """Return the split (int8 values, fp16 scales) representation."""
        t = self._by_name[name]
        if t.ggml_type != GGMLType.Q8_0:
            raise ValueError(f"{name} is {t.ggml_type.name}, not Q8_0")
        return q8_0_from_blocks(self.tensor_raw(name), t.shape)


class _ShapeOnly:
    """Zero-allocation shape carrier for raw-passthrough tensors."""

    __slots__ = ("shape",)

    def __init__(self, shape):
        self.shape = tuple(shape)


class GGUFWriter:
    """Single-pass GGUF v3 writer."""

    def __init__(self, path: str, arch: Optional[str] = "qwen3",
                 alignment: int = DEFAULT_ALIGNMENT):
        if alignment < 1:
            raise ValueError(f"general.alignment must be >= 1, got {alignment}")
        self.path = path
        self.alignment = int(alignment)
        self.kv: List[Tuple[str, Any, Optional[GGUFValueType]]] = []
        self.tensors: List[Tuple[str, np.ndarray, GGMLType, Optional[np.ndarray]]] = []
        self._raw: dict = {}
        self._lazy: dict = {}          # name -> producer() for streamed write
        self._qw: dict = {}            # imatrix rows for weighted quant
        if arch is not None:
            self.add_kv("general.architecture", arch)

    # -- KV ----------------------------------------------------------------
    def add_kv(self, key: str, value: Any,
               vtype: Optional[GGUFValueType] = None,
               etype: Optional[GGUFValueType] = None):
        """Add a metadata pair. ``etype`` pins an ARRAY's element type
        (otherwise inferred from the first element)."""
        self.kv.append((key, value, vtype, etype))

    @staticmethod
    def _infer_type(value: Any) -> GGUFValueType:
        if isinstance(value, bool):
            return GGUFValueType.BOOL
        if isinstance(value, int):
            if value >= 2 ** 63:
                return GGUFValueType.UINT64
            return GGUFValueType.INT64 if (value < 0 or value >= 2 ** 32) \
                else GGUFValueType.UINT32
        if isinstance(value, float):
            return GGUFValueType.FLOAT32
        if isinstance(value, str):
            return GGUFValueType.STRING
        if isinstance(value, (list, tuple)):
            return GGUFValueType.ARRAY
        raise TypeError(f"unsupported KV value: {type(value)}")

    @classmethod
    def _pack_value(cls, value: Any, vtype: Optional[GGUFValueType],
                    etype: Optional[GGUFValueType] = None) -> bytes:
        vtype = vtype or cls._infer_type(value)
        out = struct.pack("<I", int(vtype))
        out += cls._pack_payload(value, vtype, etype)
        return out

    @classmethod
    def _pack_payload(cls, value: Any, vtype: GGUFValueType,
                      etype: Optional[GGUFValueType] = None) -> bytes:
        if vtype == GGUFValueType.STRING:
            raw = value.encode("utf-8")
            return struct.pack("<Q", len(raw)) + raw
        if vtype == GGUFValueType.ARRAY:
            if not value:
                return struct.pack("<IQ",
                                   int(etype or GGUFValueType.INT32), 0)
            etype = etype or cls._infer_type(value[0])
            # join, not +=: a vocab-sized string array (151k entries) makes
            # repeated bytes concatenation quadratic (measured 46 s per
            # tokenizer-embedding write; join is ~0.2 s)
            parts = [struct.pack("<IQ", int(etype), len(value))]
            parts.extend(cls._pack_payload(v, etype) for v in value)
            return b"".join(parts)
        return struct.pack(_SCALAR_FMT[vtype], value)

    # -- tensors -----------------------------------------------------------
    def add_tensor(self, name: str, array: np.ndarray,
                   ggml_type: Optional[GGMLType] = None,
                   qw: Optional[np.ndarray] = None):
        """Add a tensor. array dtype decides the storage type unless given.

        For Q8_0, pass a float array with ggml_type=GGMLType.Q8_0 (it will be
        quantized), or call :meth:`add_tensor_q8_0` with split (q, d).
        ``qw``: per-input-channel importance row (an imatrix entry) —
        forwarded to the block quantizer's weighted scale search.
        """
        if qw is not None:
            self._qw[name] = np.asarray(qw, np.float32)
        array = np.asarray(array)
        if ggml_type is None:
            ggml_type = {
                np.dtype(np.float32): GGMLType.F32,
                np.dtype(np.float16): GGMLType.F16,
                np.dtype(np.int8): GGMLType.I8,
                np.dtype(np.int32): GGMLType.I32,
                np.dtype(np.int64): GGMLType.I64,
            }[array.dtype]
        self.tensors.append((name, array, ggml_type, None))

    def add_tensor_q8_0(self, name: str, q: np.ndarray, d: np.ndarray):
        self.tensors.append((name, q, GGMLType.Q8_0, d))

    def add_tensor_raw(self, name: str, raw, shape: Tuple[int, ...],
                       ggml_type: GGMLType):
        """Pass stored bytes through untouched (metadata-edit copies).

        ``raw`` may be bytes or any buffer (e.g. the reader's memmap
        view) — it is not copied here, keeping multi-GB edits O(1) in
        extra RAM.
        """
        holder = _ShapeOnly(shape)
        self._raw[name] = raw
        self.tensors.append((name, holder, ggml_type, None))

    def add_tensor_lazy(self, name: str, shape: Tuple[int, ...],
                        ggml_type: GGMLType, producer,
                        qw: Optional[np.ndarray] = None):
        """Register a tensor whose data is produced DURING :meth:`write`
        (streamed conversion, reference ``gguf/lazy.py`` class of
        behavior): ``producer()`` is called once, its result quantized/
        cast and written immediately, then freed — peak RSS stays ~one
        tensor instead of the whole model. ``producer()`` returns a
        float array of ``shape`` (block-quantized storage types) or an
        array castable to the storage dtype."""
        if qw is not None:
            self._qw[name] = np.asarray(qw, np.float32)
        self._lazy[name] = producer
        self.tensors.append((name, _ShapeOnly(tuple(int(s) for s in shape)),
                             ggml_type, None))

    # -- serialize ---------------------------------------------------------
    def _materialize(self, name, arr, gtype, scales) -> bytes:
        """Storage bytes for one tensor (quantize/cast on demand)."""
        if name in self._raw:
            return self._raw[name]
        if gtype == GGMLType.Q8_0:
            if scales is not None:
                return q8_0_to_blocks(arr, scales).tobytes()
            from .quant_np import q8_0_quantize
            q, d = q8_0_quantize(np.asarray(arr, dtype=np.float32))
            return q8_0_to_blocks(q, d).tobytes()
        if gtype in _QUANTIZERS:
            qw = self._qw.get(name)
            arr32 = np.asarray(arr, dtype=np.float32)
            return (_QUANTIZERS[gtype](arr32) if qw is None
                    else _QUANTIZERS[gtype](arr32, qw)).tobytes()
        if gtype == GGMLType.BF16:
            from .quant_np import bf16_quantize
            return bf16_quantize(np.asarray(arr, dtype=np.float32)).tobytes()
        return np.ascontiguousarray(
            arr.astype(_NUMPY_FOR_TYPE[gtype])).tobytes()

    def write(self):
        alignment = self.alignment
        self.add_kv("general.alignment", alignment, GGUFValueType.UINT32)

        # pass 1: offsets from SIZES only — nothing is quantized or
        # materialized yet, so lazy tensors cost no memory here
        infos: List[bytes] = []
        sizes: List[int] = []
        offset = 0
        for name, arr, gtype, scales in self.tensors:
            n_el = int(np.prod(arr.shape, dtype=np.int64)) \
                if arr.shape else 1
            if name in self._raw:
                nbytes = memoryview(self._raw[name]).nbytes
            else:
                nbytes = _type_nbytes(gtype, n_el)
            pad = -nbytes % alignment
            name_b = name.encode("utf-8")
            ne = list(reversed(arr.shape))
            info = struct.pack("<Q", len(name_b)) + name_b
            info += struct.pack("<I", len(ne))
            for n in ne:
                info += struct.pack("<Q", n)
            info += struct.pack("<IQ", int(gtype), offset)
            infos.append(info)
            sizes.append(nbytes)
            offset += nbytes + pad

        with open(self.path, "wb") as f:
            f.write(struct.pack("<IIQQ", GGUF_MAGIC, GGUF_VERSION,
                                len(self.tensors), len(self.kv)))
            for key, value, vtype, etype in self.kv:
                key_b = key.encode("utf-8")
                f.write(struct.pack("<Q", len(key_b)) + key_b)
                f.write(self._pack_value(value, vtype, etype))
            for info in infos:
                f.write(info)
            f.write(b"\x00" * (-f.tell() % alignment))
            # pass 2: produce → quantize → write → free, one tensor at
            # a time
            for (name, arr, gtype, scales), nbytes in zip(self.tensors,
                                                          sizes):
                if name in self._lazy:
                    arr = np.asarray(self._lazy[name]())
                raw = self._materialize(name, arr, gtype, scales)
                if memoryview(raw).nbytes != nbytes:
                    raise ValueError(
                        f"tensor {name!r}: produced {memoryview(raw).nbytes}"
                        f" bytes, expected {nbytes} (shape/type mismatch)")
                f.write(raw)
                pad = -nbytes % alignment
                if pad:
                    f.write(b"\x00" * pad)
                del raw, arr

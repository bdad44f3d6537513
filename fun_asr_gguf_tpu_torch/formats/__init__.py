"""Model format layer: GGUF IO, q8_0 quantization, vocabularies, tokenizer.

TPU-native replacement for the reference's vendored gguf-py package
(reference ``fun_asr_gguf/gguf/``): a minimal, numpy-memmap GGUF
reader/writer covering what the engine needs (header/KV/tensor parsing,
F32/F16/BF16/Q8_0 payloads) instead of the full 10.5k-LoC vendor tree.
"""

from .gguf import GGUFReader, GGUFWriter, GGMLType  # noqa: F401
from .quant_np import (  # noqa: F401
    q8_0_quantize,
    q8_0_dequantize,
    q8_0_to_blocks,
    q8_0_from_blocks,
    Q8_0_BLOCK,
)

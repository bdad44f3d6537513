"""fun_asr_gguf_tpu_torch: the Fun-ASR-Nano engine in PyTorch and CUDA.

The port of ``fun_asr_gguf_tpu`` (JAX/Pallas on a TPU) to PyTorch on an
NVIDIA H100. Plain tensor code is PyTorch; every TPU kernel on the main
path is a kernel written by hand for Hopper (``csrc/*.cu``, built with
nvcc at first use, see ``kernels/build.py``). The JAX package stays the
reference each part is tested against; this package never imports jax.

    engine = create_asr_engine(checkpoint_dir=...)
    result = engine.transcribe("audio.wav")

The engine takes the JAX facade's defaults at batch 1: per-channel int8
decoder weights (``llm_weight_format="auto"`` in bf16 compute), bf16,
int8 and q8_0 weights, a bf16 or an int8 KV cache, and CTC-draft
speculation. The host-side modules (audio, formats, hotwords, text
utilities) are the port's own copies of the JAX package's.
"""

__version__ = "0.1.0"

_LAZY_ENGINE = {"FunASREngine", "create_asr_engine"}


def __getattr__(name):
    if name in _LAZY_ENGINE:
        from . import engine
        return getattr(engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY_ENGINE))


__all__ = ["FunASREngine", "create_asr_engine"]

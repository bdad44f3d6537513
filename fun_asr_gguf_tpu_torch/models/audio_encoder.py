"""End-to-end audio encoding: frontend → SANM encoder → adaptor.

Counterpart of ``fun_asr_gguf_tpu/models/audio_encoder.py``
(``audio_encoder_forward`` :42). Returns

* ``enc_output`` [B, T_lfr, d_model] f32 — the CTC branch input;
* ``audio_embd`` [B, T_lfr, llm_dim] f32 — the adaptor output, zeroed past
  the valid LLM token length (the host slices it; 60 s → 126 tokens);
* the frame mask.
"""

from dataclasses import dataclass, field

import torch

from ..frontend import (FrontendConfig, audio_token_length_tensor,
                        compute_lfr_features)
from .adaptor import adaptor_forward
from .config import AdaptorConfig, EncoderConfig
from .sanm import encoder_forward


@dataclass(frozen=True)
class AudioEncoderConfig:
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    adaptor: AdaptorConfig = field(default_factory=AdaptorConfig)


def audio_encoder_forward(params, consts, audio, ilens,
                          cfg: AudioEncoderConfig,
                          compute_dtype=torch.float32):
    """audio [B, N] f32, ilens [B] int → (enc, audio_embd, mask).

    Features are computed in f32; the transformer stack runs in
    ``compute_dtype``; outputs are returned in f32."""
    x, mask = compute_lfr_features(consts, audio, ilens, cfg.frontend)
    x = x.to(compute_dtype)
    mask_c = mask.to(compute_dtype)
    enc = encoder_forward(params["encoder"], x, mask_c, cfg.encoder)
    adapt = adaptor_forward(params["adaptor"], enc, mask_c, cfg.adaptor)
    target_len = audio_token_length_tensor(
        ilens.to(device=adapt.device, dtype=torch.int64), cfg.frontend)
    pos = torch.arange(adapt.shape[1], device=adapt.device)[None, :]
    keep = (pos < target_len[:, None]).to(adapt.dtype)
    audio_embd = adapt * keep[:, :, None]
    return enc.to(torch.float32), audio_embd.to(torch.float32), mask

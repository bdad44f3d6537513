"""LLM prompt construction (embedding injection).

Behavioral port of the reference PromptBuilder
(``fun_asr_gguf/prompt_utils.py``): a ChatML prompt whose prefix carries
optional context and hotword hints and ends with the transcription
instruction; prefix/suffix are tokenized and looked up in the host-side
embedding table (the audio embeddings are spliced between them by the
decoder, ``core/decoder.py:199``). Prompt strings must match the reference
byte-for-byte — they are part of the model's conditioning.
"""

from typing import List, Optional, Tuple

import numpy as np

from .formats.tokenizer import BaseTokenizer


class PromptBuilder:
    """Builds prefix/suffix prompt embeddings."""

    def __init__(self, tokenizer: BaseTokenizer, embedding_table: np.ndarray):
        self.tokenizer = tokenizer
        self.embedding_table = embedding_table

    def build_prompt(
        self,
        hotwords: Optional[List[str]] = None,
        language: Optional[str] = None,
        context: Optional[str] = None,
    ) -> Tuple[np.ndarray, np.ndarray, int, int, str]:
        """Returns (prefix_embd, suffix_embd, n_prefix, n_suffix, prefix_text)."""
        prefix_prompt = ("<|im_start|>system\nYou are a helpful assistant."
                         "<|im_end|>\n<|im_start|>user\n")
        if hotwords or context:
            if context:
                prefix_prompt += "请结合上下文信息，更加准确地完成语音转写任务。\n\n\n"
                prefix_prompt += f"**上下文信息：**{context}\n\n\n"
            if hotwords:
                prefix_prompt += f"热词列表：[{', '.join(hotwords)}]\n"
        if not language:
            prefix_prompt += "语音转写："
        else:
            prefix_prompt += f"语音转写成{language}："

        suffix_prompt = "<|im_end|>\n<|im_start|>assistant\n"

        prefix_tokens = self.tokenizer.encode(prefix_prompt)
        suffix_tokens = self.tokenizer.encode(suffix_prompt)

        prefix_embd = self.embedding_table[prefix_tokens].astype(np.float32)
        suffix_embd = self.embedding_table[suffix_tokens].astype(np.float32)
        return (prefix_embd, suffix_embd, len(prefix_tokens),
                len(suffix_tokens), prefix_prompt)

"""Audio loading: file → mono 16 kHz float in [-1, 1].

The reference decodes via pydub→ffmpeg subprocess
(``fun_asr_gguf/nano_audio.py``); here the loader tries, in order:

1. the native in-process decoder (``native/audio_decode.cc``, links the
   system FFmpeg libraries directly — mp3/m4a/flac/ogg/wav/..., no
   subprocess);
2. stdlib WAV parsing (PCM 8/16/24/32-bit) with scipy polyphase
   resampling — zero external dependencies (native fast path first);
3. pydub, if installed;
4. an ``ffmpeg`` subprocess, if present on PATH.

``start_second``/``duration`` slicing matches the reference semantics.
"""

import os
import shutil
import subprocess
import wave
from typing import Optional

import numpy as np


def _resample(audio: np.ndarray, src_rate: int, dst_rate: int) -> np.ndarray:
    if src_rate == dst_rate:
        return audio
    from math import gcd
    from scipy.signal import resample_poly
    g = gcd(src_rate, dst_rate)
    return resample_poly(audio, dst_rate // g, src_rate // g).astype(
        np.float64)


def _load_wav(path: str, sample_rate: int) -> np.ndarray:
    with wave.open(path, "rb") as wf:
        n_channels = wf.getnchannels()
        sampwidth = wf.getsampwidth()
        framerate = wf.getframerate()
        raw = wf.readframes(wf.getnframes())

    if sampwidth == 1:          # unsigned 8-bit
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float64)
                - 128.0) / 128.0
    elif sampwidth == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float64) / 32768.0
    elif sampwidth == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        vals = (b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16))
        vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
        data = vals.astype(np.float64) / float(1 << 23)
    elif sampwidth == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float64) / float(1 << 31)
    else:
        raise ValueError(f"unsupported WAV sample width: {sampwidth}")

    if n_channels > 1:
        data = data.reshape(-1, n_channels).mean(axis=1)
    return _resample(data, framerate, sample_rate)


def _load_ffmpeg(path: str, sample_rate: int) -> np.ndarray:
    cmd = ["ffmpeg", "-v", "quiet", "-i", path, "-f", "f32le",
           "-acodec", "pcm_f32le", "-ac", "1", "-ar", str(sample_rate), "-"]
    out = subprocess.run(cmd, capture_output=True, check=True).stdout
    return np.frombuffer(out, dtype=np.float32).astype(np.float64)


def _load_pydub(path: str, sample_rate: int) -> np.ndarray:
    from pydub import AudioSegment
    seg = AudioSegment.from_file(path).set_channels(1).set_frame_rate(
        sample_rate)
    max_val = float(1 << (seg.sample_width * 8 - 1))
    return np.array(seg.get_array_of_samples(), dtype=np.float64) / max_val


def load_audio(audio_path: str, sample_rate: int = 16000,
               use_normalizer: bool = True,
               start_second: Optional[float] = None,
               duration: Optional[float] = None) -> np.ndarray:
    """Load an audio file as mono float64 at ``sample_rate``."""
    ext = os.path.splitext(audio_path)[1].lower()
    audio = None
    errors = []
    if ext in (".wav", ".wave"):
        try:
            from .native import load_wav_mono_native
            audio = load_wav_mono_native(audio_path, sample_rate)
        except Exception as e:
            errors.append(f"native: {e}")
        if audio is None:
            try:
                audio = _load_wav(audio_path, sample_rate)
            except Exception as e:  # fall through to generic decoders
                errors.append(f"wav: {e}")
    if audio is None:
        try:
            from .native import audio_decoder_available, decode_audio_native
            audio = decode_audio_native(audio_path, sample_rate)
            if audio is None:
                errors.append(
                    "native-decode: could not decode file"
                    if audio_decoder_available()
                    else "native-decode: libfunasr_audio not built")
        except Exception as e:
            errors.append(f"native-decode: {e}")
    if audio is None:
        try:
            audio = _load_pydub(audio_path, sample_rate)
        except ImportError:
            errors.append("pydub: not installed")
        except Exception as e:
            errors.append(f"pydub: {e}")
    if audio is None and shutil.which("ffmpeg"):
        try:
            audio = _load_ffmpeg(audio_path, sample_rate)
        except Exception as e:
            errors.append(f"ffmpeg: {e}")
    if audio is None:
        raise RuntimeError(
            f"could not decode {audio_path!r} ({'; '.join(errors)}); "
            "install pydub/ffmpeg for non-WAV formats")

    if start_second:
        audio = audio[int(start_second * sample_rate):]
    if duration:
        audio = audio[:int(duration * sample_rate)]
    return audio


def write_wav(path: str, audio: np.ndarray, sample_rate: int = 16000):
    """Write mono float [-1,1] as 16-bit PCM WAV (test/bench helper)."""
    pcm = np.clip(np.asarray(audio), -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2")
    with wave.open(path, "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(sample_rate)
        wf.writeframes(pcm.tobytes())

"""WAV decode/encode and int->float normalization.

Host-side analog of the reference ``sound.Wave`` (sound/sound.go:32-141).
Decoding runs on the host (stdlib ``wave`` + numpy, no external deps); the
normalized float signal is what gets shipped to the device.

Parity notes vs the reference:

- int -> float normalization divides by 0x7F / 0x7FFF / 0x7FFFFF / 0x7FFFFFFF
  for 8/16/24/32-bit (sound.Wave.GetFloatAtIdx, sound/sound.go:130-141).
- 8-bit WAV is stored unsigned in the container; go-audio keeps the raw
  0..255 values, and the reference divides those by 0x7F. We reproduce that
  literally (quirk).
- ``Wave.SoundToTensor`` (sound/sound.go:116-127) flattens the *first
  NumFrames interleaved samples* into a 1-D tensor. For multi-channel audio
  this mixes channels and drops the second half of the stream; it is only
  correct for mono. We reproduce it in :meth:`Wave.sound_to_tensor` and also
  provide the sane per-channel variant :meth:`Wave.channel_signal`.
"""

from __future__ import annotations

import wave as _wave
from dataclasses import dataclass

import numpy as np

__all__ = ["Wave", "float_to_wave", "load_wav", "write_wav"]


@dataclass
class Wave:
    """Decoded WAV data: raw ints at source bit depth + format metadata."""

    data: np.ndarray          # int32 array of interleaved raw samples
    sample_rate: int
    channels: int
    source_bit_depth: int

    @property
    def num_frames(self) -> int:
        # audio.IntBuffer.NumFrames = len(Data)/channels
        return len(self.data) // max(self.channels, 1)

    def _norm_divisor(self) -> float:
        # sound/sound.go:130-141
        bd = self.source_bit_depth
        if bd == 32:
            return float(0x7FFFFFFF)
        if bd == 24:
            return float(0x7FFFFF)
        if bd == 16:
            return float(0x7FFF)
        if bd == 8:
            return float(0x7F)
        return 0.0

    def sound_to_tensor(self, dtype=np.float64) -> np.ndarray:
        """Reference-parity flatten: first NumFrames interleaved samples
        normalized to float (sound/sound.go:116-127)."""
        div = self._norm_divisor()
        if div == 0.0:
            return np.zeros(self.num_frames, dtype=dtype)
        return (self.data[: self.num_frames].astype(np.float64) / div).astype(dtype)

    def channel_signal(self, channel: int = 0, dtype=np.float64) -> np.ndarray:
        """Sane de-interleaved single-channel normalized signal (extension)."""
        if not 0 <= channel < self.channels:
            raise ValueError(
                f"channel {channel} out of range (file has {self.channels})"
            )
        div = self._norm_divisor()
        ch = self.data[channel :: self.channels]
        if div == 0.0:
            return np.zeros(len(ch), dtype=dtype)
        return (ch.astype(np.float64) / div).astype(dtype)


def _decode_frames(raw: bytes, sampwidth: int) -> np.ndarray:
    """Decode packed PCM bytes to int32 at source bit depth."""
    if sampwidth == 1:
        # 8-bit PCM is unsigned in the RIFF container; keep raw 0..255
        return np.frombuffer(raw, dtype=np.uint8).astype(np.int32)
    if sampwidth == 2:
        return np.frombuffer(raw, dtype="<i2").astype(np.int32)
    if sampwidth == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        val = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        # sign-extend 24-bit
        val = np.where(val & 0x800000, val - 0x1000000, val)
        return val.astype(np.int32)
    if sampwidth == 4:
        return np.frombuffer(raw, dtype="<i4").astype(np.int32)
    raise ValueError(f"unsupported sample width: {sampwidth} bytes")


def load_wav(path: str) -> Wave:
    """Load + decode a PCM WAV file (analog of sound.Wave.Load, sound/sound.go:37-51)."""
    with _wave.open(path, "rb") as w:
        channels = w.getnchannels()
        rate = w.getframerate()
        sampwidth = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    data = _decode_frames(raw, sampwidth)
    return Wave(
        data=data,
        sample_rate=rate,
        channels=channels,
        source_bit_depth=sampwidth * 8,
    )


def _encode_frames(data: np.ndarray, sampwidth: int) -> bytes:
    if sampwidth == 1:
        return np.clip(data, 0, 255).astype(np.uint8).tobytes()
    if sampwidth == 2:
        return data.astype("<i2").tobytes()
    if sampwidth == 3:
        d = data.astype(np.int64) & 0xFFFFFF
        out = np.empty((len(d), 3), dtype=np.uint8)
        out[:, 0] = d & 0xFF
        out[:, 1] = (d >> 8) & 0xFF
        out[:, 2] = (d >> 16) & 0xFF
        return out.tobytes()
    if sampwidth == 4:
        return data.astype("<i4").tobytes()
    raise ValueError(f"unsupported sample width: {sampwidth} bytes")


def write_wav(path: str, wave_obj: Wave) -> None:
    """Encode + write (analog of sound.Wave.WriteWave, sound/sound.go:55-76)."""
    sampwidth = wave_obj.source_bit_depth // 8
    with _wave.open(path, "wb") as w:
        w.setnchannels(wave_obj.channels)
        w.setsampwidth(sampwidth)
        w.setframerate(wave_obj.sample_rate)
        w.writeframes(_encode_frames(wave_obj.data, sampwidth))


def float_to_wave(
    signal: np.ndarray, sample_rate: int, bit_depth: int = 16, channels: int = 1
) -> Wave:
    """Quantize a [-1, 1] float signal into a Wave (test/fixture helper)."""
    div = {8: 0x7F, 16: 0x7FFF, 24: 0x7FFFFF, 32: 0x7FFFFFFF}[bit_depth]
    data = np.round(np.asarray(signal, dtype=np.float64) * div).astype(np.int64)
    data = np.clip(data, -div - 1, div)
    if bit_depth == 8:
        data = data + 128  # container stores unsigned
    return Wave(
        data=data.astype(np.int32),
        sample_rate=sample_rate,
        channels=channels,
        source_bit_depth=bit_depth,
    )

"""[Copy of audiorenderingv2_tpu/io/wav.py: numpy only, kept equal to it by tests/test_torch_host.py.]

Pure-numpy WAV + AIFF codec.

Replaces the reference's vendored AudioFile.h (WAV/AIFF C++ codec,
prebuild/obj_raytracer/AudioFile.h:66-150). Supports RIFF/WAVE with PCM
(8/16/24/32-bit) and IEEE float (32/64-bit) sample formats, including
WAVE_FORMAT_EXTENSIBLE, plus FORM/AIFF big-endian PCM (8/16/24/32-bit)
with the 80-bit extended-precision sample rate AudioFile.h decodes.
Samples are normalized to [-1, 1] float32 with the same scale conventions
AudioFile.h uses. :func:`read_audio` sniffs the container magic and
dispatches, like AudioFile.h's ``determineAudioFileFormat``.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np

_WAVE_FORMAT_PCM = 0x0001
_WAVE_FORMAT_IEEE_FLOAT = 0x0003
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


@dataclass
class AudioData:
    """Decoded audio: float32 samples in [-1, 1], shape [channels, frames]."""

    samples: np.ndarray
    sample_rate: int

    @property
    def n_channels(self) -> int:
        return int(self.samples.shape[0])

    @property
    def n_frames(self) -> int:
        return int(self.samples.shape[1])

    @property
    def length_seconds(self) -> float:
        return self.n_frames / self.sample_rate

    def mono(self) -> np.ndarray:
        """Channel 0, matching the reference's use of samples[0]
        (Context.cpp audio load; main.cpp:682)."""
        return self.samples[0]


def read_wav(path: str | Path) -> AudioData:
    """Read a RIFF/WAVE file into normalized float32 samples."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 12 or data[0:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")

    fmt = None
    raw = None
    pos = 12
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        (chunk_size,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8 : pos + 8 + chunk_size]
        if chunk_id == b"fmt ":
            if len(body) < 16:
                raise ValueError(f"{path}: truncated fmt chunk "
                                 f"({len(body)} bytes)")
            fmt = struct.unpack_from("<HHIIHH", body, 0)
            if fmt[0] == _WAVE_FORMAT_EXTENSIBLE and chunk_size >= 40:
                # True format lives in the first 2 bytes of the SubFormat GUID.
                (sub,) = struct.unpack_from("<H", body, 24)
                fmt = (sub,) + fmt[1:]
        elif chunk_id == b"data":
            raw = body
        pos += 8 + chunk_size + (chunk_size & 1)  # chunks are word-aligned

    if fmt is None or raw is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format, n_channels, sample_rate, _, _, bits = fmt
    if n_channels < 1:
        raise ValueError(f"{path}: invalid channel count {n_channels}")

    if audio_format == _WAVE_FORMAT_PCM:
        if bits == 8:
            x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 16:
            x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8)
            b = b[: (len(b) // 3) * 3].reshape(-1, 3).astype(np.uint32)
            v = (b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)).astype(np.int32)
            v = np.where(v >= 1 << 23, v - (1 << 24), v)
            x = v.astype(np.float32) / 8388608.0
        elif bits == 32:
            x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
        else:
            raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
    elif audio_format == _WAVE_FORMAT_IEEE_FLOAT:
        if bits == 32:
            x = np.frombuffer(raw, dtype="<f4").astype(np.float32)
        elif bits == 64:
            x = np.frombuffer(raw, dtype="<f8").astype(np.float32)
        else:
            raise ValueError(f"{path}: unsupported float bit depth {bits}")
    else:
        raise ValueError(f"{path}: unsupported WAVE format 0x{audio_format:04x}")

    frames = len(x) // n_channels
    samples = x[: frames * n_channels].reshape(frames, n_channels).T
    return AudioData(samples=np.ascontiguousarray(samples), sample_rate=int(sample_rate))


def write_wav(path: str | Path, samples: np.ndarray, sample_rate: int,
              bit_depth: int = 16) -> None:
    """Write float samples (shape [channels, frames] or [frames]) as WAV.

    PCM 16/24/32 or IEEE float32 (``bit_depth=32`` PCM; pass ``bit_depth=-32``
    for float). Values are clipped to [-1, 1] and scaled like AudioFile.h's
    writer (×32767 for 16-bit).
    """
    samples = np.asarray(samples, dtype=np.float32)
    if samples.ndim == 1:
        samples = samples[None, :]
    n_channels, n_frames = samples.shape
    interleaved = np.clip(samples.T.reshape(-1), -1.0, 1.0)

    if bit_depth == 16:
        payload = (interleaved * 32767.0).astype("<i2").tobytes()
        fmt_code, bits = _WAVE_FORMAT_PCM, 16
    elif bit_depth == 24:
        v = (interleaved * 8388607.0).astype(np.int32)
        b = np.empty((len(v), 3), dtype=np.uint8)
        b[:, 0] = v & 0xFF
        b[:, 1] = (v >> 8) & 0xFF
        b[:, 2] = (v >> 16) & 0xFF
        payload = b.tobytes()
        fmt_code, bits = _WAVE_FORMAT_PCM, 24
    elif bit_depth == 32:
        payload = (interleaved * 2147483647.0).astype("<i4").tobytes()
        fmt_code, bits = _WAVE_FORMAT_PCM, 32
    elif bit_depth == -32:
        payload = interleaved.astype("<f4").tobytes()
        fmt_code, bits = _WAVE_FORMAT_IEEE_FLOAT, 32
    else:
        raise ValueError(f"unsupported bit depth {bit_depth}")

    block_align = n_channels * bits // 8
    byte_rate = sample_rate * block_align
    fmt_chunk = struct.pack("<HHIIHH", fmt_code, n_channels, sample_rate,
                            byte_rate, block_align, bits)
    body = b"WAVE"
    body += b"fmt " + struct.pack("<I", len(fmt_chunk)) + fmt_chunk
    body += b"data" + struct.pack("<I", len(payload)) + payload
    if len(payload) % 2:
        body += b"\x00"  # RIFF chunks are word-aligned
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)


def _decode_be_pcm(raw: bytes, bits: int, where: str) -> np.ndarray:
    """Big-endian signed PCM -> float32 in [-1, 1] (AudioFile.h AIFF scales)."""
    if bits == 8:
        return np.frombuffer(raw, dtype=np.int8).astype(np.float32) / 128.0
    if bits == 16:
        return np.frombuffer(raw, dtype=">i2").astype(np.float32) / 32768.0
    if bits == 24:
        b = np.frombuffer(raw, dtype=np.uint8)
        b = b[: (len(b) // 3) * 3].reshape(-1, 3).astype(np.uint32)
        v = ((b[:, 0] << 16) | (b[:, 1] << 8) | b[:, 2]).astype(np.int32)
        v = np.where(v >= 1 << 23, v - (1 << 24), v)
        return v.astype(np.float32) / 8388608.0
    if bits == 32:
        return np.frombuffer(raw, dtype=">i4").astype(np.float32) / 2147483648.0
    raise ValueError(f"{where}: unsupported AIFF bit depth {bits}")


def _decode_le_pcm(raw: bytes, bits: int, where: str) -> np.ndarray:
    """Little-endian signed PCM -> float32 (AIFC 'sowt' at any depth —
    a 24/32-bit sowt file decoded big-endian would be full-scale noise)."""
    if bits == 8:
        return np.frombuffer(raw, dtype=np.int8).astype(np.float32) / 128.0
    if bits == 16:
        return np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    if bits == 24:
        b = np.frombuffer(raw, dtype=np.uint8)
        b = b[: (len(b) // 3) * 3].reshape(-1, 3).astype(np.uint32)
        v = ((b[:, 2] << 16) | (b[:, 1] << 8) | b[:, 0]).astype(np.int32)
        v = np.where(v >= 1 << 23, v - (1 << 24), v)
        return v.astype(np.float32) / 8388608.0
    if bits == 32:
        return np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    raise ValueError(f"{where}: unsupported AIFF bit depth {bits}")


def _read_float80(b: bytes) -> float:
    """IEEE 754 80-bit extended float (the AIFF COMM sample rate,
    AudioFile.h's sampleRate decode). Layout: 1 sign + 15 exponent bits,
    then a 64-bit mantissa with explicit integer bit."""
    (se,) = struct.unpack_from(">H", b, 0)
    (mant,) = struct.unpack_from(">Q", b, 2)
    sign = -1.0 if se & 0x8000 else 1.0
    exp = se & 0x7FFF
    if exp == 0 and mant == 0:
        return 0.0
    return sign * float(mant) * 2.0 ** (exp - 16383 - 63)


def _write_float80(x: float) -> bytes:
    if x <= 0:
        return b"\x00" * 10
    exp = 16383 + 63
    mant = x
    while mant < float(1 << 63):
        mant *= 2.0
        exp -= 1
    while mant >= float(1 << 64):
        mant /= 2.0
        exp += 1
    return struct.pack(">HQ", exp, int(mant))


def read_aiff(path: str | Path) -> AudioData:
    """Read a FORM/AIFF (or AIFC with raw PCM) file into float32 samples.

    Mirrors AudioFile.h's AIFF decode path: COMM gives channels/bit
    depth/80-bit sample rate, SSND carries big-endian PCM after its
    offset/blockSize header."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 12 or data[0:4] != b"FORM" or data[8:12] not in (b"AIFF", b"AIFC"):
        raise ValueError(f"{path}: not a FORM/AIFF file")

    comm = None
    ssnd = None
    pos = 12
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        (chunk_size,) = struct.unpack_from(">I", data, pos + 4)
        body = data[pos + 8 : pos + 8 + chunk_size]
        if chunk_id == b"COMM":
            n_channels, n_frames, bits = struct.unpack_from(">hIh", body, 0)
            rate = _read_float80(body[8:18])
            comm = (n_channels, n_frames, bits, rate)
            if data[8:12] == b"AIFC" and len(body) >= 22:
                compression = body[18:22]
                if compression not in (b"NONE", b"sowt", b"twos"):
                    raise ValueError(
                        f"{path}: unsupported AIFC compression {compression!r}")
                if compression == b"sowt":
                    comm = comm + ("le",)
        elif chunk_id == b"SSND":
            offset, _block = struct.unpack_from(">II", body, 0)
            ssnd = body[8 + offset:]
        pos += 8 + chunk_size + (chunk_size & 1)

    if comm is None or ssnd is None:
        raise ValueError(f"{path}: missing COMM/SSND chunk")
    n_channels, n_frames, bits, rate = comm[:4]
    if n_channels < 1:
        raise ValueError(f"{path}: invalid channel count {n_channels}")
    if len(comm) == 5:  # AIFC 'sowt': little-endian PCM at ANY bit depth
        x = _decode_le_pcm(ssnd, bits, str(path))
    else:
        x = _decode_be_pcm(ssnd, bits, str(path))
    frames = min(len(x) // n_channels, n_frames) if n_frames else len(x) // n_channels
    samples = x[: frames * n_channels].reshape(frames, n_channels).T
    return AudioData(samples=np.ascontiguousarray(samples),
                     sample_rate=int(round(rate)))


def write_aiff(path: str | Path, samples: np.ndarray, sample_rate: int,
               bit_depth: int = 16) -> None:
    """Write float samples as FORM/AIFF big-endian PCM (16/24/32-bit)."""
    samples = np.asarray(samples, dtype=np.float32)
    if samples.ndim == 1:
        samples = samples[None, :]
    n_channels, n_frames = samples.shape
    interleaved = np.clip(samples.T.reshape(-1), -1.0, 1.0)
    if bit_depth == 16:
        payload = (interleaved * 32767.0).astype(">i2").tobytes()
    elif bit_depth == 24:
        v = (interleaved * 8388607.0).astype(np.int32)
        b = np.empty((len(v), 3), dtype=np.uint8)
        b[:, 0] = (v >> 16) & 0xFF
        b[:, 1] = (v >> 8) & 0xFF
        b[:, 2] = v & 0xFF
        payload = b.tobytes()
    elif bit_depth == 32:
        payload = (interleaved * 2147483647.0).astype(">i4").tobytes()
    else:
        raise ValueError(f"unsupported AIFF bit depth {bit_depth}")

    comm = struct.pack(">hIh", n_channels, n_frames, bit_depth) \
        + _write_float80(float(sample_rate))
    ssnd = struct.pack(">II", 0, 0) + payload
    body = b"AIFF"
    body += b"COMM" + struct.pack(">I", len(comm)) + comm
    body += b"SSND" + struct.pack(">I", len(ssnd)) + ssnd
    if len(ssnd) % 2:
        body += b"\x00"
    with open(path, "wb") as f:
        f.write(b"FORM" + struct.pack(">I", len(body)) + body)


def read_audio(path: str | Path) -> AudioData:
    """Read a WAV or AIFF file, sniffing the container magic — the pure-
    Python equivalent of AudioFile.h's format dispatch (AudioFile.h:66-150)."""
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == b"RIFF":
        return read_wav(path)
    if magic == b"FORM":
        return read_aiff(path)
    raise ValueError(f"{path}: neither RIFF/WAVE nor FORM/AIFF")


def normalize_minus_one_to_one(x: np.ndarray) -> np.ndarray:
    """Rescale to [-1, 1] around the midpoint of (min, max), matching the
    reference's export normalization (main.cpp:628-651)."""
    x = np.asarray(x, dtype=np.float32)
    lo, hi = float(x.min()), float(x.max())
    if hi == lo:
        return np.zeros_like(x)
    return (2.0 * (x - lo) / (hi - lo) - 1.0).astype(np.float32)

"""WAV file I/O without external dependencies.

Replaces the reference's libsndfile usage (rosjack.cpp:189-210, 404-409):
the output writer is 16-bit PCM mono by default, with the same float->int16
conversion libsndfile applies for sf_write_float on a PCM_16 file *without*
SFC_SET_CLIPPING: scale by 32768, round to nearest (even), wrap on overflow.

Reads PCM16/24/32 and float32/float64 WAVs to float arrays in [-1, 1).
A copy of ``beamform_tpu/runtime/wav.py`` without its native (csrc/beamio)
writer, whose binding lives in the JAX package; the NumPy writer here is
bit-identical to it.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np


def _fmt_chunk(fmt_tag, channels, fs, bits):
    block_align = channels * (bits // 8)
    byte_rate = fs * block_align
    return struct.pack("<HHIIHH", fmt_tag, channels, fs, byte_rate,
                       block_align, bits)


def write_wav(path: str, data, sample_rate: int, *, fmt: str = "pcm16"):
    """data: (S,) or (C, S) float in [-1, 1]. fmt: pcm16|pcm24|pcm32|float32.

    pcm16 matches the reference's output path bit-for-bit given identical
    float inputs (libsndfile float->short, no clipping: wraps on overflow).
    """
    # the reference writes through a float32 buffer (rosjack.cpp:208,406-408)
    # — quantize from float32 so native/python/reference agree bit-for-bit
    x = np.asarray(data, dtype=np.float32).astype(np.float64)
    if x.ndim == 1:
        x = x[None, :]
    c, s = x.shape
    inter = np.ascontiguousarray(x.T)  # (S, C) interleaved

    if fmt == "pcm16":
        q = np.rint(inter * 32768.0).astype(np.int64).astype(np.int16)
        payload = q.tobytes()
        fmt_tag, bits = 1, 16
    elif fmt == "pcm24":
        q = np.rint(inter * 8388608.0).astype(np.int64).astype(np.int32)
        b = q.astype("<i4").tobytes()
        payload = b"".join(b[i:i + 3] for i in range(0, len(b), 4))
        fmt_tag, bits = 1, 24
    elif fmt == "pcm32":
        q = np.rint(inter * 2147483648.0)
        q = np.clip(q, -2147483648.0, 2147483647.0).astype(np.int32)
        payload = q.tobytes()
        fmt_tag, bits = 1, 32
    elif fmt == "float32":
        payload = inter.astype("<f4").tobytes()
        fmt_tag, bits = 3, 32
    else:
        raise ValueError(f"unknown wav format {fmt!r}")

    fmt_body = _fmt_chunk(fmt_tag, c, sample_rate, bits)
    riff_size = 4 + (8 + len(fmt_body)) + (8 + len(payload))
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", riff_size) + b"WAVE")
        f.write(b"fmt " + struct.pack("<I", len(fmt_body)) + fmt_body)
        f.write(b"data" + struct.pack("<I", len(payload)) + payload)


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Returns ((C, S) float64 in [-1, 1), sample_rate)."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:4] != b"RIFF" or blob[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos = 12
    fmt = None
    fmt_body = b""
    data = None
    while pos + 8 <= len(blob):
        cid = blob[pos:pos + 4]
        size = struct.unpack("<I", blob[pos + 4:pos + 8])[0]
        body = blob[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
            fmt_body = body
        elif cid == b"data":
            data = body
        pos += 8 + size + (size & 1)
    if fmt is None or data is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    fmt_tag, channels, fs, _, _, bits = fmt
    if fmt_tag == 0xFFFE and len(fmt_body) >= 26:
        # WAVE_FORMAT_EXTENSIBLE: real tag is the SubFormat GUID's head
        fmt_tag = struct.unpack("<H", fmt_body[24:26])[0]
    if fmt_tag == 1 and bits == 16:
        x = np.frombuffer(data, dtype="<i2").astype(np.float64) / 32768.0
    elif fmt_tag == 1 and bits == 24:
        raw = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
        val = (raw[:, 0].astype(np.int32)
               | (raw[:, 1].astype(np.int32) << 8)
               | (raw[:, 2].astype(np.int32) << 16))
        val = np.where(val >= 1 << 23, val - (1 << 24), val)
        x = val.astype(np.float64) / 8388608.0
    elif fmt_tag == 1 and bits == 32:
        x = np.frombuffer(data, dtype="<i4").astype(np.float64) / 2147483648.0
    elif fmt_tag == 3 and bits == 32:
        x = np.frombuffer(data, dtype="<f4").astype(np.float64)
    elif fmt_tag == 3 and bits == 64:
        x = np.frombuffer(data, dtype="<f8").astype(np.float64)
    else:
        raise ValueError(f"{path}: unsupported format tag={fmt_tag} "
                         f"bits={bits}")
    x = x.reshape(-1, channels).T
    return np.ascontiguousarray(x), fs

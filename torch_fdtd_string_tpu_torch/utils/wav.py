"""Minimal dependency-free WAV read/write (PCM_16, PCM_24, PCM_32, FLOAT).

Replaces the reference's ``soundfile`` usage (simulate.py:104-107,432-438,
data.py), so the package does not depend on soundfile/libsndfile.
"""

from __future__ import annotations

import struct

import numpy as np

_SUBTYPE_BITS = {"PCM_16": 16, "PCM_24": 24, "PCM_32": 32, "FLOAT": 32}


def write(path, data, sr, subtype="PCM_16"):
    """Write a mono/multi-channel WAV file.

    ``data``: (n,) or (n, ch) float array in [-1, 1] (clipped like libsndfile).
    """
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[:, None]
    n, ch = data.shape
    bits = _SUBTYPE_BITS[subtype]
    block = ch * bits // 8

    if subtype == "FLOAT":
        fmt_tag = 3
        payload = data.astype("<f4").tobytes()
    else:
        fmt_tag = 1
        # PCM_16/24 quantize in f32: the scale factors (2^15-1, 2^23-1) are
        # exactly representable and f64 round on large buffers is ~25x
        # slower on this host (the product can differ from the f64 product
        # by <= 0.25 ULP, so quantized values match within 1 LSB).  PCM_32
        # stays f64 (2^31-1 is not f32-representable).
        if subtype == "PCM_32":
            clipped = np.clip(data.astype(np.float64), -1.0, 1.0)
            ints = np.round(clipped * 2147483647.0).astype("<i4")
            payload = ints.tobytes()
        elif subtype == "PCM_16":
            clipped = np.clip(data.astype(np.float32), -1.0, 1.0)
            ints = np.round(clipped * np.float32(32767.0)).astype("<i2")
            payload = ints.tobytes()
        else:  # PCM_24: 3-byte little-endian from the low 3 bytes of int32
            clipped = np.clip(data.astype(np.float32), -1.0, 1.0)
            ints = np.round(clipped * np.float32(8388607.0)).astype("<i4")
            b = ints.view(np.uint8).reshape(-1, 4)
            payload = np.ascontiguousarray(b[:, :3]).tobytes()

    hdr = b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE"
    hdr += b"fmt " + struct.pack(
        "<IHHIIHH", 16, fmt_tag, ch, sr, sr * block, block, bits
    )
    hdr += b"data" + struct.pack("<I", len(payload))
    with open(path, "wb") as f:
        f.write(hdr + payload)


def write_columns(paths, data, sr, subtype="PCM_16"):
    """Write each column of ``data`` (n, K) as its own mono WAV file.

    Byte-identical to calling :func:`write` per column, but the
    clip/round/pack pass runs ONCE over the whole matrix — the per-x
    training layout writes hundreds of 1-s wavs per item (reference
    data.py:59-79), and per-file numpy conversion dominates the writer
    thread on a 1-core host (~1.4 ms/file -> ~0.1 ms/file batched).
    """
    data = np.asarray(data)
    assert data.ndim == 2 and len(paths) == data.shape[1], (
        data.shape, len(paths))
    n, K = data.shape
    bits = _SUBTYPE_BITS[subtype]
    block = bits // 8

    fmt_tag = 3 if subtype == "FLOAT" else 1
    nbytes = n * block
    hdr_fmt = b"fmt " + struct.pack(
        "<IHHIIHH", 16, fmt_tag, 1, sr, sr * block, block, bits
    )
    hdr = (
        b"RIFF" + struct.pack("<I", 36 + nbytes) + b"WAVE" + hdr_fmt
        + b"data" + struct.pack("<I", nbytes)
    )
    # column-at-a-time: one ~200 KB hot buffer per file beats a single
    # (K, n) transposed conversion on this host (the big strided f64/f32
    # temps fall out of cache and the batched pass measures ~5x slower);
    # the f32 quantization in write() is what removed the per-file cost
    data = np.asarray(data, np.float32 if subtype != "PCM_32" else np.float64)
    out = np.empty((n,), np.float32 if subtype != "PCM_32" else np.float64)
    for path, xi in zip(paths, range(K)):
        np.clip(data[:, xi], -1.0, 1.0, out=out)
        if subtype == "FLOAT":
            payload = data[:, xi].astype("<f4").tobytes()
        elif subtype == "PCM_16":
            payload = np.round(out * np.float32(32767.0)).astype("<i2").tobytes()
        elif subtype == "PCM_32":
            payload = np.round(out * 2147483647.0).astype("<i4").tobytes()
        else:  # PCM_24
            ints = np.round(out * np.float32(8388607.0)).astype("<i4")
            payload = np.ascontiguousarray(
                ints.view(np.uint8).reshape(-1, 4)[:, :3]
            ).tobytes()
        with open(path, "wb") as f:
            f.write(hdr + payload)


def read(path, dtype=np.float64):
    """Read a WAV file -> (data, sr); data is (n,) mono or (n, ch) float."""
    with open(path, "rb") as f:
        raw = f.read()
    assert raw[:4] == b"RIFF" and raw[8:12] == b"WAVE", path
    pos = 12
    fmt = None
    data = None
    while pos + 8 <= len(raw):
        cid = raw[pos : pos + 4]
        size = struct.unpack("<I", raw[pos + 4 : pos + 8])[0]
        body = raw[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            data = body
        pos += 8 + size + (size & 1)
    assert fmt is not None and data is not None, path
    fmt_tag, ch, sr, _, block, bits = fmt
    if fmt_tag == 3:
        out = np.frombuffer(data, "<f4").astype(dtype)
    elif bits == 16:
        out = np.frombuffer(data, "<i2").astype(dtype) / 32767.0
    elif bits == 32:
        out = np.frombuffer(data, "<i4").astype(dtype) / 2147483647.0
    elif bits == 24:
        b = np.frombuffer(data, np.uint8).reshape(-1, 3)
        i4 = np.zeros((b.shape[0], 4), np.uint8)
        i4[:, 1:] = b
        out = i4.view("<i4")[:, 0].astype(dtype) / (8388607.0 * 256.0)
    else:
        raise ValueError(f"unsupported wav: {fmt}")
    out = out.reshape(-1, ch)
    return (out[:, 0] if ch == 1 else out), sr

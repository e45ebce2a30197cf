"""Minimal OpenEXR reader and writer (stdlib zlib, struct and numpy),
copied from raytracingrust_tpu/io/exr.py.

Reads the still-image flavor the reference's sky maps use: single-part
scanline EXR v2, NONE/ZIP/ZIPS compression, HALF/FLOAT channels.  Writes
uncompressed FLOAT scanline files.  Deep, tiled and multi-part files are
refused.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

MAGIC = 20000630
PT_UINT, PT_HALF, PT_FLOAT = 0, 1, 2
_PT_DTYPE = {PT_UINT: np.uint32, PT_HALF: np.float16, PT_FLOAT: np.float32}
_COMP_NONE, _COMP_RLE, _COMP_ZIPS, _COMP_ZIP = 0, 1, 2, 3
_LINES_PER_BLOCK = {_COMP_NONE: 1, _COMP_ZIPS: 1, _COMP_ZIP: 16}


def _read_cstring(buf: bytes, pos: int):
    end = buf.index(b"\x00", pos)
    return buf[pos:end].decode("latin-1"), end + 1


def _unpredict(data: bytes) -> bytes:
    """EXR zip post-inflate transform: undo delta predictor, then
    de-interleave the two halves."""
    # delta predictor: t[i] = t[i-1] + t[i] - 128
    t = np.frombuffer(data, np.uint8).astype(np.int64)
    t = (np.cumsum(t - 128) + 128) % 256
    t = t.astype(np.uint8)
    # interleave: first half -> even positions, second half -> odd
    n = len(t)
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[0::2] = t[:half]
    out[1::2] = t[half:]
    return out.tobytes()


def read_exr(path: str) -> np.ndarray:
    """-> (H, W, 3) float32 RGB (missing channels are zero; extra channels
    like A are ignored — matching the reference's RGBA-to-RGB drop)."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<iI", buf, 0)
    if magic != MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    if version & 0x200 or version & 0x800 or version & 0x1000:
        raise ValueError(f"{path}: tiled/deep/multipart EXR not supported")
    pos = 8

    channels = []  # (name, pixel_type)
    compression = None
    data_window = None
    while True:
        if buf[pos] == 0:
            pos += 1
            break
        name, pos = _read_cstring(buf, pos)
        atype, pos = _read_cstring(buf, pos)
        (size,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        payload = buf[pos : pos + size]
        pos += size
        if name == "channels":
            cpos = 0
            while payload[cpos] != 0:
                cname, cpos = _read_cstring(payload, cpos)
                (ptype,) = struct.unpack_from("<i", payload, cpos)
                cpos += 16
                channels.append((cname, ptype))
        elif name == "compression":
            compression = payload[0]
        elif name == "dataWindow":
            data_window = struct.unpack("<4i", payload)

    if compression not in _LINES_PER_BLOCK:
        raise ValueError(f"{path}: unsupported EXR compression {compression}")
    x0, y0, x1, y1 = data_window
    width, height = x1 - x0 + 1, y1 - y0 + 1
    # channels are stored sorted by name within each scanline
    channels.sort(key=lambda c: c[0])
    lpb = _LINES_PER_BLOCK[compression]
    n_blocks = (height + lpb - 1) // lpb
    offsets = struct.unpack_from(f"<{n_blocks}q", buf, pos)

    planes = {
        name: np.zeros((height, width), np.float32) for name, _ in channels
    }
    for off in offsets:
        y, size = struct.unpack_from("<ii", buf, off)
        raw = buf[off + 8 : off + 8 + size]
        lines = min(lpb, y1 - y + 1)
        expect = sum(
            width * np.dtype(_PT_DTYPE[pt]).itemsize for _, pt in channels
        ) * lines
        if compression in (_COMP_ZIP, _COMP_ZIPS) and size != expect:
            raw = _unpredict(zlib.decompress(raw))
        cpos = 0
        for line in range(lines):
            for cname, ptype in channels:
                dt = _PT_DTYPE[ptype]
                nb = width * np.dtype(dt).itemsize
                row = np.frombuffer(raw[cpos : cpos + nb], dt)
                planes[cname][y - y0 + line] = row.astype(np.float32)
                cpos += nb

    out = np.zeros((height, width, 3), np.float32)
    for i, cname in enumerate(("R", "G", "B")):
        if cname in planes:
            out[..., i] = planes[cname]
    if "Y" in planes and "R" not in planes:  # luminance-only files
        out[:] = planes["Y"][..., None]
    return out


def write_exr(path: str, image: np.ndarray) -> None:
    """Write (H, W, 3) float32 RGB as an uncompressed scanline EXR."""
    image = np.asarray(image, np.float32)
    h, w, _ = image.shape

    def attr(name: str, atype: str, payload: bytes) -> bytes:
        return (
            name.encode() + b"\x00" + atype.encode() + b"\x00"
            + struct.pack("<i", len(payload)) + payload
        )

    chlist = b""
    for cname in ("B", "G", "R"):  # sorted order
        chlist += cname.encode() + b"\x00" + struct.pack(
            "<iBBBBii", PT_FLOAT, 0, 0, 0, 0, 1, 1
        )
    chlist += b"\x00"

    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header = b"".join([
        attr("channels", "chlist", chlist),
        attr("compression", "compression", bytes([_COMP_NONE])),
        attr("dataWindow", "box2i", box),
        attr("displayWindow", "box2i", box),
        attr("lineOrder", "lineOrder", b"\x00"),
        attr("pixelAspectRatio", "float", struct.pack("<f", 1.0)),
        attr("screenWindowCenter", "v2f", struct.pack("<2f", 0.0, 0.0)),
        attr("screenWindowWidth", "float", struct.pack("<f", 1.0)),
        b"\x00",
    ])

    head = struct.pack("<iI", MAGIC, 2) + header
    table_pos = len(head)
    data_pos = table_pos + 8 * h
    chunks = []
    offsets = []
    pos = data_pos
    for y in range(h):
        # channels sorted: B, G, R
        row = b"".join(
            image[y, :, c].tobytes() for c in (2, 1, 0)
        )
        chunk = struct.pack("<ii", y, len(row)) + row
        offsets.append(pos)
        chunks.append(chunk)
        pos += len(chunk)

    with open(path, "wb") as f:
        f.write(head)
        f.write(struct.pack(f"<{h}q", *offsets))
        f.write(b"".join(chunks))

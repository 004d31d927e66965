"""8-bit grayscale PNG files with the standard library alone (``zlib`` and
``struct``), for ``Trainer.generate_images`` on machines without PIL.

``write_png`` writes the signature, an IHDR chunk (bit depth 8, colour type
0), one IDAT chunk of the rows each led by filter byte 0, and IEND, each
chunk with its CRC-32. ``read_png`` reads such a file back (and rejects the
PNG features it does not write).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)


def write_png(path: str, image: np.ndarray) -> None:
    """Write an (H, W) uint8 image as an 8-bit grayscale PNG file."""
    if image.ndim != 2 or image.dtype != np.uint8:
        raise ValueError(f"want an (H, W) uint8 image, got {image.shape} {image.dtype}")
    h, w = image.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), image], axis=1)  # filter byte 0 a row
    with open(path, "wb") as f:
        f.write(SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(rows.tobytes())) + _chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """The (H, W) uint8 image of an 8-bit grayscale, non-interlaced PNG
    whose rows carry filter 0, as ``write_png`` writes it."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path} is not a PNG file")
    pos, header, idat = len(SIGNATURE), None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in chunk {tag!r}")
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + length
    if header is None or header[2:] != (8, 0, 0, 0, 0):
        raise ValueError(f"{path}: not an 8-bit grayscale non-interlaced PNG ({header})")
    w, h = header[:2]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, w + 1)
    if rows[:, 0].any():
        raise ValueError(f"{path}: rows with a filter other than 0")
    return rows[:, 1:].copy()

"""Per-frame output writers (``evreal_tpu/harness/outputs.py``), formats
byte-compatible with the reference (utils/eval_utils.py:57-84):
``timestamps.txt`` rows ``{idx} {ts:.15f}``, metric rows
``{idx} {score:.5f}``, frames ``frame_%010d.png`` holding
``round(clip(img) * 255)`` as 8-bit grayscale.

The PNG encoder is written with the standard library (``zlib`` +
``struct``), so the port needs no image library; the files decode to the
same pixels as the JAX package's (OpenCV-written) frames.
"""

import os
import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def truncate(path):
    open(path, "w", encoding="utf-8").close()


def _png_chunk(tag, data):
    crc = zlib.crc32(tag + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)


def encode_png_gray8(image):
    """(H, W) uint8 -> bytes of an 8-bit grayscale PNG (no filtering)."""
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8 or image.ndim != 2:
        raise ValueError(f"encode_png_gray8: want (H, W) uint8, got "
                         f"{image.shape} {image.dtype}")
    h, w = image.shape
    rows = np.zeros((h, w + 1), np.uint8)  # leading 0: filter type None
    rows[:, 1:] = image
    header = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    return (_PNG_SIGNATURE + _png_chunk(b"IHDR", header)
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def decode_png_gray8(data):
    """Pixels of an unfiltered 8-bit grayscale PNG, as ``encode_png_gray8``
    writes them; checks the signature, the header and every chunk's CRC."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG")
    pos, idat, shape = 8, b"", None
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc = int.from_bytes(data[pos + 8 + n:pos + 12 + n], "big")
        if zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {tag!r}: bad CRC")
        if tag == b"IHDR":
            w, h, depth, color = struct.unpack(">IIBB", body[:10])
            if (depth, color) != (8, 0):
                raise ValueError("not an 8-bit grayscale PNG")
            shape = (h, w)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8)
    rows = rows.reshape(shape[0], shape[1] + 1)
    if rows[:, 0].any():
        raise ValueError("PNG rows use a filter this reader does not undo")
    return rows[:, 1:]


def save_inferred_image(folder, image, idx):
    """Write ``frame_{idx:010d}.png``; float images are quantized as
    ``round(img * 255)`` (uint8 images are already quantized)."""
    arr = (image if image.dtype == np.uint8
           else np.round(image * 255).astype(np.uint8))
    path = os.path.join(folder, "frame_{:010d}.png".format(idx))
    with open(path, "wb") as f:
        f.write(encode_png_gray8(arr))

"""Per-frame output writers (``evreal_tpu/harness/outputs.py``), formats
byte-compatible with the reference (utils/eval_utils.py:57-84):
``timestamps.txt`` rows ``{idx} {ts:.15f}``, metric rows
``{idx} {score:.5f}``, frames ``frame_%010d.png`` holding
``round(clip(img) * 255)`` as 8-bit grayscale, or as 8-bit RGB for
color frames (given in BGR order, as ``cv2.imwrite`` takes them).

The PNG encoder is written with the standard library (``zlib`` +
``struct``), so the port needs no image library; the files decode to the
same pixels as the JAX package's (OpenCV-written) frames. The eval loops
hand frames to an ``AsyncImageWriter``, which encodes them on a thread of
its own, as the JAX package's does.
"""

import os
import queue
import struct
import threading
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def truncate(path):
    open(path, "w", encoding="utf-8").close()


def _png_chunk(tag, data):
    crc = zlib.crc32(tag + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)


def _encode_png(rows, width, height, color_type):
    """PNG bytes of 8-bit ``rows`` (H, width * channels), no filtering."""
    data = np.zeros((height, rows.shape[1] + 1), np.uint8)
    data[:, 1:] = rows  # leading 0 of each row: filter type None
    header = struct.pack(">IIBBBBB", width, height, 8, color_type, 0, 0, 0)
    return (_PNG_SIGNATURE + _png_chunk(b"IHDR", header)
            + _png_chunk(b"IDAT", zlib.compress(data.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def encode_png_gray8(image):
    """(H, W) uint8 -> bytes of an 8-bit grayscale PNG (no filtering)."""
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8 or image.ndim != 2:
        raise ValueError(f"encode_png_gray8: want (H, W) uint8, got "
                         f"{image.shape} {image.dtype}")
    h, w = image.shape
    return _encode_png(image, w, h, 0)


def encode_png_bgr8(image):
    """(H, W, 3) uint8 in BGR order, as ``cv2.imwrite`` takes it -> bytes
    of an 8-bit RGB PNG (colour type 2, no filtering)."""
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"encode_png_bgr8: want (H, W, 3) uint8, got "
                         f"{image.shape} {image.dtype}")
    h, w = image.shape[:2]
    return _encode_png(image[..., ::-1].reshape(h, w * 3), w, h, 2)


def decode_png(data):
    """Pixels of an unfiltered 8-bit grayscale or RGB PNG, as this module
    writes them: (H, W) grayscale, or (H, W, 3) in BGR order (as
    ``cv2.imread`` returns it). Checks the signature, the header and every
    chunk's CRC."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG")
    pos, idat, shape, channels = 8, b"", None, 1
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc = int.from_bytes(data[pos + 8 + n:pos + 12 + n], "big")
        if zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {tag!r}: bad CRC")
        if tag == b"IHDR":
            w, h, depth, color = struct.unpack(">IIBB", body[:10])
            if depth != 8 or color not in (0, 2):
                raise ValueError("not an 8-bit grayscale or RGB PNG")
            shape, channels = (h, w), 1 if color == 0 else 3
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8)
    rows = rows.reshape(shape[0], shape[1] * channels + 1)
    if rows[:, 0].any():
        raise ValueError("PNG rows use a filter this reader does not undo")
    if channels == 1:
        return rows[:, 1:]
    return rows[:, 1:].reshape(shape + (3,))[..., ::-1]


def decode_png_gray8(data):
    """Pixels of an unfiltered 8-bit grayscale PNG (``decode_png``)."""
    pixels = decode_png(data)
    if pixels.ndim != 2:
        raise ValueError("not an 8-bit grayscale PNG")
    return pixels


def save_inferred_image(folder, image, idx):
    """Write ``frame_{idx:010d}.png``: 8-bit grayscale for (H, W), RGB for
    (H, W, 3) BGR frames (as ``cv2.imwrite``); float images are quantized
    as ``round(clip(img) * 255)`` (uint8 images are already quantized)."""
    arr = (image if image.dtype == np.uint8
           else np.round(np.clip(image, 0, 1) * 255).astype(np.uint8))
    encode = encode_png_gray8 if arr.ndim == 2 else encode_png_bgr8
    path = os.path.join(folder, "frame_{:010d}.png".format(idx))
    with open(path, "wb") as f:
        f.write(encode(arr))


class AsyncImageWriter:
    """Background PNG writer (``evreal_tpu/harness/outputs.py:34-79``):
    one daemon thread runs ``save_inferred_image`` on the frames
    ``submit`` queues. ``zlib.compress`` releases the GIL, so encoding
    overlaps the loop's device waits. The queue is bounded, so a slow disk
    blocks ``submit`` instead of holding every pending frame. A failed
    write raises on the next ``submit`` and again in ``close()``, which
    writes what is queued and joins the thread; ``abandon()`` joins it
    without writing the queued frames.

    A queued frame is the array the loop passed, not a copy: a numpy view
    of a tensor holds that tensor's storage, so a pinned host block stays
    out of the caching allocator until its PNG is written."""

    THREAD_NAME = "AsyncImageWriter"

    def __init__(self, maxsize=128):
        self._q = queue.Queue(maxsize)
        self._err = None
        self._n_failed = 0
        self._drop = False
        self._t = threading.Thread(target=self._loop, name=self.THREAD_NAME,
                                   daemon=True)
        self._t.start()

    def _loop(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            if self._drop:
                continue
            try:
                save_inferred_image(*item)
            except Exception as e:  # noqa: BLE001 — raised by submit/close
                # counted before the error is published, so a submit that
                # sees the error reports at least this failure
                self._n_failed += 1
                if self._err is None:  # keep the first error
                    self._err = e

    def _raise_if_failed(self):
        if self._err is not None:
            raise OSError(f"{self._n_failed} image write(s) failed; "
                          f"first error: {self._err}") from self._err

    def submit(self, folder, image, idx):
        # fail on the next frame, not after the whole sequence's device
        # work, when the output path is broken
        self._raise_if_failed()
        self._q.put((folder, image, idx))

    def close(self):
        self._q.put(None)
        self._t.join()
        self._raise_if_failed()

    def abandon(self):
        """Stop the thread after an error in the loop: the frames still
        queued are dropped (their sequence gets no ``done.json``), and
        write errors are not raised over the loop's own."""
        self._drop = True
        self._q.put(None)
        self._t.join()

"""The comparison that decides ``correct``: what the timed path produced
(8-bit frames, score rows) against the plain reference, as numbers each
held to a limit of its own in ``benchmark/limits/<cell>.json``.

The numbers (module ``Tally``):

* ``missing``: windows or pushes whose frame or score row is absent,
  extra or unreadable, and passes or pushes that failed (limit 0);
* ``px_share``: the share of all compared pixels whose 8-bit value
  differs from the reference's;
* ``frame_px_share``: that share in the worst single frame;
* ``px_gap``: the widest gap, in grey levels, of any pixel;
* ``px_mean_gap``: the mean gap, in grey levels, over all compared
  pixels: one wholly wrong frame among a run's thousand moves it by
  its own mean gap over the frame count, where ``px_share`` moves by
  at most one over that count;
* ``<metric>_gap`` (``mse_gap``, ``ssim_gap``, ``lpips_gap``): the widest
  gap between a written score row and the reference's score of the same
  window; ``<metric>_mean_gap``: the mean of those gaps over the rows;
  ``score_mean_gap``: the largest of the metrics' mean gaps.

Frames the reference finds ill-conditioned (``reference/pipeline.py:
STRETCH_MIN``: an empty window's flat image, stretched over the grey
levels by the robust post-norm) are held to being present only; the
reading ``ill_conditioned`` counts them. A cell's limits file names the
numbers it holds; the others are printed as readings only.
"""

import struct
import zlib

import numpy as np

from benchmark.lib.spec import read_json

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
NAMES = ("missing", "px_share", "px_mean_gap", "frame_px_share", "px_gap",
         "mse_gap", "ssim_gap", "lpips_gap", "mse_mean_gap", "ssim_mean_gap",
         "lpips_mean_gap", "score_mean_gap")


def decode_png_gray8(data):
    """Pixels (H, W) of an unfiltered 8-bit grayscale PNG, the kind the
    eval writes; checks the signature and every chunk's CRC."""
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
            if depth != 8 or color != 0:
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


def read_rows(path):
    """{window index: score} of a score file (``{idx} {score:.5f}``
    lines), or None when it is absent or malformed."""
    try:
        with open(path, encoding="utf-8") as f:
            return {int(a): float(b) for a, b in
                    (line.split() for line in f if line.strip())}
    except (OSError, ValueError):
        return None


class Tally:
    """The running compared numbers of one run."""

    def __init__(self):
        self.missing = 0
        self.px_total = 0
        self.px_off = 0
        self.px_gap_sum = 0
        self.frame_px_share = 0.0
        self.px_gap = 0
        self.gaps = {}
        self.ill = 0
        self.worst = {}   # number -> where the run read its value
        self.sums, self.rows = {}, {}

    def frames(self, got, ref, where=None):
        """Compare (N, H, W) uint8 frames with the reference's (numpy);
        ``where`` names each frame for the readings."""
        gap = np.abs(got.astype(np.int16) - ref.astype(np.int16))
        off = (gap > 0).reshape(len(gap), -1).sum(1)
        self.px_total += gap.size
        self.px_off += int(off.sum())
        self.px_gap_sum += int(gap.sum())
        if len(gap):
            i = int(off.argmax())
            share = float(off[i]) / gap[0].size
            if share > self.frame_px_share:
                self.frame_px_share = share
                self.worst["frame_px_share"] = where[i] if where else i
            self.px_gap = max(self.px_gap, int(gap.max()))

    def score(self, metric, got, ref, where=None):
        gap = abs(float(got) - float(ref))
        self.sums[metric] = self.sums.get(metric, 0.0) + gap
        self.rows[metric] = self.rows.get(metric, 0) + 1
        if gap >= self.gaps.get(metric, 0.0):
            self.gaps[metric] = gap
            self.worst[f"{metric}_gap"] = where

    def values(self):
        means = {m: self.sums[m] / self.rows[m] for m in sorted(self.sums)}
        return {"missing": self.missing,
                "px_share": self.px_off / max(self.px_total, 1),
                "px_mean_gap": self.px_gap_sum / max(self.px_total, 1),
                "frame_px_share": self.frame_px_share,
                "px_gap": self.px_gap, "ill_conditioned": self.ill,
                **{f"{m}_gap": v for m, v in sorted(self.gaps.items())},
                **{f"{m}_mean_gap": v for m, v in means.items()},
                **({"score_mean_gap": max(means.values())} if means else {}),
                "worst": self.worst}


def limits(root, cell_name):
    """{number: limit} of the cell (``benchmark/limits/<cell>.json``)."""
    return read_json(root / "benchmark" / "limits"
                     / f"{cell_name}.json")["limits"]


def judge(values, lims):
    """(correct, [(name, value, limit)]) of the numbers that have a
    limit: each has to stay at or under it; a limited number the run
    could not read fails."""
    rows = [(k, values.get(k, float("inf")), lims[k]) for k in NAMES
            if k in lims]
    return all(v <= lim for _, v, lim in rows), rows

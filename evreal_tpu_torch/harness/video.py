"""Videos of a reconstruction folder (``evreal_tpu/harness/video.py``;
reference utils/create_vid.py): fps = ``round(frames / duration)`` from
``timestamps.txt``, output ``<dir>_<fps>Hz.mp4``, encoded by the ``ffmpeg``
binary at the reference's settings (``-crf 11 -preset slow -pix_fmt
yuv420p``, create_vid.py:20-28).

The JAX package falls back to OpenCV's video writer when ffmpeg is missing
or the frame indices have gaps (``keep_ratio``); the port has no OpenCV,
so gapped indices go to ffmpeg as a glob of the frames (in index order:
the names are zero-padded) and a missing ffmpeg is an error, raised by
``evaluate`` before any work (``require_ffmpeg``).
"""

import glob
import os
import shutil
import subprocess

ENCODE_ARGS = ("-crf", "11", "-preset", "slow", "-pix_fmt", "yuv420p")


def require_ffmpeg():
    """Path of the ``ffmpeg`` binary on PATH; raises when there is none."""
    path = shutil.which("ffmpeg")
    if path is None:
        raise RuntimeError("create_video needs the ffmpeg binary on PATH "
                           "(the port has no OpenCV video writer to fall "
                           "back to); install ffmpeg or set create_video "
                           "to false")
    return path


def video_fps(folder_path):
    """``round(frames / duration)`` of the folder's ``timestamps.txt`` (30
    when the duration is not positive)."""
    with open(os.path.join(folder_path, "timestamps.txt"),
              encoding="utf-8") as f:
        lines = f.readlines()
    duration = float(lines[-1].split()[1]) - float(lines[0].split()[1])
    return round(len(lines) / duration) if duration > 0 else 30


def frame_index(path):
    return int(os.path.basename(path)[len("frame_"):-len(".png")])


def create_vid_from_recon_folder(folder_path, extension="mp4"):
    """Encode the folder's ``frame_*.png`` into ``<dir>_<fps>Hz.<ext>``
    (replacing an older one); nothing when there are no frames. Returns
    the video's path, or None."""
    fps = video_fps(folder_path)
    vid_path = os.path.normpath(folder_path) + f"_{fps}Hz.{extension}"
    if os.path.exists(vid_path):
        os.remove(vid_path)
    frames = sorted(glob.glob(os.path.join(folder_path, "frame_*.png")))
    if not frames:
        return None
    first, last = frame_index(frames[0]), frame_index(frames[-1])
    if last - first + 1 == len(frames):
        source = ["-start_number", str(first), "-i",
                  os.path.join(folder_path, "frame_%010d.png")]
    else:  # gaps (keep_ratio): every frame, in index order
        source = ["-pattern_type", "glob", "-i",
                  os.path.join(glob.escape(folder_path), "frame_*.png")]
    cmd = [require_ffmpeg(), "-y", "-framerate", str(fps), *source,
           *ENCODE_ARGS, vid_path]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"ffmpeg failed (exit {proc.returncode}) on "
                           f"{folder_path}: {proc.stderr[-2000:]}")
    return vid_path

# Copied from clipbert_tpu/data/ingest.py: JAX-free host code, kept importable without jax.
"""Media ingest CLI — the reference's LMDB writer pipeline
(`/root/reference/src/preprocessing/file2lmdb.py`,
`lmdb_utils.py:56-105`) rebuilt for the CBPK packed store:

 - images: re-encoded to JPEG (quality like the reference's cv2 path,
   lmdb_utils.py:37-44)
 - videos: either stored as raw bytes (reference behavior) or transcoded to
   the JSEQ frame container (``--jseq``) so training-time decode is a pure
   per-frame JPEG read (selective decode at zero codec-seek cost)
 - parallel workers (the reference uses a mp.Pool), periodic progress, and
   an error log of undecodable inputs (lmdb_utils.py:99-103)

Usage:
  python -m clipbert_tpu_torch.data.ingest --input_root DIR --output store.cbpk \
      --type image|video [--jseq --fps 30] [--num_workers 8]
"""

from __future__ import annotations

import argparse
import io
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

from clipbert_tpu_torch.data.store import PackWriter
from clipbert_tpu_torch.utils.logger import LOGGER

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")
VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv", ".webm", ".gif")


def find_files(root: str, exts: Tuple[str, ...]) -> List[str]:
    out = []
    for dirpath, _dirs, files in os.walk(root):
        for fn in files:
            if fn.lower().endswith(exts):
                out.append(os.path.join(dirpath, fn))
    return sorted(out)


def encode_image(path: str, quality: int = 95) -> Optional[bytes]:
    """Re-encode to JPEG like the reference's cv2 ingest
    (lmdb_utils.py:37-44); pass-through for existing JPEGs."""
    try:
        with open(path, "rb") as f:
            raw = f.read()
        if path.lower().endswith((".jpg", ".jpeg")):
            return raw
        from PIL import Image
        img = Image.open(io.BytesIO(raw)).convert("RGB")
        buf = io.BytesIO()
        img.save(buf, format="JPEG", quality=quality)
        return buf.getvalue()
    except Exception as e:
        LOGGER.warning(f"failed to encode image {path}: {e}")
        return None


def encode_video(path: str, to_jseq: bool, fps: float,
                 quality: int = 90) -> Optional[bytes]:
    try:
        with open(path, "rb") as f:
            raw = f.read()
        if not to_jseq:
            return raw  # raw bytes, decoded at load time (reference behavior)
        from clipbert_tpu_torch.data import video as vid
        meta = vid.probe(raw)
        if meta is None:
            LOGGER.warning(f"cannot decode {path}; storing raw bytes")
            return raw
        src_fps, n = meta
        import numpy as np
        frames = vid.decode_indices(raw, np.arange(n))
        if frames is None:
            return raw
        return vid.encode_jseq_from_array(frames, src_fps, quality=quality)
    except Exception as e:
        LOGGER.warning(f"failed to ingest video {path}: {e}")
        return None


def ingest(input_root: str, output: str, media_type: str,
           to_jseq: bool = False, fps: float = 30.0,
           num_workers: int = 8) -> Tuple[int, List[str]]:
    exts = IMAGE_EXTS if media_type == "image" else VIDEO_EXTS
    paths = find_files(input_root, exts)
    LOGGER.info(f"ingesting {len(paths)} {media_type}s from {input_root}")
    errors: List[str] = []
    n_written = 0

    def work(path: str):
        if media_type == "image":
            return path, encode_image(path)
        return path, encode_video(path, to_jseq, fps)

    with PackWriter(output) as writer:
        with ThreadPoolExecutor(num_workers) as pool:
            for i, (path, blob) in enumerate(pool.map(work, paths)):
                if blob is None:
                    errors.append(path)
                    continue
                key = os.path.splitext(os.path.basename(path))[0]
                writer.put(key, blob)
                n_written += 1
                if (i + 1) % 1000 == 0:
                    LOGGER.info(f"  {i + 1}/{len(paths)}")
    if errors:
        err_path = output + ".errors.txt"
        with open(err_path, "w") as f:
            f.write("\n".join(errors))
        LOGGER.warning(f"{len(errors)} failures logged to {err_path}")
    LOGGER.info(f"wrote {n_written} entries to {output}")
    return n_written, errors


def main(argv=None):
    ap = argparse.ArgumentParser(description="media -> CBPK store ingest")
    ap.add_argument("--input_root", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--type", choices=["image", "video"], required=True)
    ap.add_argument("--jseq", action="store_true",
                    help="transcode videos to the JSEQ frame container")
    ap.add_argument("--fps", type=float, default=30.0)
    ap.add_argument("--num_workers", type=int, default=8)
    args = ap.parse_args(argv)
    ingest(args.input_root, args.output, args.type, args.jseq, args.fps,
           args.num_workers)


if __name__ == "__main__":
    main()

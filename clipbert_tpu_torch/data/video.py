# Copied from clipbert_tpu/data/video.py: JAX-free host code, kept importable without jax.
"""Video decoding behind one interface, three backends.

The reference decodes H.264 etc. via PyAV->FFmpeg with PTS-seek selective
decoding (`src/datasets/decoder.py:63-201`,
`dataset_base.py:110-150`). The TPU build keeps decode on the CPU host
behind a `decode_clip` interface whose sampling semantics come from the
shared pure math in this package's `data/sampling.py`:

 - **native**: C++ FFmpeg decoder (`native/libclipbert_data.so`, built by
   `make -C native`) — frame-accurate range decode with internal seek,
   multi-threaded; loaded via ctypes.
 - **jseq**: our packed JPEG-frame-sequence container (magic ``JSEQ``) —
   fps + per-frame JPEG blobs with an offset table, so clip sampling decodes
   *only the sampled frames* (true selective decoding, cheaper than any
   codec seek). The ingest tool can transcode videos into it offline.
 - **pyav**: optional, when the `av` package exists (parity with the
   reference's exact decode path).

All backends return (T, H, W, 3) uint8 RGB frames.
"""

from __future__ import annotations

import ctypes
import io
import os
import struct
from typing import List, Optional, Tuple

import numpy as np

from clipbert_tpu_torch.data import sampling

JSEQ_MAGIC = b"JSEQ"
_JSEQ_HEADER = struct.Struct("<4sIdI")  # magic, version, fps, num_frames


# ---------------------------------------------------------------------------
# JSEQ container
# ---------------------------------------------------------------------------

def encode_jseq(frames_jpeg: List[bytes], fps: float) -> bytes:
    """Pack pre-encoded JPEG frames into a JSEQ blob."""
    n = len(frames_jpeg)
    head = _JSEQ_HEADER.pack(JSEQ_MAGIC, 1, float(fps), n)
    offsets = np.zeros(n + 1, np.uint64)
    off = 0
    for i, b in enumerate(frames_jpeg):
        offsets[i] = off
        off += len(b)
    offsets[n] = off
    return head + offsets.tobytes() + b"".join(frames_jpeg)


def encode_jseq_from_array(frames: np.ndarray, fps: float,
                           quality: int = 90) -> bytes:
    """(T, H, W, 3) uint8 -> JSEQ blob (JPEG per frame, PIL encoder)."""
    from PIL import Image
    blobs = []
    for f in frames:
        buf = io.BytesIO()
        Image.fromarray(f).save(buf, format="JPEG", quality=quality)
        blobs.append(buf.getvalue())
    return encode_jseq(blobs, fps)


class JseqReader:
    def __init__(self, data: bytes):
        magic, _ver, self.fps, self.num_frames = _JSEQ_HEADER.unpack_from(
            data, 0)
        assert magic == JSEQ_MAGIC
        base = _JSEQ_HEADER.size
        self._offsets = np.frombuffer(
            data, np.uint64, self.num_frames + 1, base)
        self._data_start = base + self._offsets.nbytes
        self._data = data

    def frame_bytes(self, idx: int) -> bytes:
        s = self._data_start + int(self._offsets[idx])
        e = self._data_start + int(self._offsets[idx + 1])
        return bytes(self._data[s:e])

    def decode_frames(self, indices: np.ndarray) -> np.ndarray:
        """Decode only the requested frames (selective decode)."""
        from PIL import Image
        out = []
        cache = {}
        for idx in indices:
            i = int(idx)
            if i not in cache:
                img = Image.open(io.BytesIO(self.frame_bytes(i)))
                cache[i] = np.asarray(img.convert("RGB"), np.uint8)
            out.append(cache[i])
        return np.stack(out)


# ---------------------------------------------------------------------------
# native FFmpeg backend (ctypes to native/libclipbert_data.so)
# ---------------------------------------------------------------------------

_NATIVE_PATHS = (
    os.path.join(os.path.dirname(__file__), "..", "..", "native",
                 "libclipbert_data.so"),
    "libclipbert_data.so",
)
_native_lib = None


def _load_native():
    """The native decoder library, or None. Only a hit is cached: a miss is
    looked up again on the next call, so a library built after the first
    lookup (``make -C native``) is found."""
    global _native_lib
    if _native_lib is not None:
        return _native_lib
    for p in _NATIVE_PATHS:
        try:
            lib = ctypes.CDLL(os.path.abspath(p) if os.path.sep in p else p)
            lib.vdec_probe.restype = ctypes.c_int
            lib.vdec_probe.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int)]
            lib.vdec_decode_indices.restype = ctypes.c_int
            lib.vdec_decode_indices.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_long), ctypes.c_int,
                ctypes.POINTER(ctypes.c_ubyte)]
            _native_lib = lib
            break
        except OSError:
            continue
    return _native_lib


def native_available() -> bool:
    return _load_native() is not None


def _native_probe(data: bytes) -> Optional[Tuple[float, int, int, int]]:
    lib = _load_native()
    if lib is None:
        return None
    fps = ctypes.c_double()
    nframes = ctypes.c_int()
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.vdec_probe(data, len(data), ctypes.byref(fps),
                        ctypes.byref(nframes), ctypes.byref(w),
                        ctypes.byref(h))
    if rc != 0:
        return None
    return fps.value, nframes.value, w.value, h.value


def _native_decode(data: bytes, indices: np.ndarray, w: int, h: int
                   ) -> Optional[np.ndarray]:
    lib = _load_native()
    idx = (ctypes.c_long * len(indices))(*[int(i) for i in indices])
    out = np.empty((len(indices), h, w, 3), np.uint8)
    rc = lib.vdec_decode_indices(
        data, len(data), idx, len(indices),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
    if rc != 0:
        return None
    return out


# ---------------------------------------------------------------------------
# pyav backend (optional)
# ---------------------------------------------------------------------------

def _pyav_decode(data: bytes, indices: np.ndarray) -> Optional[np.ndarray]:
    try:
        import av
    except ImportError:
        return None
    container = av.open(io.BytesIO(data), metadata_errors="ignore")
    frames = [f.to_rgb().to_ndarray()
              for f in container.decode(video=0)]
    container.close()
    if not frames:
        return None
    idx = np.clip(indices, 0, len(frames) - 1)
    return np.stack([frames[int(i)] for i in idx])


def _pyav_probe(data: bytes) -> Optional[Tuple[float, int]]:
    try:
        import av
    except ImportError:
        return None
    container = av.open(io.BytesIO(data), metadata_errors="ignore")
    stream = container.streams.video[0]
    fps = float(stream.average_rate)
    n = stream.frames
    if not n:
        n = sum(1 for _ in container.decode(video=0))
    container.close()
    return fps, n


# ---------------------------------------------------------------------------
# unified interface
# ---------------------------------------------------------------------------

def probe(data: bytes) -> Optional[Tuple[float, int]]:
    """(fps, num_frames) of a video blob, or None if undecodable."""
    if data[:4] == JSEQ_MAGIC:
        r = JseqReader(data)
        return r.fps, r.num_frames
    info = _native_probe(bytes(data))
    if info is not None:
        return info[0], info[1]
    return _pyav_probe(bytes(data))


def decode_indices(data: bytes, indices: np.ndarray) -> Optional[np.ndarray]:
    """Decode the given absolute frame indices -> (T, H, W, 3) uint8 RGB."""
    if data[:4] == JSEQ_MAGIC:
        return JseqReader(data).decode_frames(indices)
    info = _native_probe(bytes(data))
    if info is not None:
        return _native_decode(bytes(data), indices, info[2], info[3])
    return _pyav_decode(bytes(data), indices)


def decode_clip(data: bytes, num_frames: int, target_fps: float,
                sampling_strategy: str = "rand",
                num_clips: Optional[int] = None,
                clip_idx: Optional[int] = None,
                rng: Optional[np.random.Generator] = None
                ) -> Optional[np.ndarray]:
    """Sample one clip from a video blob (the `_load_video` contract,
    dataset_base.py:234-273, minus resize/pad which live in transforms).

    Returns (num_frames, H, W, 3) uint8 RGB or None on decode failure.
    """
    try:
        meta = probe(data)
        if meta is None:
            return None
        fps, video_size = meta
        if video_size <= 0:
            return None
        plan = sampling.plan_clip(
            video_size, fps, num_frames, target_fps,
            sampling_strategy=sampling_strategy,
            num_clips=num_clips, clip_idx=clip_idx, rng=rng)
        return decode_indices(data, plan.indices)
    except Exception:
        return None


def decode_multi_clips(data: bytes, num_frames: int, target_fps: float,
                       num_clips: int, random_clips: bool = False,
                       rng: Optional[np.random.Generator] = None
                       ) -> Optional[np.ndarray]:
    """(num_clips * num_frames, H, W, 3) ensemble load
    (dataset_video_retrieval.py:40-56)."""
    try:
        meta = probe(data)
        if meta is None:
            return None
        fps, video_size = meta
        plans = sampling.plan_multi_clips(video_size, fps, num_frames,
                                          target_fps, num_clips,
                                          random_clips, rng)
        indices = np.concatenate([p.indices for p in plans])
        return decode_indices(data, indices)
    except Exception:
        return None

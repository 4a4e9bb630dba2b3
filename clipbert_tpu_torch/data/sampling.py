# Copied from clipbert_tpu/data/sampling.py: JAX-free host code, kept importable without jax.
"""Sparse clip sampling math — pure functions, no decoder coupling.

Re-implements the reference's sampling semantics
(`src/datasets/decoder.py:11-60,203-283` and
`src/datasets/dataset_base.py:14-63`) as pure index math so
any decoder backend (native FFmpeg, PyAV, packed-frame stores) shares one
tested implementation:

 - `get_start_end_idx`: random clip (clip_idx=-1) vs uniform clip_idx/num_clips
   split (decoder.py:31-60).
 - `temporal_sampling_indices`: equal-interval (linspace) frame pick with
   clamping (decoder.py:11-28).
 - `plan_clip`: the full strategy dispatch (rand / uniform / start / middle /
   end / multi-clip ensemble) including fps retargeting
   clip_size = sampling_rate * num_frames / target_fps * fps
   (decoder.py:167,266; dataset_base.py:14-63).

All randomness comes from an explicit numpy Generator so runs are
reproducible (the reference uses the global `random` module).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

STRATEGIES = ("rand", "uniform", "start", "middle", "end")


def get_start_end_idx(video_size: int, clip_size: float, clip_idx: int,
                      num_clips: int,
                      rng: Optional[np.random.Generator] = None):
    """Start/end frame indices (floats) of one clip (decoder.py:31-60)."""
    delta = max(video_size - clip_size, 0)
    if clip_idx == -1:
        rng = rng or np.random.default_rng()
        start_idx = rng.uniform(0, delta)
    else:
        start_idx = delta * clip_idx / num_clips
    end_idx = start_idx + clip_size - 1
    return start_idx, end_idx


def temporal_sampling_indices(num_available: int, start_idx: float,
                              end_idx: float, num_samples: int) -> np.ndarray:
    """Equal-interval sample of `num_samples` indices in [start, end], clamped
    to [0, num_available-1] (decoder.py:11-28, torch.linspace semantics)."""
    index = np.linspace(start_idx, end_idx, num_samples)
    return np.clip(index, 0, num_available - 1).astype(np.int64)


@dataclass(frozen=True)
class ClipPlan:
    """Frame indices to sample, relative to the full video."""

    indices: np.ndarray           # (num_frames,) absolute frame indices
    range_start: int              # first frame that must be decoded
    range_end: int                # last frame that must be decoded (inclusive)


def plan_clip(video_size: int, fps: float, num_frames: int, target_fps: float,
              sampling_strategy: str = "rand",
              num_clips: Optional[int] = None,
              clip_idx: Optional[int] = None,
              sampling_rate: float = 1.0,
              rng: Optional[np.random.Generator] = None) -> ClipPlan:
    """Which absolute frame indices to sample for one clip.

    Mirrors get_video_decoding_kwargs (dataset_base.py:14-63) + the decode()
    index math (decoder.py:263-283):

     - ``num_clips``/``clip_idx`` given: multi-clip ensemble — uniformly split
       into num_clips, pick clip_idx, clip at target_fps.
     - strategy "rand": random clip of num_frames at target_fps.
     - strategy "uniform": num_frames equally spaced over the WHOLE video
       (fps ignored; clip_idx=-2 path of decoder.py:230-236).
     - "start"/"middle"/"end": uniform 3-way split, clip at target_fps.
    """
    assert video_size >= 1
    if num_clips is None:
        assert sampling_strategy in STRATEGIES, sampling_strategy
        if sampling_strategy == "rand":
            eff_clip_idx, eff_num_clips = -1, 1
        elif sampling_strategy == "uniform":
            eff_clip_idx, eff_num_clips = -2, 1
        else:
            eff_clip_idx = ("start", "middle", "end").index(sampling_strategy)
            eff_num_clips = 3
    else:
        assert clip_idx is not None
        eff_clip_idx, eff_num_clips = clip_idx, num_clips

    if eff_clip_idx == -2:
        clip_size = float(video_size)
        eff_clip_idx, eff_num_clips = 0, 1
    else:
        clip_size = sampling_rate * num_frames / target_fps * fps

    start_idx, end_idx = get_start_end_idx(
        video_size, clip_size, eff_clip_idx, eff_num_clips, rng)
    indices = temporal_sampling_indices(video_size, start_idx, end_idx,
                                        num_frames)
    return ClipPlan(indices=indices,
                    range_start=int(indices.min()),
                    range_end=int(indices.max()))


def plan_multi_clips(video_size: int, fps: float, num_frames: int,
                     target_fps: float, num_clips: int,
                     random_clips: bool = False,
                     rng: Optional[np.random.Generator] = None):
    """Plans for a `num_clips` ensemble: random clips at train
    (dataset_video_retrieval.py:40-46) or uniform clip_idx=0..N-1 at eval
    (:48-56). Returns list[ClipPlan] of length num_clips."""
    if random_clips:
        return [plan_clip(video_size, fps, num_frames, target_fps, "rand",
                          rng=rng) for _ in range(num_clips)]
    return [plan_clip(video_size, fps, num_frames, target_fps,
                      num_clips=num_clips, clip_idx=i, rng=rng)
            for i in range(num_clips)]

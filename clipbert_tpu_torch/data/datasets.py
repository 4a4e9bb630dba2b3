# Copied from clipbert_tpu/data/datasets.py (the eval parts of BaseDataset, VideoRetrievalEvalDataset): JAX-free host code.
"""Retrieval eval dataset (numpy, host-side).

Capability match for the reference's `src/datasets/dataset_base.py` and
`dataset_video_retrieval.py`, the parts the retrieval eval runs:

 - :class:`BaseDataset` — media store read + decode + resize/pad
   (dataset_base.py:165-273), uint8 NHWC out; extreme-aspect-ratio skip
   (dataset_base.py:228-233), multi-clip ensemble loads with prev-clip
   fallback (dataset_video_qa.py:49-81).
 - :class:`VideoRetrievalEvalDataset` — per-video items scored against the
   full caption list (dataset_video_retrieval.py:174-250).

The train datasets, image loading and collators wait for the training
slice of the port.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Dict, List, Optional

import numpy as np

from clipbert_tpu_torch.data import transforms, video
from clipbert_tpu_torch.data.store import MediaStore
from clipbert_tpu_torch.data.tokenization import BertTokenizer
from clipbert_tpu_torch.utils.basic import load_jsonl  # noqa: F401 (as in the JAX module)

LOGGER = logging.getLogger(__name__)


class BaseDataset:
    def __init__(self, datalist: List, tokenizer: BertTokenizer,
                 media_store: MediaStore, fps: float = 3, num_frm: int = 3,
                 frm_sampling_strategy: str = "rand", max_img_size: int = 448,
                 max_txt_len: int = 20, seed: int = 0,
                 device_preprocess: bool = False):
        self.datalist = datalist
        self.tokenizer = tokenizer
        self.store = media_store
        self.fps = fps
        self.num_frm = num_frm
        # device_preprocess=True: emit NATIVE-size frames (+ "vis_hw") and
        # leave resize/pad/normalize to the device path
        # (transforms.resize_pad_normalize); False: host torch resize + pad
        # here, exactly the reference transform (dataset_base.py:207-275).
        self.device_preprocess = device_preprocess
        self.frm_sampling_strategy = frm_sampling_strategy
        self.max_img_size = max_img_size
        self.max_txt_len = max_txt_len
        self.seed = seed
        self.rng = np.random.default_rng(seed)  # init-time / single-thread use
        # eval items that fell back to black frames (eval_fallback_frames);
        # loader threads count them concurrently, under the lock
        self.n_fallbacks = 0
        self._fallback_lock = threading.Lock()

    def __len__(self):
        return len(self.datalist)

    def _decode(self, vid_id, num_clips=None, clip_idx=None, rng=None):
        raw = self.store.get(str(vid_id))
        if raw is None:
            return None
        return video.decode_clip(
            bytes(raw), num_frames=self.num_frm, target_fps=self.fps,
            sampling_strategy=self.frm_sampling_strategy,
            num_clips=num_clips, clip_idx=clip_idx,
            rng=rng if rng is not None else self.rng)

    def load_video(self, vid_id, num_clips=None, clip_idx=None, rng=None
                   ) -> Optional[np.ndarray]:
        """One clip: (num_frm, S, S, 3) uint8, or None (dataset_base.py:234-273)."""
        frames = self._decode(vid_id, num_clips, clip_idx, rng=rng)
        if frames is None:
            return None
        if transforms.is_extreme_aspect_ratio(frames.shape[1], frames.shape[2]):
            return None
        if self.device_preprocess:
            return frames
        frames = transforms.resize_frames(frames, self.max_img_size)
        return transforms.pad_frames(frames, self.max_img_size,
                                     self.max_img_size)

    def load_video_multi_clips(self, vid_id, n_clips: int,
                               random_clips: bool,
                               prev_clip_fallback: bool = False,
                               rng=None) -> Optional[np.ndarray]:
        """(n_clips*num_frm, S, S, 3) ensemble (dataset_video_retrieval.py:
        40-56; prev-clip fallback from dataset_video_qa.py:49-81)."""
        clips, prev = [], None
        for i in range(n_clips):
            if random_clips:
                c = self.load_video(vid_id, rng=rng)
            else:
                c = self.load_video(vid_id, num_clips=n_clips, clip_idx=i,
                                    rng=rng)
            if c is None and prev_clip_fallback:
                c = prev
            if c is None:
                return None
            prev = c
            clips.append(c)
        return np.concatenate(clips, axis=0)

    def vis_item(self, arr: np.ndarray) -> Dict[str, Any]:
        """Item-dict visual fields: {"vis"} host-preprocessed, or
        {"vis", "vis_hw"} native — vis_hw = [h, w, new_h, new_w] with the
        resize target computed HERE (host float math) so the int truncation
        is bit-identical to the reference (data_utils.py:166-197)."""
        if not self.device_preprocess:
            return {"vis": arr}
        h, w = int(arr.shape[1]), int(arr.shape[2])
        nh, nw = transforms.get_resize_size(h, w, self.max_img_size)
        return {"vis": arr, "vis_hw": np.array([h, w, nh, nw], np.int32)}

    def eval_fallback_frames(self, vid_id, n_frames: int) -> np.ndarray:
        """Degrade-don't-die for EVAL paths: when a video is undecodable even
        after the multi-clip prev-clip safeguard, substitute black frames and
        log — that one video scores near chance instead of a crash killing an
        hours-long full-matrix run (the reference's eval analogue: multi-clip
        safeguard + prev-clip copy, dataset_video_retrieval.py:48-56)."""
        LOGGER.warning(
            f"eval video {vid_id!r} failed to decode; substituting "
            f"{n_frames} black frames (its scores will be ~chance)")
        with self._fallback_lock:
            self.n_fallbacks += 1
        # device-preprocess items are NATIVE-size: substitute at the collate
        # bucket granularity (64px), never max_img_size — a 448x448 black
        # frame would raise the whole batch's bucket above every real video
        s = transforms._BUCKET if self.device_preprocess else self.max_img_size
        return np.zeros((n_frames, s, s, 3), np.uint8)


class VideoRetrievalEvalDataset(BaseDataset):
    """datalist: list of dicts {"id": int (== position), "txt": str,
    "vid_id": str}. Iterates videos; text side is tokenized once and reused
    (the 1-video x all-captions protocol,
    dataset_video_retrieval.py:228-250)."""

    def __init__(self, datalist: List[Dict], *args,
                 ensemble_n_clips: int = 1, **kw):
        for i, d in enumerate(datalist):
            assert i == d["id"], "caption id must equal its index"
        super().__init__(datalist, *args, **kw)
        self.ensemble_n_clips = ensemble_n_clips
        self.gt_cap_id2vid_id = {d["id"]: d["vid_id"] for d in datalist}
        # unique videos in first-appearance order
        seen = dict()
        for d in datalist:
            seen.setdefault(d["vid_id"], None)
        self.video_ids = list(seen)

    def __len__(self):
        return len(self.video_ids)

    def encode_all_captions(self) -> Dict[str, np.ndarray]:
        enc = self.tokenizer.batch_encode(
            [d["txt"] for d in self.datalist], self.max_txt_len)
        return {"text_input_ids": enc["input_ids"],
                "text_input_mask": enc["attention_mask"]}

    def __getitem__(self, index: int) -> Dict[str, Any]:
        vid_id = self.video_ids[index]
        arr = self.load_video_multi_clips(vid_id, self.ensemble_n_clips,
                                          random_clips=False,
                                          prev_clip_fallback=True)
        if arr is None:
            arr = self.eval_fallback_frames(
                vid_id, self.ensemble_n_clips * self.num_frm)
        return {**self.vis_item(arr), "vid_id": vid_id}

    def gt_matrix(self) -> np.ndarray:
        """(n_videos, n_captions) bool ground-truth matrix."""
        vid_pos = {v: i for i, v in enumerate(self.video_ids)}
        gt = np.zeros((len(self.video_ids), len(self.datalist)), bool)
        for d in self.datalist:
            gt[vid_pos[d["vid_id"]], d["id"]] = True
        return gt

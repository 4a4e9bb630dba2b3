# Copied from clipbert_tpu/data/datasets.py (the eval parts of BaseDataset and _retry_indices; VideoRetrievalTrainDataset, VideoRetrievalEvalDataset, RetrievalCollator, MSRVTTMCEvalDataset, VideoQACollator; VideoQADataset and VQADataset in eval form; the annotation loaders): JAX-free host code.
"""Datasets and collators (numpy, host-side).

Capability match for the reference's `src/datasets/dataset_*.py`, the
parts retrieval training and inference run:

 - :class:`BaseDataset` — media store read + decode + resize/pad
   (dataset_base.py:165-273), uint8 NHWC out; image loads
   (dataset_base.py:207-226); extreme-aspect-ratio skip
   (dataset_base.py:228-233), multi-clip ensemble loads with prev-clip
   fallback (dataset_video_qa.py:49-81).
 - :class:`VideoRetrievalTrainDataset` — one video's random clips with its
   caption and ``itm_neg_size`` random negative captions, all drawn from
   the item's own generator (dataset_video_retrieval.py:13-102).
 - :class:`VideoRetrievalEvalDataset` — per-video items scored against the
   full caption list (dataset_video_retrieval.py:174-250).
 - :class:`MSRVTTMCEvalDataset` — 5 options per video
   (dataset_video_retrieval.py:253-325).
 - :class:`VideoQADataset` — MC (question+option concat) and open-ended
   (ans2label) items with the TGIF / MSRVTT-QA metrics
   (dataset_video_qa.py:11-183), eval form.
 - :class:`VQADataset` — soft VQA targets + the VQA-score metric
   (dataset_vqa.py:8-112), eval form.

An eval item whose visual does not decode becomes black frames, never
another item (its question ids would replace this one's in the results).
The pretraining, video-QA and VQA train datasets wait for later slices of
the port.
"""

from __future__ import annotations

import logging
import random
import threading
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from clipbert_tpu_torch.data import transforms, video
from clipbert_tpu_torch.data.store import MediaStore
from clipbert_tpu_torch.data.tokenization import BertTokenizer

LOGGER = logging.getLogger(__name__)


def flat_list_of_lists(lst):
    return [item for sub in lst for item in sub]


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
        # __getitem__ runs concurrently in DataLoader worker threads and
        # numpy Generators are NOT thread-safe: every item gets its own
        # generator spawned from (seed, index, call#). The GIL makes the
        # counter increment atomic.
        import itertools
        self._calls = itertools.count()
        self.rng = np.random.default_rng(seed)  # init-time / single-thread use
        # eval items that fell back to black frames (eval_fallback_frames);
        # loader threads count them concurrently, under the lock
        self.n_fallbacks = 0
        self._fallback_lock = threading.Lock()

    def item_rng(self, index: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence(entropy=self.seed,
                                   spawn_key=(index, next(self._calls))))

    def __len__(self):
        return len(self.datalist)

    def load_image(self, img_id) -> Optional[np.ndarray]:
        """(1, S, S, 3) uint8, resized longer-side->S, padded bottom/right
        (dataset_base.py:207-226)."""
        raw = self.store.get(str(img_id))
        if raw is None:
            return None
        try:
            import io
            from PIL import Image
            img = Image.open(io.BytesIO(raw))
            arr = np.asarray(img.convert("RGB"), np.uint8)[None]  # (1,H,W,3)
        except Exception:
            return None
        if self.device_preprocess:
            return arr
        arr = transforms.resize_frames(arr, self.max_img_size)
        return transforms.pad_frames(arr, self.max_img_size, self.max_img_size)

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

    def _retry_indices(self, index: int, n: int = 3, rng=None):
        """index then random resamples (dataset_pretrain.py:46-59)."""
        rng = rng if rng is not None else self.rng
        yield index
        for _ in range(n - 1):
            yield int(rng.integers(0, len(self)))


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


class VideoRetrievalTrainDataset(BaseDataset):
    """datalist: list of (vid_id, [ {"txt": str, "id": int}, ... ])."""

    def __init__(self, *args, itm_neg_size: int = 1, ensemble_n_clips: int = 1,
                 random_sample_clips: bool = True, **kw):
        super().__init__(*args, **kw)
        self.itm_neg_size = itm_neg_size
        self.ensemble_n_clips = ensemble_n_clips
        self.random_sample_clips = random_sample_clips

    def __getitem__(self, index: int) -> Dict[str, Any]:
        rng = self.item_rng(index)
        for idx in self._retry_indices(index, rng=rng):
            vid_id, examples = self.datalist[idx]
            arr = self.load_video_multi_clips(
                vid_id, self.ensemble_n_clips, self.random_sample_clips,
                rng=rng)
            if arr is not None:
                break
        else:
            raise RuntimeError(f"failed to load video for index {index}")
        sampled = []
        for e in examples:
            sampled.append({"text_str": e["txt"], "itm_label": 1})
            for _ in range(self.itm_neg_size):
                sampled.append({"text_str": self._random_negative(idx, rng),
                                "itm_label": 0})
        return {**self.vis_item(arr), "examples": sampled}

    def _random_negative(self, gt_index: int, rng) -> str:
        gt_id, _ = self.datalist[gt_index]
        neg_id = gt_id
        while neg_id == gt_id:
            neg_index = int(rng.integers(0, len(self)))
            neg_id, neg_examples = self.datalist[neg_index]
        pick = int(rng.integers(0, len(neg_examples)))
        return neg_examples[pick]["txt"]


class RetrievalCollator:
    """Also serves video-QA open-ended and MC (with prejoined texts)."""

    def __init__(self, tokenizer: BertTokenizer, max_length: int = 40):
        self.tokenizer = tokenizer
        self.max_length = max_length

    def __call__(self, batch: List[Dict]) -> Dict[str, np.ndarray]:
        visual, src_hw = transforms.collate_visual(batch)
        examples = flat_list_of_lists([d["examples"] for d in batch])
        enc = self.tokenizer.batch_encode(
            [e["text_str"] for e in examples], self.max_length)
        out = {
            "visual_inputs": visual,
            "text_input_ids": enc["input_ids"],
            "text_input_mask": enc["attention_mask"],
        }
        if src_hw is not None:
            out["visual_src_hw"] = src_hw
        if "itm_label" in examples[0]:
            out["labels"] = np.asarray([e["itm_label"] for e in examples],
                                       np.int32)
        elif examples[0].get("label") is not None:
            out["labels"] = np.asarray([e["label"] for e in examples])
        if "question_id" in examples[0]:
            out["question_ids"] = [e["question_id"] for e in examples]
        return out


class MSRVTTMCEvalDataset(BaseDataset):
    """datalist: list of dicts {"id", "vid_id", "options": [5 str],
    "answer": int} (dataset_video_retrieval.py:253-325)."""

    def __init__(self, datalist, *args, ensemble_n_clips: int = 1, **kw):
        super().__init__(datalist, *args, **kw)
        self.ensemble_n_clips = ensemble_n_clips
        self.id2answer = {d["id"]: int(d["answer"]) for d in datalist}

    def __getitem__(self, index: int) -> Dict[str, Any]:
        item = self.datalist[index]
        arr = self.load_video_multi_clips(item["vid_id"],
                                          self.ensemble_n_clips,
                                          random_clips=False,
                                          prev_clip_fallback=True)
        if arr is None:
            arr = self.eval_fallback_frames(
                item["vid_id"], self.ensemble_n_clips * self.num_frm)
        return {**self.vis_item(arr),
                "examples": [{"text_str": o, "question_id": item["id"]}
                             for o in item["options"]]}

    def evaluate_qa_accuracy(self, pred_id2answer: Dict,
                             force_same: bool = True) -> Dict:
        gt_ids = list(self.id2answer)
        if force_same:
            assert set(gt_ids) == set(pred_id2answer)
            shared = gt_ids
        else:
            shared = list(pred_id2answer)
        gts = np.array([self.id2answer[k] for k in shared])
        preds = np.array([pred_id2answer[k] for k in shared])
        return {"mc_accuracy": float(np.mean(gts == preds))}


# ---------------------------------------------------------------------------
# video QA
# ---------------------------------------------------------------------------

OPEN_ENDED_QA = ("frameqa", "msrvtt_qa")

ANSWER_TYPE2IDX = dict(
    frameqa={"object": 0, "number": 1, "color": 2, "location": 3},
    msrvtt_qa={k: i for i, k in enumerate(
        ["what", "who", "how", "where", "when"])},
)


def _eval_only(is_train: bool, name: str) -> None:
    if is_train:
        raise ValueError(f"{name}: only the eval form is ported; training "
                         "datasets wait for the training slice of the port")


class VideoQADataset(BaseDataset):
    """datalist: list of (vid_id, [ {"question", "question_id", "answer",
    "options"?, "answer_type"?}, ... ]) (dataset_video_qa.py:11-128).
    Eval form: ``is_train`` must be False."""

    def __init__(self, task_type: str, datalist, *args,
                 ans2label: Optional[Dict] = None, ensemble_n_clips: int = 1,
                 return_label: bool = True, is_train: bool = True,
                 random_sample_clips: bool = True, n_options: int = 5, **kw):
        _eval_only(is_train, "VideoQADataset")
        super().__init__(datalist, *args, **kw)
        self.task_type = task_type
        self.ans2label = ans2label or {}
        self.label2ans = {v: k for k, v in self.ans2label.items()}
        self.ensemble_n_clips = ensemble_n_clips
        self.return_label = return_label
        self.is_train = is_train
        self.random_sample_clips = random_sample_clips
        self.n_options = n_options
        self.qid2data = {d["question_id"]: d
                         for _, group in datalist for d in group}

    def __getitem__(self, index: int) -> Dict[str, Any]:
        rng = self.item_rng(index)
        # eval: NEVER substitute another item (its question_ids would
        # replace this one's in the results) — degrade to black frames
        # like the retrieval eval datasets (dataset_video_qa.py:59-64)
        vid_id, examples = self.datalist[index]
        arr = self.load_video_multi_clips(
            vid_id, self.ensemble_n_clips, random_clips=False,
            prev_clip_fallback=True, rng=rng)
        if arr is None:
            arr = self.eval_fallback_frames(
                vid_id, self.ensemble_n_clips * self.num_frm)
        out = []
        for e in examples:
            ex = {"question_id": e["question_id"], "label": e["answer"]}
            if self.task_type in ("action", "transition"):
                # question + option concat (VideoQACollator, :201-205)
                ex["texts"] = [e["question"] + " " + e["options"][i]
                               for i in range(self.n_options)]
            else:
                ex["texts"] = [e["question"]]
                if self.return_label:
                    ex["label"] = self.ans2label[e["answer"]]
            if not self.return_label:
                ex["label"] = -1
            out.append(ex)
        return {**self.vis_item(arr), "examples": out}

    def evaluate_tgif_qa(self, results: List[Dict]) -> Dict:
        """results: [{"question_id", "answer"(idx)}] (dataset_video_qa.py:131-183)."""
        qid2pred = {r["question_id"]: r["answer"] for r in results}
        if self.task_type in OPEN_ENDED_QA:
            qid2pred = {k: self.label2ans[v] for k, v in qid2pred.items()}
        preds, gts, ans_types = [], [], []
        for qid, pred in qid2pred.items():
            gt_data = self.qid2data[qid]
            preds.append(pred)
            gts.append(gt_data["answer"])
            if self.task_type in OPEN_ENDED_QA:
                ans_types.append(
                    ANSWER_TYPE2IDX[self.task_type][gt_data["answer_type"]])
        preds, gts = np.array(preds), np.array(gts)
        metrics = {"overall_acc": float(np.mean(preds == gts))}
        if self.task_type in OPEN_ENDED_QA:
            ans_types = np.array(ans_types)
            ratios = {}
            for name, tid in ANSWER_TYPE2IDX[self.task_type].items():
                m = ans_types == tid
                corr = preds[m] == gts[m]
                metrics[f"{name}_acc"] = float(np.mean(corr)) if len(corr) else 0
                ratios[f"{name}_ratio"] = [len(corr) / len(ans_types),
                                           int(len(corr))]
            metrics["ratios"] = ratios
        return metrics


class VideoQACollator:
    def __init__(self, tokenizer: BertTokenizer, max_length: int = 20):
        self.tokenizer = tokenizer
        self.max_length = max_length

    def __call__(self, batch: List[Dict]) -> Dict[str, np.ndarray]:
        visual, src_hw = transforms.collate_visual(batch)
        examples = flat_list_of_lists([d["examples"] for d in batch])
        texts = flat_list_of_lists([e["texts"] for e in examples])
        enc = self.tokenizer.batch_encode(texts, self.max_length)
        out = {
            "visual_inputs": visual,
            "text_input_ids": enc["input_ids"],
            "text_input_mask": enc["attention_mask"],
            "labels": np.asarray([e["label"] for e in examples], np.int32),
            "question_ids": [e["question_id"] for e in examples],
        }
        if src_hw is not None:
            out["visual_src_hw"] = src_hw
        return out


# ---------------------------------------------------------------------------
# VQA (image)
# ---------------------------------------------------------------------------

class VQADataset(BaseDataset):
    """datalist: list of (img_id, [ {"txt", "question_id",
    "labels"? {ans: score}, "answer_type"?}, ... ]) (dataset_vqa.py:8-72).
    Eval form: ``is_train`` must be False."""

    def __init__(self, datalist, *args, ans2label: Optional[Dict] = None,
                 is_train: bool = False, **kw):
        _eval_only(is_train, "VQADataset")
        super().__init__(datalist, *args, **kw)
        self.ans2label = ans2label or {}
        self.num_labels = len(self.ans2label)
        self.label2ans = {v: k for k, v in self.ans2label.items()}
        self.is_train = is_train
        self.qid2data = {d["question_id"]: d
                         for _, group in datalist for d in group}

    def __getitem__(self, index: int) -> Dict[str, Any]:
        img_id, examples = self.datalist[index]
        arr = self.load_image(img_id)
        if arr is None:
            # eval: degrade-don't-die (matches the video eval datasets):
            # a missing or corrupt image scores ~chance instead of
            # killing the run; never resample here (its question_ids
            # would replace this one's in the results)
            arr = self.eval_fallback_frames(img_id, 1)
        out = []
        for e in examples:
            ex = {"text_str": e["txt"], "question_id": e["question_id"]}
            if "labels" in e and e["labels"] is not None:
                ex["label"] = self.vqa_targets(e["labels"])
            out.append(ex)
        return {**self.vis_item(arr), "examples": out}

    def vqa_targets(self, ans2score: Dict[str, float]) -> np.ndarray:
        """Soft target scatter (dataset_vqa.py:57-72)."""
        targets = np.zeros(self.num_labels, np.float32)
        for ans, score in ans2score.items():
            targets[self.ans2label[ans]] = score
        return targets

    def evaluate_vqa(self, results: List[Dict]) -> Dict:
        """results: [{"question_id", "answer"(str)}] (dataset_vqa.py:74-112)."""
        type2idx = {"yes/no": 0, "number": 1, "other": 2}
        scores, ans_types = [], []
        for r in results:
            raw = self.qid2data[r["question_id"]]
            scores.append(raw["labels"].get(r["answer"], 0.0))
            ans_types.append(type2idx[raw["answer_type"]])
        scores = np.array(scores)
        ans_types = np.array(ans_types)
        metrics = {"overall_acc": float(np.mean(scores))}
        ratios = {}
        for name, tid in type2idx.items():
            m = ans_types == tid
            metrics[f"{name}_acc"] = float(np.mean(scores[m])) if m.any() else 0
            ratios[f"{name}_ratio"] = [float(m.mean()), int(m.sum())]
        metrics["ratios"] = ratios
        return metrics


# ---------------------------------------------------------------------------
# annotation loading (what the runners build their datalists from)
# ---------------------------------------------------------------------------

def load_jsonl(path: str) -> List[Dict]:
    import json
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def group_datalist_by_visual(raw: Sequence[Dict], vis_key: str = "vid_id"
                             ) -> Dict[str, List[Dict]]:
    """{vis_id: [examples]} (the runners' defaultdict grouping, e.g.
    run_video_qa.py:46-58)."""
    grouped: Dict[str, List[Dict]] = {}
    for d in raw:
        grouped.setdefault(str(d[vis_key]), []).append(d)
    return grouped


def apply_data_ratio(datalist: List, data_ratio: float,
                     seed: int = 42) -> List:
    """--data_ratio subset knob (config.py:49-52,
    run_video_retrieval.py:51-54)."""
    if data_ratio >= 1.0:
        return datalist
    n = int(len(datalist) * data_ratio)
    rng = random.Random(seed)
    idx = rng.sample(range(len(datalist)), n)
    return [datalist[i] for i in sorted(idx)]

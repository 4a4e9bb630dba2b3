"""Serving path: resident single-query scorers (port of
clipbert_tpu/serve.py: the retrieval, VQA and video-QA tasks).

 - :class:`RetrievalScorer`: the model resident on one device with the
   frozen-BN scales folded; per query: decode -> device resize/pad/normalize
   -> cached visual encode -> joint scoring -> LSE clip pooling + softmax.
   Caption counts pad up to power-of-two buckets (as the JAX scorer's static
   shapes do) and native frames pad up to 64 px buckets.
 - :class:`VQAScorer`: one image, top-k answers per question (sigmoid over
   a bce head, softmax over a ce head).
 - :class:`VideoQAScorer`: one video, top-k answers per question for the
   open-ended tasks (frameqa, msrvtt_qa) and option probabilities for the
   multiple-choice ones (action, transition), clip-pooled as the eval does.
 - a stdlib JSON-over-HTTP endpoint (``python -m clipbert_tpu_torch.serve
   --task {retrieval,vqa,action,transition,frameqa,msrvtt_qa}``):
   POST /score, /vqa, /videoqa and /videoqa_mc.

On a CUDA device the scoring step runs the hand-written fused attention
kernel (ops/fused_attention.py) and the encode runs the CNN's kernel form
(ops/fused_stem_pool.py, ops/matmul_bn_act.py). ``--device`` defaults to cuda and there is
no CPU fallback: a missing card is an error.

One CUDA graph per bucket (the JAX scorers' one compiled program per
bucket, clipbert_tpu/serve.py:9-15): on a CUDA device each scorer captures
the encode of each 64 px collate bucket of (h, w) and the scoring call of
each text bucket (utils/cuda_graphs.py), at ``warmup`` or on a bucket's
first request; a request copies its inputs into the graph's static
buffers, replays the graph and copies the result out. ``cuda_graphs=False``
runs every call eagerly (the comparisons); True on a CPU device raises.
The results are the eager calls', bit for bit.

Ownership: a scorer owns its model. BN folding, quantization and the move
to ``device`` happen in place at construction, and the graphs record the
parameters' addresses: replacing a parameter or a module of the model
afterwards (quantize_scoring_params on a model another scorer captured
with, say) fails that scorer's next request; it is never read stale.

Thread-safety: the threaded HTTP server calls a scorer concurrently. The
model and the tokenizer are read-only after __init__, but the graphs'
static inputs and outputs are shared, mutable buffers: each scorer's lock
serializes a request's copy-in, replays and copy-out (decode and
tokenization run outside it), so a response never reads another request's
buffers. Tensors the scorer returns (``encode_frames``) are copies.
"""

from __future__ import annotations

import base64
import binascii
import functools
import json
import logging
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from clipbert_tpu_torch.core.config import ModelConfig
from clipbert_tpu_torch.data import transforms, video
from clipbert_tpu_torch.data.tokenization import BertTokenizer
from clipbert_tpu_torch.models import clipbert
from clipbert_tpu_torch.train import steps
from clipbert_tpu_torch.utils.cuda_graphs import BucketGraphs

LOGGER = logging.getLogger(__name__)


def _pow2_bucket(n: int, cap: int) -> int:
    """Smallest power of two >= n (floor 4, capped)."""
    b = 4
    while b < n:
        b *= 2
    return min(b, cap)


def _topk_answers(probs: np.ndarray, label2ans: Dict[int, str],
                  top_k: int) -> List[List[Dict]]:
    """(n, num_labels) probabilities -> per-row top-k
    [{"answer", "score"}], best first."""
    k = min(top_k, probs.shape[1])
    out = []
    for row in probs:
        top = np.argsort(-row)[:k]
        out.append([{"answer": label2ans.get(int(i), str(int(i))),
                     "score": float(row[i])} for i in top])
    return out


def _text_buckets(cap: int) -> List[int]:
    """Every power-of-two text-count bucket a scorer can see (4..cap),
    largest first: warmed in that order, the smaller buckets' graphs reuse
    the largest one's memory in the scorer's pool."""
    out = [min(4, cap)]
    while out[-1] < cap:
        out.append(min(2 * out[-1], cap))
    return out[::-1]


def _round_to_collate_bucket(frames: np.ndarray) -> np.ndarray:
    """Zero-pad native frames up to the 64 px collate granularity
    (transforms._BUCKET); the real (h, w) rides separately in src_hw."""
    h, w = frames.shape[1:3]
    B = transforms._BUCKET
    hb, wb = -(-h // B) * B, -(-w // B) * B
    if (hb, wb) == (h, w):
        return frames
    buf = np.zeros(frames.shape[:1] + (hb, wb) + frames.shape[3:],
                   frames.dtype)
    buf[:, :h, :w] = frames
    return buf


def _host_frames(frames: np.ndarray, max_img_size: int):
    """(T, H, W, 3) uint8 native frames -> the host inputs of the device
    preprocess: the (1, T, Hb, Wb, 3) collate-bucket buffer and the (1, 4)
    src_hw [h, w, resized h, resized w]."""
    h, w = frames.shape[1:3]
    nh, nw = transforms.get_resize_size(h, w, max_img_size)
    return (np.ascontiguousarray(_round_to_collate_bucket(frames)[None]),
            np.array([[h, w, nh, nw]], np.int64))


def _encode_key(frames: np.ndarray):
    """The encode graph of a (1, T, Hb, Wb, 3) collate-bucket buffer."""
    return ("encode",) + frames.shape[2:4]


def _text_key(ids: np.ndarray):
    """The scoring graph of (bucket, max_txt_len) padded texts."""
    return ("text", ids.shape[0])


def _pad_texts(tokenizer: BertTokenizer, texts: Sequence[str],
               max_txt_len: int, bucket: int):
    """Tokenize + zero-pad the text count up to the bucket (padded rows are
    all-zero ids/mask and are sliced off by the caller): host (bucket,
    max_txt_len) int64 ids and mask."""
    enc = tokenizer.batch_encode(list(texts), max_txt_len)
    ids = np.zeros((bucket, max_txt_len), np.int64)
    mask = np.zeros((bucket, max_txt_len), np.int64)
    ids[:len(texts)] = enc["input_ids"]
    mask[:len(texts)] = enc["attention_mask"]
    return ids, mask


def _prepare_model(model: clipbert.ClipBert, fold_bn: bool, device,
                   quantize: bool = False) -> clipbert.ClipBert:
    """Scorer preamble, in place: fold the frozen-BN scales into the conv
    weights, optionally int8-quantize the transformer's denses
    (clipbert.quantize_scoring_params: a memory option; its speed on the
    card is in PERF.md, and on the TPU it was 31% slower end to end, the
    JAX serve.py notes), move the model to ``device``, inference mode."""
    if fold_bn:
        clipbert.fold_cnn_bn_scales(model)
    if quantize:
        clipbert.quantize_scoring_params(model)
    return model.to(device).eval().requires_grad_(False)


def _check_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda requested but CUDA is not available")
    return device


def _graphs_on(cuda_graphs: Optional[bool], device: torch.device) -> bool:
    """``cuda_graphs=None``: graphs on a CUDA device, eager elsewhere."""
    if cuda_graphs is None:
        return device.type == "cuda"
    if cuda_graphs and device.type != "cuda":
        raise ValueError(f"cuda_graphs=True needs a CUDA device, not "
                         f"{device}")
    return cuda_graphs


def _load_checkpoint(model_config_path: str, e2e_weights_path: str,
                     head: str, device, **cfg_kw):
    """(model, model config) from a deploy checkpoint (.npz in the JAX key
    scheme, written by either package) or a reference e2e state_dict
    (.pt), through the standard import path (train/trainer.py::
    setup_model), as the JAX scorers' from_checkpoint does: a BGR-trained
    stem is flipped there, once. The load is strict: a checkpoint that
    lacks a leaf of the served model (its head) or holds one at another
    shape raises, where the JAX scorers keep a random init."""
    from clipbert_tpu_torch.core.config import RunConfig
    from clipbert_tpu_torch.train import trainer
    model_cfg = ModelConfig.from_json(model_config_path, **cfg_kw)
    run_cfg = RunConfig(model_config=model_config_path,
                        e2e_weights_path=e2e_weights_path)
    model = trainer.setup_model(run_cfg, model_cfg, head,
                                _check_device(device), strict=True)
    return model, model_cfg


class _Scorer:
    """What the three scorers share: the model they own on one device, the
    encode (host frames -> collate bucket -> device resize / pad /
    normalize -> CNN), the padded texts, and each call run as the replay
    of its bucket's CUDA graph (or eagerly). Subclasses set the task's
    settings, ``_step`` (the scoring step) and ``_features``."""

    def _setup(self, model, model_cfg, tokenizer, device, max_img_size,
               max_txt_len, mean, std, compute_dtype, fold_bn, quantize,
               use_kernels, cuda_graphs) -> None:
        self.device = _check_device(device)
        self.model = _prepare_model(model, fold_bn, self.device, quantize)
        self.model_cfg = model_cfg
        self.tokenizer = tokenizer
        self.max_img_size = max_img_size
        self.max_txt_len = max_txt_len
        self.mean, self.std = mean, std
        self.compute_dtype = compute_dtype
        self._encode = steps.make_visual_encode_step(compute_dtype,
                                                     use_kernels)
        self._graphs = BucketGraphs(self.device, self.model,
                                    _graphs_on(cuda_graphs, self.device))

    def _encode_device(self, frames: torch.Tensor,
                       src_hw: torch.Tensor) -> torch.Tensor:
        """The encode graph's body: device uint8 collate-bucket frames and
        src_hw -> grid features."""
        return self._features(transforms.resize_pad_normalize(
            frames, src_hw, self.max_img_size, self.mean, self.std,
            self.compute_dtype))

    def encode_frames(self, frames: np.ndarray) -> torch.Tensor:
        """(T, H, W, 3) uint8 frames -> grid features on the scorer's
        device, a tensor of the caller's (never a graph's buffer)."""
        host = _host_frames(frames, self.max_img_size)
        with self._graphs.locked():
            feats = self._graphs.run(_encode_key(host[0]),
                                     self._encode_device, *host)
            return feats.clone() if self._graphs.enabled else feats

    def _call(self, frames: Optional[np.ndarray],
              features: Optional[torch.Tensor], texts: Sequence[str],
              bucket: int) -> torch.Tensor:
        """One request's device work: the encode of host ``frames``
        (unless ``features`` are given), then the scoring step on the texts
        padded to ``bucket``. Returns the step's output on the host."""
        ids, mask = _pad_texts(self.tokenizer, texts, self.max_txt_len,
                               bucket)
        host = None if features is not None else _host_frames(
            frames, self.max_img_size)
        with self._graphs.locked():
            if features is None:
                features = self._graphs.run(_encode_key(host[0]),
                                            self._encode_device, *host)
            out = self._graphs.run(_text_key(ids),
                                   functools.partial(self._step, self.model),
                                   features, ids, mask)
            return out.cpu()

    def _warm_encode(self, sample_hws, frames: int
                     ) -> Optional[torch.Tensor]:
        """The encode of each listed (h, w)'s bucket, on zero frames;
        returns the last one's features."""
        feats = None
        for h, w in sample_hws:
            feats = self.encode_frames(np.zeros((frames, h, w, 3), np.uint8))
        return feats

    def _mark_warm(self, what: str) -> None:
        self._graphs.warm = True
        LOGGER.info(f"{type(self).__name__} warm: {what} ready"
                    + (f" ({len(self._graphs)} CUDA graphs)"
                       if self._graphs.enabled else ""))


class _ResidentVideoScorer(_Scorer):
    """Decode -> device resize -> cached CNN encode, shared by resident
    video scorers. Subclasses set: n_clips, num_frm, fps."""

    def _decode_clips(self, video_bytes: bytes) -> Optional[np.ndarray]:
        """(n_clips*num_frm, H, W, 3) uint8, uniform clip ensemble (the eval
        protocol), one probe + one decode pass over the blob."""
        return video.decode_multi_clips(
            video_bytes, num_frames=self.num_frm, target_fps=self.fps,
            num_clips=self.n_clips, random_clips=False)

    def _frames(self, video_bytes: bytes) -> np.ndarray:
        frames = self._decode_clips(video_bytes)
        if frames is None:
            raise ValueError("undecodable video payload")
        return frames

    def _features(self, pixels: torch.Tensor) -> torch.Tensor:
        """(1, n_clips*num_frm, S, S, 3) pixels -> (1, n_clips, num_frm,
        Hg, Wg, D) grid features."""
        pixels = pixels.reshape((self.n_clips, self.num_frm)
                                + pixels.shape[2:])
        feats = self._encode(self.model, pixels)
        return feats.reshape((1,) + feats.shape)

    def encode_video(self, video_bytes: bytes) -> torch.Tensor:
        """Decode + :meth:`encode_frames`. Reuse the features across many
        score() calls via ``features=``."""
        return self.encode_frames(self._frames(video_bytes))


class RetrievalScorer(_ResidentVideoScorer):
    """Resident single-video scorer (retrieval/ce head).

    score(video_bytes, captions) -> per-caption positive-class
    probabilities, pooled over ``n_clips`` uniform clips by
    ``score_agg_func``: the eval-protocol math.

    The scorer takes ownership of ``model``: BN folding and the move to
    ``device`` happen in place. ``use_kernels`` picks the CNN's form
    (models/resnet.py::resnet50_forward); None runs the kernel form on a
    CUDA device. ``quantize`` int8-quantizes the transformer's denses
    (:func:`_prepare_model`). ``cuda_graphs`` (None: on a CUDA device)
    replays one CUDA graph per encode and caption bucket.
    """

    def __init__(self, model: clipbert.ClipBert, model_cfg: ModelConfig,
                 tokenizer: BertTokenizer, *, device: torch.device | str,
                 num_frm: int = 2, n_clips: int = 1, fps: float = 1.0,
                 max_img_size: int = 448, max_txt_len: int = 20,
                 max_captions: int = 32, score_agg_func: str = "lse",
                 mean=transforms.IMAGENET_MEAN_255,
                 std=transforms.IMAGENET_STD_1,
                 compute_dtype=torch.bfloat16, fold_bn: bool = True,
                 use_kernels: Optional[bool] = None,
                 quantize: bool = False,
                 cuda_graphs: Optional[bool] = None):
        self._setup(model, model_cfg, tokenizer, device, max_img_size,
                    max_txt_len, mean, std, compute_dtype, fold_bn,
                    quantize, use_kernels, cuda_graphs)
        self.num_frm = num_frm
        self.n_clips = n_clips
        self.fps = fps
        self.max_captions = max_captions
        self.score_agg_func = score_agg_func
        ts = steps.TaskSettings(head_type="retrieval",
                                loss_type=model_cfg.loss_type,
                                score_agg_func=score_agg_func)
        self._step = steps.make_text_prob_step(model_cfg, ts, compute_dtype)

    @classmethod
    def from_checkpoint(cls, model_config_path: str, tokenizer_dir: str,
                        e2e_weights_path: str, *, device, **kw
                        ) -> "RetrievalScorer":
        """Load a deploy checkpoint (.npz) or a reference .pt through the
        standard import path (trainer.setup_model)."""
        model, model_cfg = _load_checkpoint(model_config_path,
                                            e2e_weights_path,
                                            "retrieval", device,
                                            num_labels=2, loss_type="ce")
        tok = BertTokenizer.from_dir(tokenizer_dir)
        return cls(model, model_cfg, tok, device=device, **kw)

    def score(self, video_bytes: Optional[bytes], captions: Sequence[str],
              features: Optional[torch.Tensor] = None) -> np.ndarray:
        """Per-caption positive probabilities (len(captions),)."""
        if not captions:
            raise ValueError("need at least one caption")
        if len(captions) > self.max_captions:
            raise ValueError(
                f"{len(captions)} captions > max_captions="
                f"{self.max_captions}; raise max_captions at construction "
                "or chunk the query")
        frames = None if features is not None else self._frames(video_bytes)
        n = len(captions)
        probs = self._call(frames, features, captions,
                           _pow2_bucket(n, self.max_captions))
        return probs[0, :n].numpy()

    def warmup(self, sample_hws=((240, 320),)) -> None:
        """Capture (or, eagerly, run once) the encode of each listed
        (h, w)'s 64 px bucket and the scoring call of each caption bucket
        before taking traffic; a request in an unlisted bucket captures
        its graph on first arrival."""
        feats = self._warm_encode(sample_hws,
                                   self.n_clips * self.num_frm)
        for b in _text_buckets(self.max_captions):
            self.score(None, ["warmup"] * b, features=feats)
        self._mark_warm("encode + caption buckets")


class VQAScorer(_Scorer):
    """Resident single-image question answering (the VQA task family).

    answer(image_bytes, questions) -> per-question top-k (answer, score)
    over the ans2label vocabulary with the task protocol's math: sigmoid
    over a bce multi-label head (run_vqa.py:347-356), softmax over a ce
    head. Question counts pad up to power-of-two buckets, images up to 64
    px buckets. The scorer takes ownership of ``model`` as
    RetrievalScorer does. ``use_kernels`` picks the CNN's form and
    ``fused_attn`` the attention core (None: the kernels on a CUDA
    device); ``cuda_graphs`` as in RetrievalScorer."""

    def __init__(self, model: clipbert.ClipBert, model_cfg: ModelConfig,
                 tokenizer: BertTokenizer, label2ans: Dict[int, str], *,
                 device: torch.device | str, max_img_size: int = 448,
                 max_txt_len: int = 20, max_questions: int = 32,
                 mean=transforms.IMAGENET_MEAN_255,
                 std=transforms.IMAGENET_STD_1,
                 compute_dtype=torch.bfloat16, fold_bn: bool = True,
                 use_kernels: Optional[bool] = None,
                 fused_attn: Optional[bool] = None,
                 quantize: bool = False,
                 cuda_graphs: Optional[bool] = None):
        self._setup(model, model_cfg, tokenizer, device, max_img_size,
                    max_txt_len, mean, std, compute_dtype, fold_bn,
                    quantize, use_kernels, cuda_graphs)
        self.label2ans = {int(k): v for k, v in label2ans.items()}
        self.max_questions = max_questions
        ts = steps.TaskSettings(head_type="seq_cls",
                                num_labels=model_cfg.num_labels,
                                loss_type=model_cfg.loss_type)
        self._step = steps.make_qa_answer_step(model_cfg, ts, compute_dtype,
                                               fused_attn)

    @classmethod
    def from_checkpoint(cls, model_config_path: str, tokenizer_dir: str,
                        e2e_weights_path: str, ans2label_path: str, *,
                        device, **kw) -> "VQAScorer":
        """A deploy checkpoint (.npz) or a reference .pt of a seq_cls head
        with a bce loss over the ans2label vocabulary."""
        from clipbert_tpu_torch.utils.basic import load_json
        ans2label = load_json(ans2label_path)
        model, model_cfg = _load_checkpoint(model_config_path,
                                            e2e_weights_path,
                                            "seq_cls", device,
                                            num_labels=len(ans2label),
                                            loss_type="bce")
        tok = BertTokenizer.from_dir(tokenizer_dir)
        return cls(model, model_cfg, tok,
                   {v: k for k, v in ans2label.items()}, device=device,
                   **kw)

    @staticmethod
    def _image(image_bytes: bytes) -> np.ndarray:
        """JPEG/PNG bytes -> (1, H, W, 3) uint8 pixels."""
        import io
        from PIL import Image
        try:
            img = Image.open(io.BytesIO(image_bytes))
            return np.asarray(img.convert("RGB"), np.uint8)[None]
        except Exception as e:
            raise ValueError(f"undecodable image payload: {e}") from None

    def _features(self, pixels: torch.Tensor) -> torch.Tensor:
        """(1, 1, S, S, 3) pixels -> grid features (1, 1, Hg, Wg, D)."""
        return self._encode(self.model, pixels)

    def encode_image(self, image_bytes: bytes) -> torch.Tensor:
        """JPEG/PNG bytes -> cached grid features (1, 1, Hg, Wg, D)."""
        return self.encode_frames(self._image(image_bytes))

    def answer(self, image_bytes: Optional[bytes], questions: Sequence[str],
               top_k: int = 5, features: Optional[torch.Tensor] = None
               ) -> List[List[Dict]]:
        """Per-question top-k [{"answer", "score"}], best first."""
        return _topk_answers(self.probs(image_bytes, questions, features),
                             self.label2ans, top_k)

    def probs(self, image_bytes: Optional[bytes], questions: Sequence[str],
              features: Optional[torch.Tensor] = None) -> np.ndarray:
        """(len(questions), num_labels) answer probabilities."""
        _check_count(questions, self.max_questions, "question")
        frames = None if features is not None else self._image(image_bytes)
        n = len(questions)
        return self._call(frames, features, questions,
                          _pow2_bucket(n, self.max_questions))[:n].numpy()

    def warmup(self, sample_hws=((480, 640),)) -> None:
        """The encode of each listed (h, w)'s bucket and each question
        bucket's call before taking traffic (captured on a CUDA
        device)."""
        feats = self._warm_encode(sample_hws, 1)
        for b in _text_buckets(self.max_questions):
            self.answer(None, ["warmup"] * b, features=feats)
        self._mark_warm("encode + question buckets")


MC_QA_TASKS = ("action", "transition")
OPEN_QA_TASKS = ("frameqa", "msrvtt_qa")


class VideoQAScorer(_ResidentVideoScorer):
    """Resident single-video question answering (the video-QA task
    family, run_video_qa.py's protocol: per-clip logits pooled by
    score_agg_func).

    Open-ended tasks (frameqa / msrvtt_qa): ``answer(video_bytes,
    questions)`` -> per-question top-k (answer, score) over the ans2label
    vocabulary, softmax over the ce classifier. Multiple-choice tasks
    (action / transition): ``answer_mc(video_bytes, question, options)``
    -> per-option probabilities of the multi-choice single-logit head on
    the dataset's question + " " + option texts. The scorer takes ownership
    of ``model``; ``use_kernels``, ``fused_attn`` and ``cuda_graphs`` as in
    VQAScorer (the MC tasks capture one scoring graph, of ``n_options``
    texts)."""

    def __init__(self, model: clipbert.ClipBert, model_cfg: ModelConfig,
                 tokenizer: BertTokenizer, task: str, *,
                 device: torch.device | str,
                 label2ans: Optional[Dict[int, str]] = None,
                 num_frm: int = 2, n_clips: int = 1, fps: float = 1.0,
                 max_img_size: int = 448, max_txt_len: int = 25,
                 max_questions: int = 32, n_options: int = 5,
                 score_agg_func: str = "mean",
                 mean=transforms.IMAGENET_MEAN_255,
                 std=transforms.IMAGENET_STD_1,
                 compute_dtype=torch.bfloat16, fold_bn: bool = True,
                 use_kernels: Optional[bool] = None,
                 fused_attn: Optional[bool] = None,
                 quantize: bool = False,
                 cuda_graphs: Optional[bool] = None):
        if task not in MC_QA_TASKS + OPEN_QA_TASKS:
            raise ValueError(f"unknown video-QA task {task!r}")
        is_mc = task in MC_QA_TASKS
        if not is_mc and not label2ans:
            raise ValueError("open-ended video-QA needs label2ans")
        self._setup(model, model_cfg, tokenizer, device, max_img_size,
                    max_txt_len, mean, std, compute_dtype, fold_bn,
                    quantize, use_kernels, cuda_graphs)
        self.task = task
        self.is_mc = is_mc
        self.n_options = n_options
        self.num_frm = num_frm
        self.n_clips = n_clips
        self.fps = fps
        self.max_questions = max_questions
        if self.is_mc:
            head, labels = "multi_choice", n_options
            self.label2ans = None
        else:
            self.label2ans = {int(k): v for k, v in label2ans.items()}
            head, labels = "seq_cls", model_cfg.num_labels
        ts = steps.TaskSettings(head_type=head, num_labels=labels,
                                loss_type="ce",
                                score_agg_func=score_agg_func,
                                train_n_clips=n_clips)
        self._step = steps.make_videoqa_prob_step(model_cfg, ts,
                                                  compute_dtype, fused_attn)

    @classmethod
    def from_checkpoint(cls, model_config_path: str, tokenizer_dir: str,
                        e2e_weights_path: str, task: str, *, device,
                        ans2label_path: Optional[str] = None,
                        n_options: int = 5, **kw) -> "VideoQAScorer":
        """A deploy checkpoint (.npz) or a reference .pt: a multi_choice
        head for the MC tasks, a seq_cls head over the ans2label vocabulary
        otherwise."""
        from clipbert_tpu_torch.utils.basic import load_json
        if task in MC_QA_TASKS:
            head, label2ans, num_labels = "multi_choice", None, n_options
        else:
            if not ans2label_path:
                raise ValueError(f"open-ended task {task} needs ans2label")
            ans2label = load_json(ans2label_path)
            label2ans = {v: k for k, v in ans2label.items()}
            head, num_labels = "seq_cls", len(ans2label)
        model, model_cfg = _load_checkpoint(model_config_path,
                                            e2e_weights_path, head,
                                            device, num_labels=num_labels,
                                            loss_type="ce")
        tok = BertTokenizer.from_dir(tokenizer_dir)
        return cls(model, model_cfg, tok, task, device=device,
                   label2ans=label2ans, n_options=n_options, **kw)

    def probs(self, video_bytes: Optional[bytes], questions: Sequence[str],
              features: Optional[torch.Tensor] = None) -> np.ndarray:
        """Open-ended tasks: (len(questions), num_labels) answer
        probabilities."""
        if self.is_mc:
            raise ValueError("multiple-choice tasks answer via answer_mc()")
        _check_count(questions, self.max_questions, "question")
        frames = None if features is not None else self._frames(video_bytes)
        n = len(questions)
        return self._call(frames, features, questions,
                          _pow2_bucket(n, self.max_questions))[:n].numpy()

    def answer(self, video_bytes: Optional[bytes], questions: Sequence[str],
               top_k: int = 5, features: Optional[torch.Tensor] = None
               ) -> List[List[Dict]]:
        """Open-ended tasks: per-question top-k [{"answer", "score"}]."""
        return _topk_answers(self.probs(video_bytes, questions, features),
                             self.label2ans, top_k)

    def answer_mc(self, video_bytes: Optional[bytes], question: str,
                  options: Sequence[str],
                  features: Optional[torch.Tensor] = None) -> np.ndarray:
        """MC tasks: probabilities over the options (softmax of the
        clip-pooled per-option logits); the answer is the argmax."""
        if not self.is_mc:
            raise ValueError("open-ended tasks answer via answer()")
        if len(options) != self.n_options:
            raise ValueError(f"need exactly {self.n_options} options, got "
                             f"{len(options)}")
        frames = None if features is not None else self._frames(video_bytes)
        texts = [question + " " + o for o in options]   # the dataset's
        return self._call(frames, features, texts, self.n_options)[0].numpy()

    def warmup(self, sample_hws=((240, 320),)) -> None:
        """The encode of each listed (h, w)'s bucket and the question /
        option calls before taking traffic (captured on a CUDA device)."""
        feats = self._warm_encode(sample_hws,
                                   self.n_clips * self.num_frm)
        if self.is_mc:
            self.answer_mc(None, "warmup", ["w"] * self.n_options,
                           features=feats)
        else:
            for b in _text_buckets(self.max_questions):
                self.answer(None, ["warmup"] * b, features=feats)
        self._mark_warm("encode + question calls")


def _check_count(texts: Sequence[str], cap: int, what: str) -> None:
    if not texts:
        raise ValueError(f"need at least one {what}")
    if len(texts) > cap:
        raise ValueError(f"{len(texts)} {what}s > max_{what}s={cap}")


def make_http_server(scorer: Optional[RetrievalScorer] = None,
                     host: str = "127.0.0.1", port: int = 8477,
                     vqa: Optional[VQAScorer] = None,
                     videoqa: Optional[VideoQAScorer] = None):
    """Routes (each present iff the matching scorer was given):
    POST /score      {"video_b64", "captions"}  -> {"probs": [...]}
    POST /vqa        {"image_b64", "questions", "top_k"?}
                     -> {"answers": [[{"answer","score"}...] ...]}
    POST /videoqa    {"video_b64", "questions", "top_k"?}    (open-ended)
                     -> {"answers": [[{"answer","score"}...] ...]}
    POST /videoqa_mc {"video_b64", "question", "options"}    (MC)
                     -> {"probs": [...], "answer_index": int}
    GET  /healthz -> {"status": "ok"}. A malformed payload or a scorer's
    input check is a 400, an unknown route a 404, any other failure a 500
    whose details go to the log, not the caller."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):       # quiet; LOGGER handles app logs
            pass

        def _reply(self, code: int, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"status": "ok"})
            else:
                self._reply(404, {"error": "not found"})

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
                if self.path == "/score" and scorer is not None:
                    probs = scorer.score(
                        base64.b64decode(req["video_b64"]),
                        [str(c) for c in req["captions"]])
                    self._reply(200, {"probs": [float(p) for p in probs]})
                elif self.path == "/vqa" and vqa is not None:
                    answers = vqa.answer(
                        base64.b64decode(req["image_b64"]),
                        [str(q) for q in req["questions"]],
                        top_k=int(req.get("top_k", 5)))
                    self._reply(200, {"answers": answers})
                elif (self.path == "/videoqa" and videoqa is not None
                        and not videoqa.is_mc):
                    answers = videoqa.answer(
                        base64.b64decode(req["video_b64"]),
                        [str(q) for q in req["questions"]],
                        top_k=int(req.get("top_k", 5)))
                    self._reply(200, {"answers": answers})
                elif (self.path == "/videoqa_mc" and videoqa is not None
                        and videoqa.is_mc):
                    probs = videoqa.answer_mc(
                        base64.b64decode(req["video_b64"]),
                        str(req["question"]),
                        [str(o) for o in req["options"]])
                    self._reply(200, {
                        "probs": [float(p) for p in probs],
                        "answer_index": int(np.argmax(probs))})
                else:
                    self._reply(404, {"error": "not found"})
            except (KeyError, TypeError, ValueError, binascii.Error,
                    json.JSONDecodeError) as e:
                # malformed payload or a scorer input check
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})
            except Exception as e:      # noqa: BLE001 — serving boundary
                # device fault or scorer bug: 5xx so load balancers retry;
                # details go to the log, not the caller
                LOGGER.exception("serving request failed")
                self._reply(500, {"error": f"internal: {type(e).__name__}"})

    return ThreadingHTTPServer((host, port), Handler)


def main(argv: Optional[List[str]] = None):
    import argparse
    ap = argparse.ArgumentParser(
        description="clipbert_tpu_torch scoring server")
    ap.add_argument("--task", choices=["retrieval", "vqa"] + list(
        MC_QA_TASKS + OPEN_QA_TASKS), default="retrieval")
    ap.add_argument("--model_config", required=True)
    ap.add_argument("--tokenizer_dir", required=True)
    ap.add_argument("--e2e_weights_path", required=True,
                    help="deploy checkpoint (.npz) or reference .pt")
    ap.add_argument("--ans2label_path",
                    help="required for vqa and the open-ended video-QA "
                         "tasks")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--port", type=int, default=8477)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--n_clips", type=int, default=1)
    ap.add_argument("--num_frm", type=int, default=2)
    ap.add_argument("--fps", type=float, default=1.0)
    ap.add_argument("--max_img_size", type=int, default=448)
    ap.add_argument("--max_captions", type=int, default=32)
    ap.add_argument("--score_agg_func", default="mean",
                    help="clip pooling for the video-QA tasks")
    ap.add_argument("--warmup_resolutions", default="",
                    help="comma-separated HxW list to warm the encode path "
                         "for (e.g. '240x320,480x640')")
    ap.add_argument("--quantize", type=int, default=0,
                    help="int8-quantize the transformer's denses at load "
                         "(per-channel scales, the CNN untouched)")
    args = ap.parse_args(argv)
    quantize = bool(args.quantize)
    logging.basicConfig(level=logging.INFO)
    hws = [tuple(int(d) for d in r.split("x"))
           for r in args.warmup_resolutions.split(",") if r.strip()]
    if args.task == "vqa":
        if not args.ans2label_path:
            ap.error("--task vqa needs --ans2label_path")
        vqa = VQAScorer.from_checkpoint(
            args.model_config, args.tokenizer_dir, args.e2e_weights_path,
            args.ans2label_path, device=args.device,
            max_img_size=args.max_img_size,
            max_questions=args.max_captions, quantize=quantize)
        vqa.warmup(hws or ((480, 640),))
        server = make_http_server(None, args.host, args.port, vqa=vqa)
    elif args.task in MC_QA_TASKS + OPEN_QA_TASKS:
        videoqa = VideoQAScorer.from_checkpoint(
            args.model_config, args.tokenizer_dir, args.e2e_weights_path,
            args.task, device=args.device,
            ans2label_path=args.ans2label_path, n_clips=args.n_clips,
            num_frm=args.num_frm, fps=args.fps,
            max_img_size=args.max_img_size,
            max_questions=args.max_captions,
            score_agg_func=args.score_agg_func, quantize=quantize)
        videoqa.warmup(hws or ((240, 320),))
        server = make_http_server(None, args.host, args.port,
                                  videoqa=videoqa)
    else:
        scorer = RetrievalScorer.from_checkpoint(
            args.model_config, args.tokenizer_dir, args.e2e_weights_path,
            device=args.device, n_clips=args.n_clips, num_frm=args.num_frm,
            fps=args.fps, max_img_size=args.max_img_size,
            max_captions=args.max_captions, quantize=quantize)
        scorer.warmup(hws or ((240, 320),))
        server = make_http_server(scorer, args.host, args.port)
    LOGGER.info(f"serving on {args.host}:{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()

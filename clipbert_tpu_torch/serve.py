"""Serving path: resident single-video retrieval scoring
(port of clipbert_tpu/serve.py, the ``retrieval`` task).

 - :class:`RetrievalScorer`: the model resident on one device with the
   frozen-BN scales folded; per query: decode -> device resize/pad/normalize
   -> cached visual encode -> joint scoring -> LSE clip pooling + softmax.
   Caption counts pad up to power-of-two buckets (as the JAX scorer's static
   shapes do) and native frames pad up to 64 px buckets.
 - a stdlib JSON-over-HTTP endpoint (``python -m clipbert_tpu_torch.serve``):
   POST /score {"video_b64", "captions"} -> {"probs"}.

On a CUDA device the scoring step runs the hand-written fused attention
kernel (ops/fused_attention.py) and the encode runs the CNN's kernel form
(ops/fused_stem_pool.py, ops/matmul_bn_act.py). ``--device`` defaults to cuda and there is
no CPU fallback: a missing card is an error.

Thread-safety: after __init__ the scorer is read-only (the model is never
mutated again; the tokenizer holds read-only dicts), so the threaded HTTP
server may call it concurrently; PyTorch serializes work per CUDA stream.
"""

from __future__ import annotations

import base64
import binascii
import json
import logging
from typing import List, Optional, Sequence

import numpy as np
import torch

from clipbert_tpu_torch.core.config import ModelConfig
from clipbert_tpu_torch.data import transforms, video
from clipbert_tpu_torch.data.tokenization import BertTokenizer
from clipbert_tpu_torch.models import clipbert
from clipbert_tpu_torch.train import steps

LOGGER = logging.getLogger(__name__)


def _pow2_bucket(n: int, cap: int) -> int:
    """Smallest power of two >= n (floor 4, capped)."""
    b = 4
    while b < n:
        b *= 2
    return min(b, cap)


def _text_buckets(cap: int):
    """Every power-of-two text-count bucket a scorer can see (4..cap)."""
    b = 4
    while True:
        yield min(b, cap)
        if b >= cap:
            return
        b *= 2


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


def _device_pixels(frames: np.ndarray, max_img_size: int, mean, std, dtype,
                   device) -> torch.Tensor:
    """(T, H, W, 3) uint8 native frames -> (1, T, S, S, 3) device pixels."""
    h, w = frames.shape[1:3]
    frames = _round_to_collate_bucket(frames)
    nh, nw = transforms.get_resize_size(h, w, max_img_size)
    src_hw = np.array([[h, w, nh, nw]], np.int64)
    return transforms.device_preprocess(frames[None], src_hw, max_img_size,
                                        mean, std, dtype, device=device)


def _pad_texts(tokenizer: BertTokenizer, texts: Sequence[str],
               max_txt_len: int, bucket: int, device):
    """Tokenize + zero-pad the text count up to the bucket (padded rows are
    all-zero ids/mask and are sliced off by the caller)."""
    enc = tokenizer.batch_encode(list(texts), max_txt_len)
    ids = np.zeros((bucket, max_txt_len), np.int64)
    mask = np.zeros((bucket, max_txt_len), np.int64)
    ids[:len(texts)] = enc["input_ids"]
    mask[:len(texts)] = enc["attention_mask"]
    return (torch.from_numpy(ids).to(device),
            torch.from_numpy(mask).to(device))


def _prepare_model(model: clipbert.ClipBert, fold_bn: bool,
                   device) -> clipbert.ClipBert:
    """Scorer preamble, in place: fold the frozen-BN scales into the conv
    weights, move the model to ``device``, inference mode."""
    if fold_bn:
        clipbert.fold_cnn_bn_scales(model)
    return model.to(device).eval().requires_grad_(False)


class _ResidentVideoScorer:
    """Decode -> device resize -> cached CNN encode, shared by resident
    video scorers. Subclasses set: model, device, n_clips, num_frm, fps,
    max_img_size, mean, std, compute_dtype, _encode."""

    def _decode_clips(self, video_bytes: bytes) -> Optional[np.ndarray]:
        """(n_clips*num_frm, H, W, 3) uint8, uniform clip ensemble (the eval
        protocol), one probe + one decode pass over the blob."""
        return video.decode_multi_clips(
            video_bytes, num_frames=self.num_frm, target_fps=self.fps,
            num_clips=self.n_clips, random_clips=False)

    def encode_frames(self, frames: np.ndarray) -> torch.Tensor:
        """(n_clips*num_frm, H, W, 3) uint8 frames -> cached grid features
        (1, n_clips, num_frm, Hg, Wg, D) on the scorer's device."""
        pixels = _device_pixels(frames, self.max_img_size, self.mean,
                                self.std, self.compute_dtype, self.device)
        pixels = pixels.reshape((self.n_clips, self.num_frm)
                                + pixels.shape[2:])
        feats = self._encode(self.model, pixels)
        return feats.reshape((1,) + feats.shape)

    def encode_video(self, video_bytes: bytes) -> torch.Tensor:
        """Decode + :meth:`encode_frames`. Reuse the features across many
        score() calls via ``features=``."""
        frames = self._decode_clips(video_bytes)
        if frames is None:
            raise ValueError("undecodable video payload")
        return self.encode_frames(frames)


class RetrievalScorer(_ResidentVideoScorer):
    """Resident single-video scorer (retrieval/ce head).

    score(video_bytes, captions) -> per-caption positive-class
    probabilities, pooled over ``n_clips`` uniform clips by
    ``score_agg_func``: the eval-protocol math.

    The scorer takes ownership of ``model``: BN folding and the move to
    ``device`` happen in place. ``use_kernels`` picks the CNN's form
    (models/resnet.py::resnet50_forward); None runs the kernel form on a
    CUDA device.
    """

    def __init__(self, model: clipbert.ClipBert, model_cfg: ModelConfig,
                 tokenizer: BertTokenizer, *, device: torch.device | str,
                 num_frm: int = 2, n_clips: int = 1, fps: float = 1.0,
                 max_img_size: int = 448, max_txt_len: int = 20,
                 max_captions: int = 32, score_agg_func: str = "lse",
                 mean=transforms.IMAGENET_MEAN_255,
                 std=transforms.IMAGENET_STD_1,
                 compute_dtype=torch.bfloat16, fold_bn: bool = True,
                 use_kernels: Optional[bool] = None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device cuda requested but CUDA is not "
                               "available")
        self.model = _prepare_model(model, fold_bn, self.device)
        self.model_cfg = model_cfg
        self.tokenizer = tokenizer
        self.num_frm = num_frm
        self.n_clips = n_clips
        self.fps = fps
        self.max_img_size = max_img_size
        self.max_txt_len = max_txt_len
        self.max_captions = max_captions
        self.score_agg_func = score_agg_func
        self.mean, self.std = mean, std
        self.compute_dtype = compute_dtype
        ts = steps.TaskSettings(head_type="retrieval",
                                loss_type=model_cfg.loss_type,
                                score_agg_func=score_agg_func)
        self._encode = steps.make_visual_encode_step(compute_dtype,
                                                     use_kernels)
        self._prob = steps.make_text_prob_step(model_cfg, ts, compute_dtype)

    @classmethod
    def from_checkpoint(cls, model_config_path: str, tokenizer_dir: str,
                        e2e_weights_path: str, *, device, **kw
                        ) -> "RetrievalScorer":
        """Load a JAX deploy checkpoint (.npz, flat ``a/b/0/c`` keys)
        through the weight bridge (ckpt/from_jax.py)."""
        from clipbert_tpu_torch.ckpt.checkpoint import load_flat
        from clipbert_tpu_torch.ckpt.from_jax import load_jax_params
        if not e2e_weights_path.endswith(".npz"):
            raise ValueError(f"{e2e_weights_path}: only JAX deploy "
                             "checkpoints (.npz) load into the port")
        model_cfg = ModelConfig.from_json(model_config_path, num_labels=2,
                                          loss_type="ce")
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device cuda requested but CUDA is not "
                               "available")
        model = clipbert.empty_clipbert(model_cfg, device=device)
        load_jax_params(model, load_flat(e2e_weights_path))
        tok = BertTokenizer.from_dir(tokenizer_dir)
        return cls(model, model_cfg, tok, device=device, **kw)

    def _pad_texts(self, texts: Sequence[str], bucket: int):
        return _pad_texts(self.tokenizer, texts, self.max_txt_len, bucket,
                          self.device)

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
        if features is None:
            features = self.encode_video(video_bytes)
        n = len(captions)
        ids, mask = self._pad_texts(captions,
                                    _pow2_bucket(n, self.max_captions))
        probs = self._prob(self.model, features, ids, mask)
        return probs[0, :n].cpu().numpy()

    def warmup(self, sample_hws=((240, 320),)) -> None:
        """Run the encode path once per listed (h, w) and the scoring path
        once per caption bucket before taking traffic (cuDNN algorithm
        choice, kernel build and load)."""
        feats = None
        for h, w in sample_hws:
            frames = np.zeros((self.n_clips * self.num_frm, h, w, 3),
                              np.uint8)
            feats = self.encode_frames(frames)
        for b in _text_buckets(self.max_captions):
            self.score(None, ["warmup"] * b, features=feats)
        LOGGER.info("RetrievalScorer warm: encode + caption buckets ready")


def make_http_server(scorer: RetrievalScorer, host: str = "127.0.0.1",
                     port: int = 8477):
    """POST /score {"video_b64", "captions"} -> {"probs": [...]};
    GET /healthz -> {"status": "ok"}."""
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
                if self.path != "/score":
                    self._reply(404, {"error": "not found"})
                    return
                probs = scorer.score(base64.b64decode(req["video_b64"]),
                                     [str(c) for c in req["captions"]])
                self._reply(200, {"probs": [float(p) for p in probs]})
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
        description="clipbert_tpu_torch retrieval scoring server")
    ap.add_argument("--task", choices=["retrieval"], default="retrieval")
    ap.add_argument("--model_config", required=True)
    ap.add_argument("--tokenizer_dir", required=True)
    ap.add_argument("--e2e_weights_path", required=True,
                    help="JAX deploy checkpoint (.npz)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--port", type=int, default=8477)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--n_clips", type=int, default=1)
    ap.add_argument("--num_frm", type=int, default=2)
    ap.add_argument("--fps", type=float, default=1.0)
    ap.add_argument("--max_img_size", type=int, default=448)
    ap.add_argument("--max_captions", type=int, default=32)
    ap.add_argument("--warmup_resolutions", default="",
                    help="comma-separated HxW list to warm the encode path "
                         "for (e.g. '240x320,480x640')")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    hws = [tuple(int(d) for d in r.split("x"))
           for r in args.warmup_resolutions.split(",") if r.strip()]
    scorer = RetrievalScorer.from_checkpoint(
        args.model_config, args.tokenizer_dir, args.e2e_weights_path,
        device=args.device, n_clips=args.n_clips, num_frm=args.num_frm,
        fps=args.fps, max_img_size=args.max_img_size,
        max_captions=args.max_captions)
    scorer.warmup(hws or ((240, 320),))
    server = make_http_server(scorer, args.host, args.port)
    LOGGER.info(f"serving on {args.host}:{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()

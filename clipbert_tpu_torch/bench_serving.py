"""Serving latency: single-query video + captions scoring on one card (port
of scripts/bench_serving.py).

    python -m clipbert_tpu_torch.bench_serving [--queries 20]
        [--max_captions 16] [--sustained SECONDS] [--clients 8]
        [--quantize 0|1] [--device cuda]

Measures :class:`clipbert_tpu_torch.serve.RetrievalScorer` end to end per
query (decode -> pinned host staging -> the replay of the encode graph:
device resize, CNN -> the replay of the caption bucket's scoring graph ->
fetch) at the low-latency configuration (n_clips=1) and the quality one
(n_clips=16): full BERT-base + R50 at 448^2, bf16, random weights from a
seed. Reports p50 / p90 over --queries runs and the decode-only share, one
JSON line per configuration.

``--sustained S`` adds S seconds of --clients concurrent HTTP clients
against the 1-clip scorer, each posting its own caption set: throughput,
tail latency, every response checked against that client's serial result,
and the CUDA graphs captured after warmup, which must be 0 (the JAX
bench's zero recompiles after warmup). Needs the card; ``--device cpu``
runs the same program eagerly.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import tempfile
import threading
import time
from typing import List, Sequence

import numpy as np
import torch

from clipbert_tpu_torch.data import video
from clipbert_tpu_torch.utils import tool_run


def make_clip(rng: np.random.Generator, frames: int = 96, h: int = 240,
              w: int = 320, fps: float = 12.0) -> bytes:
    """A JSEQ blob of seeded frames (the JAX bench's clip: 96 frames of
    320x240 at 12 fps): a seeded 16 px block pattern drifting one block
    every 8 frames, which JPEG compresses as it would a real clip (a few
    KB a frame: per-pixel noise would make a request's payload ~25x
    larger, and the host's base64 and JSON work the bottleneck)."""
    grid = rng.integers(0, 256, (-(-h // 16) + 1, -(-w // 16) + frames // 8
                                 + 1, 3), np.uint8)
    out = np.empty((frames, h, w, 3), np.uint8)
    for t in range(frames):
        g = grid[:, t // 8:]
        out[t] = np.repeat(np.repeat(g, 16, 0), 16, 1)[:h, :w]
    return video.encode_jseq_from_array(out, fps=fps)


def caption_sets(clients: int, max_captions: int) -> List[List[str]]:
    """Client i's own captions: other texts and other counts per client,
    so concurrent requests land in different caption buckets."""
    return [[f"a person does thing {c} {i % 10}"
             for i in range(1 + (3 * c) % max_captions)]
            for c in range(clients)]


def sustained_load(scorer, blob: bytes, captions: Sequence[Sequence[str]],
                   seconds: float, port: int = 0) -> dict:
    """len(captions) concurrent HTTP clients, client i posting
    ``captions[i]`` with ``blob`` to /score for ~``seconds``: throughput,
    tail latency, errors, responses that differ from the client's serial
    result (``scorer.score`` before the load) and the CUDA graphs captured
    under load (utils/cuda_graphs.CAPTURES; 0 after a warmup that covered
    the requests' buckets)."""
    import base64
    import http.client

    from clipbert_tpu_torch.serve import make_http_server
    from clipbert_tpu_torch.utils import cuda_graphs

    serial = [[float(p) for p in scorer.score(blob, list(c))]
              for c in captions]
    b64 = base64.b64encode(blob).decode()
    payloads = [json.dumps({"video_b64": b64, "captions": list(c)})
                for c in captions]
    headers = {"Content-Type": "application/json"}
    server = make_http_server(scorer, port=port)
    port = server.server_address[1]
    srv_thread = threading.Thread(target=server.serve_forever, daemon=True)
    srv_thread.start()
    conns = [http.client.HTTPConnection("127.0.0.1", port, timeout=120)
             for _ in captions]

    def one_request(conn, payload):
        t0 = time.perf_counter()
        conn.request("POST", "/score", payload, headers)
        r = conn.getresponse()
        body = r.read()
        ms = (time.perf_counter() - t0) * 1e3
        probs = json.loads(body)["probs"] if r.status == 200 else None
        return r.status, ms, probs

    lock = threading.Lock()
    lat: List[float] = []
    counts = {"err": 0, "mismatch": 0}

    def client(conn, payload, want, stop_at):
        while time.monotonic() < stop_at:
            try:
                status, ms, probs = one_request(conn, payload)
            except (OSError, http.client.HTTPException, ValueError):
                conn.close()
                with lock:
                    counts["err"] += 1
                continue
            with lock:
                if status != 200:
                    counts["err"] += 1
                elif probs != want:
                    counts["mismatch"] += 1
                else:
                    lat.append(ms)

    try:
        # one request per client (its connection) before the count starts
        for conn, payload, want in zip(conns, payloads, serial):
            status, _, probs = one_request(conn, payload)
            if status != 200 or probs != want:
                raise RuntimeError(f"warm request: status {status}, "
                                   f"{probs} != serial {want}")
        captures = cuda_graphs.CAPTURES
        stop_at = time.monotonic() + seconds
        t_start = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c, p, w, stop_at))
                   for c, p, w in zip(conns, payloads, serial)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=seconds + 300)
        wall = time.perf_counter() - t_start
        if any(t.is_alive() for t in threads):
            raise RuntimeError("a load client outlived its time")
        captures = cuda_graphs.CAPTURES - captures
    finally:
        for conn in conns:
            conn.close()
        server.shutdown()
        server.server_close()
        srv_thread.join(timeout=30)

    lat_arr = np.array(lat) if lat else np.array([float("nan")])
    return {
        "qps": round(len(lat) / wall, 2),
        "p50_ms": round(float(np.percentile(lat_arr, 50)), 1),
        "p99_ms": round(float(np.percentile(lat_arr, 99)), 1),
        "n_ok": len(lat), "n_err": counts["err"],
        "n_mismatch": counts["mismatch"],
        "clients": len(captions), "seconds": round(wall, 1),
        "captures_after_warmup": captures,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--queries", type=int, default=20)
    ap.add_argument("--max_captions", type=int, default=16)
    ap.add_argument("--sustained", type=float, default=0.0,
                    help="also run a sustained-load phase of this many "
                         "seconds at the 1-clip configuration")
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--quantize", type=int, default=0,
                    help="int8-quantize the transformer's denses in the "
                         "scorer (serve.py --quantize)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from clipbert_tpu_torch.core.config import ModelConfig
    from clipbert_tpu_torch.data.tokenization import (BertTokenizer,
                                                      write_tiny_vocab)
    from clipbert_tpu_torch.models import clipbert
    from clipbert_tpu_torch.serve import RetrievalScorer

    device = torch.device(args.device)
    card = tool_run.card(device)
    with tempfile.TemporaryDirectory(prefix="serve_bench_") as tmp:
        vpath = os.path.join(tmp, "vocab.txt")
        write_tiny_vocab(vpath, extra_tokens=["a", "person", "does",
                                              "thing"]
                         + [str(i) for i in range(10)])
        tok = BertTokenizer(vpath)
    blob = make_clip(np.random.default_rng(0))
    captions = [f"a person does thing {i}" for i in range(8)]
    cfg = ModelConfig(num_labels=2, loss_type="ce", score_agg_func="lse")
    model = clipbert.init_clipbert(
        cfg, "retrieval", generator=torch.Generator(device=device)
        .manual_seed(0), device=device)
    for n_clips in (1, 16):
        # one model for both: BN folding and quantization are idempotent
        scorer = RetrievalScorer(
            model, cfg, tok, device=device, num_frm=2, n_clips=n_clips,
            fps=1, max_img_size=448, max_captions=args.max_captions,
            quantize=bool(args.quantize))
        scorer.warmup()
        t0 = time.perf_counter()
        for _ in range(args.queries):
            scorer._decode_clips(blob)
        decode_ms = (time.perf_counter() - t0) / args.queries * 1e3

        lat = []
        for _ in range(args.queries):
            t0 = time.perf_counter()
            probs = scorer.score(blob, captions)
            lat.append((time.perf_counter() - t0) * 1e3)
            if not np.isfinite(probs).all():
                raise RuntimeError(f"non-finite probabilities {probs}")
        lat = np.array(lat)
        print(json.dumps({
            "metric": f"serving_latency_ms_{n_clips}clip",
            "p50": round(float(np.percentile(lat, 50)), 1),
            "p90": round(float(np.percentile(lat, 90)), 1),
            "decode_ms": round(decode_ms, 1),
            "captions": len(captions),
            "note": f"{card}; one CUDA graph per bucket"
                    if scorer._graphs.enabled else card,
        }), flush=True)

        if args.sustained > 0 and n_clips == 1:
            stats = sustained_load(
                scorer, blob, caption_sets(args.clients, args.max_captions),
                args.sustained)
            print(json.dumps({"metric": "serving_sustained_1clip", **stats}),
                  flush=True)
            bad = {k: stats[k] for k in ("n_err", "n_mismatch",
                                         "captures_after_warmup")
                   if stats[k]}
            if bad:
                raise RuntimeError(f"sustained load: {bad} (each must be "
                                   "0: a warmed scorer serves every bucket "
                                   "from its graphs and every response "
                                   "equals its serial result)")
        del scorer
        if device.type == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

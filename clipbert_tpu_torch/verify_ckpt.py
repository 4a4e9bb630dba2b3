"""One-command released-checkpoint parity harness (port of
clipbert_tpu/verify_ckpt.py).

It imports a retrieval checkpoint through the standard path (the released
reference ``.pt`` through trainer.setup_model's importer, BGR stem flipped
once; or a deploy ``.npz`` of either package), folds the frozen BN, runs
the full-matrix MSRVTT retrieval eval with the protocol loaded from the
task config (fps 2 / num_frm 2 / 16 uniform clips / LSE), and prints
R@1/R@5/R@10 beside the paper values. It runs on the card unless asked for
the CPU::

    python -m clipbert_tpu_torch.verify_ckpt \\
        --e2e_weights_path /pretrain/msrvtt_ret_e2e.pt \\
        --txt_db /txt/msrvtt_retrieval_test.jsonl \\
        --img_db /vis_db/msrvtt \\
        --tokenizer_dir /pretrain/bert-base-uncased [--device cpu]

The released checkpoint is not in the repository; the harness is
smoke-tested offline on a synthetic checkpoint and store against the JAX
harness (tests/test_torch_tools.py).
"""

from __future__ import annotations

from typing import Dict, Optional

# PAPER_MSRVTT_T2V and format_report are copied from clipbert_tpu/
# verify_ckpt.py (tests/test_torch_host_copies.py holds them to it)

# Paper-reported MSRVTT 7k retrieval, 16-clip test (arXiv:2102.06183;
# BASELINE.md table B — paper-sourced, the comparison column only)
PAPER_MSRVTT_T2V = {"t2v_r1": 22.0, "t2v_r5": 46.8, "t2v_r10": 59.9}


def run_verification(e2e_weights_path: str, txt_db: str, img_db: str,
                     tokenizer_dir: str,
                     config: str = "configs/msrvtt_ret_base_resnet50.json",
                     inference_n_clips: Optional[int] = None,
                     data_ratio: float = 1.0,
                     device: str = "cuda") -> Dict:
    """Import the checkpoint -> full-matrix retrieval eval -> metrics, as
    the JAX run_verification, on ``device`` (a CUDA device runs the
    kernels: the fused stem and 1x1 convs, the fused attention).

    Returns the inference_retrieval metrics dict (t2v_/v2t_ r1/r5/r10/
    medr/meanr, in percent where applicable, and the score matrix) and the
    protocol. The eval protocol comes from the task config file;
    ``inference_n_clips`` overrides it (the published numbers are the
    16-clip ensemble, 1 is the fast smoke setting). The load is strict: a
    checkpoint that lacks a leaf of the retrieval model raises."""
    from clipbert_tpu_torch.core.config import load_run_config
    from clipbert_tpu_torch.data.datasets import VideoRetrievalEvalDataset
    from clipbert_tpu_torch.models import clipbert
    from clipbert_tpu_torch.tasks import common
    from clipbert_tpu_torch.tasks.run_video_retrieval import \
        inference_retrieval
    from clipbert_tpu_torch.train import trainer
    from clipbert_tpu_torch.utils.basic import load_jsonl

    cfg = load_run_config([
        "--config", config,
        "--tokenizer_dir", tokenizer_dir,
        "--e2e_weights_path", e2e_weights_path,
        "--num_labels", "2",
        "--output_dir", "",
        "--device", device,
    ])
    if inference_n_clips is not None:
        cfg.inference_n_clips = inference_n_clips
    model_cfg = common.load_model_config(cfg)
    model_cfg.num_labels = 2
    model = trainer.setup_model(cfg, model_cfg, "retrieval",
                                common.device_for(cfg), strict=True)
    clipbert.fold_cnn_bn_scales(model)
    model.eval().requires_grad_(False)
    tokenizer = common.setup_tokenizer(cfg)

    raw = load_jsonl(txt_db)
    if data_ratio < 1.0:
        raw = raw[:max(int(len(raw) * data_ratio), 1)]
    for i, d in enumerate(raw):
        d["id"] = i
    ds = VideoRetrievalEvalDataset(
        raw, tokenizer, common.setup_store(img_db), fps=cfg.fps,
        num_frm=cfg.num_frm, max_img_size=cfg.max_img_size,
        max_txt_len=cfg.max_txt_len,
        ensemble_n_clips=cfg.inference_n_clips, device_preprocess=True)
    metrics = inference_retrieval(cfg, model_cfg, model, ds,
                                  common.compute_dtype_for(cfg))
    metrics["protocol"] = {
        "fps": cfg.fps, "num_frm": cfg.num_frm,
        "inference_n_clips": cfg.inference_n_clips,
        "score_agg_func": cfg.score_agg_func,
        "loss_type": cfg.loss_type,
        "max_img_size": cfg.max_img_size, "n_examples": len(raw)}
    return metrics


def format_report(metrics: Dict) -> str:
    """R@1/R@5/R@10 beside the paper values (BASELINE.md)."""
    proto = metrics.get("protocol", {})
    lines = ["released-checkpoint parity report",
             f"protocol: {proto}",
             f"{'metric':<10}{'ours':>8}{'paper':>8}{'delta':>8}"]
    for k, paper in PAPER_MSRVTT_T2V.items():
        ours = metrics.get(k)
        if ours is None:
            continue
        lines.append(f"{k:<10}{ours:>8.2f}{paper:>8.1f}"
                     f"{ours - paper:>+8.2f}")
    for k in ("v2t_r1", "v2t_r5", "v2t_r10", "t2v_medianR", "t2v_meanR"):
        if k in metrics:
            lines.append(f"{k:<10}{metrics[k]:>8.2f}")
    if proto.get("inference_n_clips") != 16:
        lines.append("NOTE: paper values are the 16-clip ensemble; this "
                     f"run used {proto.get('inference_n_clips')} clip(s).")
    return "\n".join(lines)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="verify a released ClipBERT checkpoint: import -> "
                    "full-matrix MSRVTT retrieval eval -> R@k vs paper")
    ap.add_argument("--e2e_weights_path", required=True,
                    help="released .pt (msrvtt retrieval e2e) or a deploy "
                         ".npz")
    ap.add_argument("--txt_db", required=True,
                    help="msrvtt_retrieval_test.jsonl")
    ap.add_argument("--img_db", required=True,
                    help="video store (CBPK / JSEQ pack)")
    ap.add_argument("--tokenizer_dir", required=True)
    ap.add_argument("--config",
                    default="configs/msrvtt_ret_base_resnet50.json")
    ap.add_argument("--inference_n_clips", type=int, default=None,
                    help="override the config (published numbers: 16)")
    ap.add_argument("--data_ratio", type=float, default=1.0,
                    help="evaluate on a fraction (smoke runs)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    metrics = run_verification(
        args.e2e_weights_path, args.txt_db, args.img_db, args.tokenizer_dir,
        config=args.config, inference_n_clips=args.inference_n_clips,
        data_ratio=args.data_ratio, device=args.device)
    print(format_report(metrics))
    return metrics


if __name__ == "__main__":
    main()

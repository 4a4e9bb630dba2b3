# Copied from clipbert_tpu/evaluation/metrics.py: numpy only, kept importable without jax.
"""Evaluation metrics: retrieval R@K / MedR / MeanR, both directions.

Reference behavior (`src/tasks/run_video_retrieval.py:519-625`):
 - score matrix (#txt, #vid), one GT video per caption
 - text->video: rank videos per caption; video->text: transpose, with the
   GT caption per video obtained by *inverting* the caption->video map
   (last caption wins — reproduced faithfully, :620-623)
 - R@K = % of rows whose GT lands in the top K of the sorted row;
   MedR/MeanR are 1-indexed GT ranks (:533-543)

The VQA / TGIF-QA / MC accuracy metrics live on their datasets
(`clipbert_tpu.data.datasets`), mirroring the reference layout.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def metrics_from_ranks(gt_ranks: np.ndarray) -> Dict[str, float]:
    """gt_ranks: (N,) 0-indexed rank of the GT item per row."""
    n = len(gt_ranks)
    return {
        "r1": 100.0 * float((gt_ranks < 1).sum()) / n,
        "r5": 100.0 * float((gt_ranks < 5).sum()) / n,
        "r10": 100.0 * float((gt_ranks < 10).sum()) / n,
        "medianR": float(np.median(gt_ranks + 1)),
        "meanR": float(np.mean(gt_ranks + 1)),
    }


def gt_ranks_from_scores(score_matrix: np.ndarray,
                         gt_cols: np.ndarray) -> np.ndarray:
    """Rank (0-indexed, descending scores) of gt_cols[i] within row i.

    Equivalent to the reference's sort + bool-matrix construction
    (run_video_retrieval.py:547-560) without materializing the sort: the
    rank is the count of strictly-greater entries (ties keep the reference's
    stable-sort-by-position behavior for distinct scores; exact ties are
    resolved pessimistically after the GT like torch.sort would for
    equal values appearing earlier).
    """
    n = score_matrix.shape[0]
    gt_scores = score_matrix[np.arange(n), gt_cols][:, None]
    greater = (score_matrix > gt_scores).sum(axis=1)
    # ties at an earlier column index sort ahead of the GT (stable sort)
    ties_before = ((score_matrix == gt_scores)
                   & (np.arange(score_matrix.shape[1])[None, :]
                      < gt_cols[:, None])).sum(axis=1)
    return greater + ties_before


def retrieval_metrics(score_matrix: np.ndarray,
                      gt_txt2vid: Sequence[int]) -> Dict[str, Dict[str, float]]:
    """Both-direction metrics.

    score_matrix: (#txt, #vid); gt_txt2vid[i] = GT video column of caption i.
    """
    gt_txt2vid = np.asarray(gt_txt2vid)
    t2v = metrics_from_ranks(gt_ranks_from_scores(score_matrix, gt_txt2vid))

    # invert caption->video; duplicate videos keep the LAST caption
    # (reference dict inversion, run_video_retrieval.py:621)
    gt_vid2txt: Dict[int, int] = {}
    for txt_idx, vid_idx in enumerate(gt_txt2vid):
        gt_vid2txt[int(vid_idx)] = txt_idx
    vid_indices = np.array(sorted(gt_vid2txt))
    v2t_scores = score_matrix.T[vid_indices]
    v2t_gt = np.array([gt_vid2txt[int(v)] for v in vid_indices])
    v2t = metrics_from_ranks(gt_ranks_from_scores(v2t_scores, v2t_gt))
    return {"text2video": t2v, "video2text": v2t}

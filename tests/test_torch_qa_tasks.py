"""The port's three QA runners against the JAX package's, on the CPU: the
``start_inference`` of run_video_qa (action, frameqa), run_vqa and
run_msrvtt_mc, driven through each port runner's ``main --device cpu`` on
one tiny synthetic store and a ``model_step_N.npz`` written by the JAX
package's own ModelSaver, as tests/test_torch_eval.py does for retrieval.
The predictions and the metrics must equal the JAX runner's. Training is
refused."""

import io
import json

import numpy as np
import pytest
import torch

import jax

from clipbert_tpu.ckpt.checkpoint import ModelSaver
from clipbert_tpu.core.config import ModelConfig as JModelConfig
from clipbert_tpu.core.config import RunConfig as JRunConfig
from clipbert_tpu.models import clipbert as j_clipbert
from clipbert_tpu.tasks import run_msrvtt_mc as j_mc
from clipbert_tpu.tasks import run_video_qa as j_vqa_video
from clipbert_tpu.tasks import run_vqa as j_vqa
from clipbert_tpu_torch.data import store, tokenization, video
from clipbert_tpu_torch.tasks import run_msrvtt_mc, run_video_qa, run_vqa

WORDS = ["a", "cat", "dog", "runs", "the", "red", "car", "what", "who",
         "sits", "jumps", "bird"]
MODEL_KW = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                intermediate_size=64, max_position_embeddings=64,
                max_grid_row_position_embeddings=8,
                max_grid_col_position_embeddings=8)
N_VIDEOS, N_IMAGES, IMG = 6, 6, 64
ANSWERS = ["cat", "dog", "bird", "car", "red", "two"]


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """Small shapes gain nothing from a full intra-op pool; two threads
    keep these tests from crowding the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def random_params(jcfg, head, seed):
    """A JAX parameter tree for ``head`` filled from numpy (the structure
    of clipbert_tpu's init_clipbert via eval_shape), with non-zero biases
    and non-trivial LayerNorm and frozen BN."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        keys = [p.key for p in path if hasattr(p, "key")]
        if keys[-1] == "kernel" and len(s.shape) == 4:
            kh, kw, _, cout = s.shape
            a = rng.standard_normal(s.shape) * (2.0 / (kh * kw * cout)) ** 0.5
        elif keys[-2:] == ["bn", "scale"]:
            a = 0.5 + rng.random(s.shape)
        elif keys[-2:] == ["ln", "scale"]:
            a = 1.0 + 0.1 * rng.standard_normal(s.shape)
        else:
            a = (0.2 if "classifier" not in keys else 1.0) * \
                rng.standard_normal(s.shape)
        return a.astype(np.float32)

    shapes = jax.eval_shape(lambda: j_clipbert.init_clipbert(
        jax.random.key(0), jcfg, head))
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _jsonl(path, rows):
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return path


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Tokenizer, model config, a JPEG-sequence video store, a JPEG image
    store, an answer vocabulary and the annotations of each task."""
    from PIL import Image
    root = tmp_path_factory.mktemp("torch_qa")
    tok_dir = root / "tok"
    tok_dir.mkdir()
    tokenization.write_tiny_vocab(str(tok_dir / "vocab.txt"),
                                  extra_tokens=WORDS)
    tok = tokenization.BertTokenizer.from_dir(str(tok_dir))
    mcfg = root / "model.json"
    mcfg.write_text(json.dumps(dict(MODEL_KW, vocab_size=len(tok))))
    rng = np.random.default_rng(21)
    vids = root / "videos.cbpk"
    with store.PackWriter(str(vids)) as w:
        for i in range(N_VIDEOS):
            fr = rng.integers(0, 256, (8, 36, 48, 3)).astype(np.uint8)
            fr[..., i % 3] //= 3
            w.put(f"vid{i}", video.encode_jseq_from_array(fr, fps=4))
    imgs = root / "images.cbpk"
    with store.PackWriter(str(imgs)) as w:
        for i in range(N_IMAGES):
            arr = rng.integers(0, 256, (40 + 4 * i, 52, 3)).astype(np.uint8)
            arr[..., i % 3] //= 3
            buf = io.BytesIO()
            Image.fromarray(arr).save(buf, format="JPEG")
            w.put(f"img{i}", buf.getvalue())
    a2l = root / "ans2label.json"
    a2l.write_text(json.dumps({a: i for i, a in enumerate(ANSWERS)}))

    def sentence():
        return " ".join(rng.choice(WORDS, size=rng.integers(2, 6)))

    ann = {
        "action": _jsonl(root / "action.jsonl", [
            {"vid_id": f"vid{i % N_VIDEOS}", "question": sentence(),
             "question_id": 100 + i, "answer": int(rng.integers(0, 5)),
             "options": [sentence() for _ in range(5)]}
            for i in range(8)]),
        "frameqa": _jsonl(root / "frameqa.jsonl", [
            {"vid_id": f"vid{i % N_VIDEOS}", "question": sentence(),
             "question_id": 200 + i, "answer": str(rng.choice(ANSWERS)),
             "answer_type": ["object", "number", "color", "location"][i % 4]}
            for i in range(8)]),
        "vqa": _jsonl(root / "vqa.jsonl", [
            {"question_id": 300 + i, "txt": sentence(),
             "img_id": f"img{i % N_IMAGES}",
             "labels": {str(rng.choice(ANSWERS)): 1.0,
                        str(rng.choice(ANSWERS)): 0.3},
             "answer_type": ["yes/no", "number", "other"][i % 3]}
            for i in range(9)]),
        "mc": _jsonl(root / "mc.jsonl", [
            {"id": i, "vid_id": f"vid{i}", "answer": int(rng.integers(0, 5)),
             "options": [sentence() for _ in range(5)]}
            for i in range(N_VIDEOS)]),
    }
    return {"root": root, "tok_dir": tok_dir, "mcfg": mcfg, "vids": vids,
            "imgs": imgs, "a2l": a2l, "ann": ann, "vocab": len(tok)}


# per task: (head, model num_labels, loss_type, runner flags)
TASKS = {
    "action": ("multi_choice", 5, "ce",
               dict(task="action", num_frm=1, fps=4, inference_n_clips=2,
                    score_agg_func="mean", max_txt_len=12)),
    "frameqa": ("seq_cls", len(ANSWERS), "ce",
                dict(task="frameqa", num_frm=2, fps=4, inference_n_clips=2,
                     score_agg_func="lse", max_txt_len=8)),
    "vqa": ("seq_cls", len(ANSWERS), "bce", dict(max_txt_len=8)),
    "mc": ("retrieval", 2, "ce",
           dict(num_frm=2, fps=4, inference_n_clips=2, score_agg_func="lse",
                max_txt_len=8)),
}
RUNNERS = {"action": (j_vqa_video, run_video_qa),
           "frameqa": (j_vqa_video, run_video_qa),
           "vqa": (j_vqa, run_vqa), "mc": (j_mc, run_msrvtt_mc)}


def _flags(world, task, out):
    head, n, loss, kw = TASKS[task]
    img = world["imgs"] if task == "vqa" else world["vids"]
    flags = dict(model_config=str(world["mcfg"]),
                 tokenizer_dir=str(world["tok_dir"]), output_dir=str(out),
                 inference_txt_db=str(world["ann"][task]),
                 inference_img_db=str(img), ans2label_path=str(world["a2l"]),
                 bf16=False, max_img_size=IMG, inference_batch_size=3,
                 n_workers=2, loss_type=loss, **kw)
    return flags


@pytest.mark.parametrize("task", list(TASKS))
def test_start_inference_matches_jax(world, task, tmp_path):
    head, n, loss, _ = TASKS[task]
    kw = dict(MODEL_KW, vocab_size=world["vocab"], num_labels=n,
              loss_type=loss)
    out = tmp_path / "run"
    ModelSaver(str(out)).save(3, random_params(JModelConfig(**kw), head, 7))
    flags = _flags(world, task, out)
    j_run, run = RUNNERS[task]
    want = j_run.start_inference(JRunConfig(do_inference=True, **flags))
    argv = ["--do_inference", "1", "--device", "cpu"] + [
        a for k, v in flags.items() for a in (f"--{k}", str(int(v)) if
                                              isinstance(v, bool) else str(v))]
    got = run.main(argv)
    preds = "preds" if task == "mc" else "results"
    assert got[preds] == want[preds]
    assert {k: v for k, v in got.items() if k != preds} == \
        {k: v for k, v in want.items() if k != preds}
    answers = (list(got[preds].values()) if task == "mc"
               else [r["answer"] for r in got[preds]])
    assert len(answers) == {"action": 8, "frameqa": 8, "vqa": 9,
                            "mc": N_VIDEOS}[task]
    assert len(set(map(str, answers))) > 1        # not one constant answer
    written = {"action": "videoqa_action_metrics_step3.json",
               "frameqa": "videoqa_frameqa_metrics_step3.json",
               "vqa": "vqa_results_step3.json",
               "mc": "mc_metrics_step3.json"}[task]
    assert (out / written).exists()


@pytest.mark.parametrize("task", list(TASKS))
def test_training_is_refused(world, task, tmp_path):
    flags = _flags(world, task, tmp_path)
    argv = [a for k, v in flags.items()
            for a in (f"--{k}", str(int(v)) if isinstance(v, bool)
                      else str(v))]
    with pytest.raises(SystemExit):
        RUNNERS[task][1].main(argv + ["--device", "cpu"])

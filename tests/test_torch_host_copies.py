"""The port's copies of the JAX package's host modules have not drifted
from their originals. The port copies them rather than importing them
because importing anything of clipbert_tpu runs its __init__, which
imports jax.

Each copy is compared with its original member by member on the parsed
code: every module-level function, class (its bases and decorators, and
each method and class attribute) and constant, with docstrings left out
and the package name ``clipbert_tpu_torch`` read as ``clipbert_tpu``.
Comments, docstrings and imports may differ; so may the members named in
``KNOWN``, each with the reason it differs. A whole-file copy must hold
exactly the original's members; a partial copy holds the listed ones, and
a class copied in eval form may leave out the original's train members.
Every copy starts with a header naming its original."""

import ast
import copy
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# port path (under clipbert_tpu_torch/ and clipbert_tpu/) ->
# (copied top-level members, or None for the whole file; whether a copied
# class may leave out members of the original)
COPIES = {
    "data/tokenization.py": (None, False),
    "data/sampling.py": (None, False),
    "data/video.py": (None, False),
    "data/store.py": (None, False),
    "evaluation/metrics.py": (None, False),
    "utils/basic.py": (["load_json", "save_json", "load_jsonl",
                        "flat_list_of_lists"], False),
    "data/loader.py": (["ShardedBatchSampler", "DataLoader",
                        "InfiniteIterator"], False),
    "utils/logger.py": (["_LOG_FMT", "_DATE_FMT", "LOGGER",
                         "add_log_to_file", "NoOp", "TensorboardLogger",
                         "TB_LOGGER", "RunningMeter"], False),
    "utils/profiling.py": (["StepTimer"], False),
    "ckpt/checkpoint.py": (["flatten_tree", "unflatten_tree",
                            "fetch_tree_host", "_write_npz", "save_tree",
                            "_WRITER", "_PENDING", "_writer",
                            "_submit_write", "drain_writes", "load_tree",
                            "load_with_mismatch", "ModelSaver",
                            "TrainingRestorer", "save_training_meta",
                            "load_training_args"], False),
    "core/config.py": (["ModelConfig", "DatasetSpec", "RunConfig", "_coerce",
                        "load_run_config", "inject_task_attrs"], False),
    "data/transforms.py": (["get_resize_size", "resize_frames", "pad_frames",
                            "is_extreme_aspect_ratio", "IMAGENET_MEAN_255",
                            "IMAGENET_STD_1", "_BUCKET", "collate_visual",
                            "chunk_list", "mk_input_group"], False),
    "data/datasets.py": (["flat_list_of_lists", "BaseDataset",
                          "VideoRetrievalTrainDataset",
                          "VideoRetrievalEvalDataset", "RetrievalCollator",
                          "MSRVTTMCEvalDataset", "OPEN_ENDED_QA",
                          "ANSWER_TYPE2IDX", "VideoQADataset",
                          "VideoQACollator", "VQADataset", "load_jsonl",
                          "group_datalist_by_visual", "apply_data_ratio"],
                         True),
}

# members that differ on purpose: "file:member" -> why
KNOWN = {
    "data/video.py:_load_native":
        "caches only a hit, so a library built later is found "
        "(ROADMAP queue 3; the original caches a miss)",
    "data/video.py:_native_checked": "the miss cache the port dropped",
    "core/config.py:RunConfig.device":
        "the port's device flag (cuda, or cpu for the plain versions)",
    "core/config.py:RunConfig.restore_from_training_args":
        "keeps the launch's device, as it keeps the launch topology",
    "data/datasets.py:BaseDataset.__init__":
        "the n_fallbacks counter and its lock",
    "data/datasets.py:BaseDataset.eval_fallback_frames":
        "counts each fallback under the lock",
    "data/datasets.py:VideoQADataset.__init__":
        "eval form: refuses is_train=True",
    "data/datasets.py:VideoQADataset.__getitem__":
        "eval form: the original's train branch left out",
    "data/datasets.py:VQADataset.__init__":
        "eval form: refuses is_train=True",
    "data/datasets.py:VQADataset.__getitem__":
        "eval form: the original's train branch left out",
    "utils/logger.py:TensorboardLogger.create":
        "where the tensorboard package is missing (torch.utils.tensorboard "
        "needs it) the scalars go to log/scalars.jsonl through "
        "JsonlScalarWriter, with a warning, rather than fail or be dropped",
    "utils/logger.py:JsonlScalarWriter":
        "the scalar writer TensorboardLogger.create falls back to",
}


class _Normalize(ast.NodeTransformer):
    """Drops docstrings and import statements (also those inside
    functions): the lines a copy may change."""

    def generic_visit(self, node):
        node = super().generic_visit(node)
        body = getattr(node, "body", None)
        if isinstance(body, list):
            if body and isinstance(body[0], ast.Expr) and \
                    isinstance(body[0].value, ast.Constant) and \
                    isinstance(body[0].value.value, str):
                body = body[1:]
            node.body = [n for n in body if not isinstance(
                n, (ast.Import, ast.ImportFrom))] or [ast.Pass()]
        return node


def _dump(node) -> str:
    node = _Normalize().visit(copy.deepcopy(node))
    return ast.dump(node).replace("clipbert_tpu_torch", "clipbert_tpu")


def _targets(node):
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
        return [node.name]
    if isinstance(node, ast.Assign):
        return [t.id for t in node.targets if isinstance(t, ast.Name)]
    if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
        return [node.target.id]
    return []


def members(source: str):
    """{name: normalized code} of a module's top-level members, and for
    each class ``Class`` (its header) and ``Class.member``."""
    out = {}
    for node in ast.parse(source).body:
        for name in _targets(node):
            if isinstance(node, ast.ClassDef):
                header = copy.copy(node)
                header.body = []
                out[name] = _dump(header)
                for sub in node.body:
                    for sname in _targets(sub):
                        out[f"{name}.{sname}"] = _dump(sub)
            else:
                out[name] = _dump(node)
    return out


def _read(pkg, rel):
    with open(os.path.join(REPO, pkg, rel)) as f:
        return f.read()


def drift(rel, port_src, orig_src):
    """The members of the port copy ``rel`` that differ from the
    original's, or are missing or extra, beyond KNOWN."""
    names, partial_classes = COPIES[rel]
    port, orig = members(port_src), members(orig_src)
    if names is None:
        wanted = set(orig) | set(port)
    else:
        wanted = {m for m in set(orig) | set(port)
                  if m.split(".")[0] in names}
    bad = []
    for m in sorted(wanted):
        if f"{rel}:{m}" in KNOWN:
            continue
        if m not in port:
            if partial_classes and "." in m:
                continue            # a train member the eval form leaves out
            bad.append(f"{m}: missing from the copy")
        elif m not in orig:
            bad.append(f"{m}: not in the original")
        elif port[m] != orig[m]:
            bad.append(f"{m}: differs from the original")
    return bad


@pytest.mark.parametrize("rel", list(COPIES))
def test_copy_matches_its_original(rel):
    port_src = _read("clipbert_tpu_torch", rel)
    orig_src = _read("clipbert_tpu", rel)
    assert drift(rel, port_src, orig_src) == []
    if rel != "data/transforms.py":   # a port of the device half + copies
        assert port_src.startswith(f"# Copied from clipbert_tpu/{rel}")
    names = COPIES[rel][0]
    if names is not None:
        have = members(port_src)
        assert [n for n in names if n not in have] == []


def test_known_differences_still_differ():
    """Each KNOWN entry names a member of a copy that exists and still
    differs from the original, so the list cannot go stale."""
    for key in KNOWN:
        rel, m = key.split(":")
        port = members(_read("clipbert_tpu_torch", rel))
        orig = members(_read("clipbert_tpu", rel))
        assert m in port or m in orig, key
        assert port.get(m) != orig.get(m), key


@pytest.mark.parametrize("edit", ["constant", "operator", "new member",
                                  "dropped member"])
def test_checker_catches_a_drifted_line(edit):
    """A one-line change in a copy is reported: the comparison is not
    vacuous."""
    rel = "data/sampling.py" if edit != "dropped member" \
        else "data/loader.py"
    src = _read("clipbert_tpu_torch", rel)
    orig = _read("clipbert_tpu", rel)
    tree = ast.parse(src)
    if edit == "constant":
        func = next(n for n in tree.body if isinstance(n, ast.FunctionDef))
        node = next(n for n in ast.walk(func) if isinstance(n, ast.Constant)
                    and isinstance(n.value, int)
                    and not isinstance(n.value, bool))
        node.value += 1
    elif edit == "operator":
        node = next(n for n in ast.walk(tree) if isinstance(n, ast.BinOp)
                    and isinstance(n.op, ast.Add))
        node.op = ast.Sub()
    elif edit == "new member":
        tree.body.append(ast.parse("EXTRA = 1").body[0])
    else:
        cls = next(n for n in tree.body if isinstance(n, ast.ClassDef)
                   and n.name == "DataLoader")
        cls.body = [n for n in cls.body if not (
            isinstance(n, ast.FunctionDef) and n.name == "__len__")]
    assert drift(rel, src, orig) == []
    assert drift(rel, ast.unparse(tree), orig) != []

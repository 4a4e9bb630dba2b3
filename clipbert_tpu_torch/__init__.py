"""clipbert_tpu_torch: the PyTorch + CUDA port of clipbert_tpu for NVIDIA Hopper.

The JAX package ``clipbert_tpu`` stays the reference; this package mirrors
its module layout (``models/bert.py`` here is the counterpart of
``clipbert_tpu/models/bert.py``) and keeps its public tensor layouts (NHWC
pixels and grid features, ``(B, S, H, dh)`` attention operands), so parity
tests compare like with like. It imports torch and numpy, never jax and
never ``clipbert_tpu``.

The ported slices are inference: the resident retrieval, VQA and video-QA
scorers (``serve.py``), the eval of the retrieval, video-QA, VQA and
MSRVTT multiple-choice runners (``tasks/``; the retrieval eval also
across processes), tensor-parallel scoring, and every task head. Uint8 frames -> device
resize/pad/normalize -> ResNet-50 grid features (frozen BN folded) ->
visual embeddings + 12-layer joint BERT -> head -> clip pooling. Its
hand-written CUDA kernels (``csrc/``, wrappers in ``ops/``) are the fused
attention core, the ResNet's fused 1x1 convs and its fused stem.
"""

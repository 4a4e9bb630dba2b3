"""clipbert_tpu_torch: the PyTorch + CUDA port of clipbert_tpu for NVIDIA Hopper.

The JAX package ``clipbert_tpu`` stays the reference; this package mirrors
its module layout (``models/bert.py`` here is the counterpart of
``clipbert_tpu/models/bert.py``) and keeps its public tensor layouts (NHWC
pixels and grid features, ``(B, S, H, dh)`` attention operands), so parity
tests compare like with like. It imports torch and numpy, never jax and
never ``clipbert_tpu``.

The ported slice is the resident retrieval scorer (``serve.py``): uint8
frames -> device resize/pad/normalize -> ResNet-50 grid features (frozen BN
folded) -> visual embeddings + 12-layer joint BERT -> retrieval head -> LSE
clip pooling + softmax. Its one hand-written kernel is the fused attention
core (``csrc/fused_attention.cu``, wrapper ``ops/fused_attention.py``).
"""

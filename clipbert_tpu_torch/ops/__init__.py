import torch


def kernels_default(device: torch.device) -> bool:
    """The port's hand-written kernels (fused attention, the CNN's fused stem
    and 1x1 convs) run on a CUDA device; CPU tensors take the plain paths.
    The JAX package picks its Pallas kernels for one accelerator the same
    way."""
    return torch.device(device).type == "cuda"


def refuse_autograd(kernel: str, *tensors) -> None:
    """Raise where a hand-written kernel would be launched on an input that
    autograd tracks. The kernels have no backward (neither have the JAX
    package's Pallas kernels), so their outputs carry no ``grad_fn``: a
    launch inside a train step would silently cut every gradient behind
    it. Train steps take the plain forms (the cuDNN CNN and the einsum
    attention core) instead."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: the CUDA kernel has no backward and would detach "
            "its output from autograd; run the plain form for training "
            "(use_kernels=False, fused_attn=False) or call it under "
            "torch.no_grad() / torch.inference_mode()")

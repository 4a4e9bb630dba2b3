import torch


def kernels_default(device: torch.device) -> bool:
    """The port's hand-written kernels (fused attention, the CNN's fused stem
    and 1x1 convs) run on a CUDA device; CPU tensors take the plain paths.
    The JAX package picks its Pallas kernels for one accelerator the same
    way."""
    return torch.device(device).type == "cuda"

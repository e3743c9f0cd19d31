"""Hand-written CUDA kernels, their plain PyTorch versions, and the oracles."""
import torch

# FLOP count of each kernel op (by op name) for the compiler's cost model:
# a kernel module that registers a custom op enters its count here, so a
# graph that holds the op's node finds it (the op exists only once its
# module is imported).
OP_FLOPS = {}


def refuse_grad(name: str, *tensors) -> None:
    """Raise before a CUDA launch whose inputs need gradients.

    A kernel writes its output through raw pointers, so the result has no
    ``grad_fn`` and the weights behind it would get no gradient, with no
    error.  No kernel has a backward (nor has any Pallas kernel of the JAX
    package), so a wrapper refuses instead: it never carries on with the
    plain version either.  The CPU branches keep their plain versions,
    which differentiate."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: an input requires grad, and the CUDA kernel has no backward (its"
            " output would cut the autograd graph); call it under torch.no_grad(), or"
            " compile the training step with kernel_dispatch 'auto' or 'off'")

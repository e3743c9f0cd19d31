"""Hand-written CUDA kernels, their plain PyTorch versions, and the oracles."""

# FLOP count of each kernel op (by op name) for the compiler's cost model:
# a kernel module that registers a custom op enters its count here, so a
# graph that holds the op's node finds it (the op exists only once its
# module is imported).
OP_FLOPS = {}

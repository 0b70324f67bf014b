"""Ops of the port: layers and the loss, attention, and the kernels with
their plain PyTorch versions (flash attention, fused head + cross-entropy,
paged attention), the block quantizer, and the nvcc/ctypes loader."""

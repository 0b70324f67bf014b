"""Ops of the port: layers, the block quantizer and the paged-attention
kernel with its plain PyTorch version."""

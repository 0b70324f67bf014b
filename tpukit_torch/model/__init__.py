"""The GPT model of the port (`gpt.py`)."""

from tpukit_torch.model.gpt import (
    GPTConfig,
    forward,
    forward_cached,
    forward_hidden,
    init_params,
)

__all__ = ["GPTConfig", "forward", "forward_cached", "forward_hidden", "init_params"]

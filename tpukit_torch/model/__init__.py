"""The GPT model of the port (`gpt.py`)."""

from tpukit_torch.model.gpt import GPTConfig, forward_cached, init_params

__all__ = ["GPTConfig", "forward_cached", "init_params"]

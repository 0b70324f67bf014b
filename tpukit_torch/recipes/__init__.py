"""The port's training recipes: `python -m tpukit_torch.recipes.<name>`."""

"""A router process for `tests/test_torch_fleet_grid.py`: builds a fleet of
two replicas over grids of 2 CPU entries (`tests/test_torch_fleet.py`'s
model shape, seeded parameters), waits for both worlds to start, prints
every rank's pid after `pids:`, then SIGKILLs itself, so that the test can
watch the orphaned worlds exit.

    python tests/torch_grid_router.py
"""

import os
import signal
import sys
from pathlib import Path

# the script's own directory is tests/, so put the repository root in reach
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    import torch

    torch.set_num_threads(1)
    from tpukit_torch.data import WordTokenizer, synthetic_stories
    from tpukit_torch.model import GPTConfig, init_params
    from tpukit_torch.serve.engine import ServeConfig
    from tpukit_torch.serve.fleet import FleetConfig, FleetRouter

    tok = WordTokenizer(synthetic_stories(64))
    cfg = GPTConfig(dim=32, head_dim=8, heads=4, num_layers=2, vocab_size=tok.vocab_size,
                    max_position_embeddings=64, compute_dtype=torch.float32)
    router = FleetRouter(init_params(cfg, seed=1, device="cpu"), cfg,
                         ServeConfig(slots=2, buckets=(8, 16), max_new_tokens=4),
                         FleetConfig(replicas=2, devices_per_replica=2), eos_id=int(tok.eos_token_id),
                         device="cpu", devices=["cpu"] * 4)
    worlds = list(router._replicas.values())
    assert all(w.free_slots == 2 for w in worlds)  # both worlds answered
    print("pids:", *[p for w in worlds for p in w.pids()], flush=True)
    os.kill(os.getpid(), signal.SIGKILL)
    return 1


if __name__ == "__main__":
    sys.exit(main())

"""A replica worker process of the port's process fleet, for
`tests/test_torch_fleet.py` (the twin of `tests/fleet_worker.py`).

Builds the engine of the test's fixture (the same tokenizer corpus,
`GPTConfig` and serving shape) on the CPU over the parameters the test
saved with `torch.save` (tpukit's `PRNGKey(1)` parameters, carried over by
`bridge.params_from_numpy`), then serves leases from the ledger directory
until the supervisor publishes stop or the wall budget runs out: an
orphaned worker exits rather than outlive its test.

    python tests/torch_fleet_worker.py FLEET_DIR REPLICA_IDX PARAMS_PT [WALL_S]
"""

import sys
from pathlib import Path

# the script's own directory is tests/, so put the repository root in reach
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    directory, replica, params_path = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    wall_s = float(sys.argv[4]) if len(sys.argv) > 4 else 120.0

    import torch

    torch.set_num_threads(1)
    from tpukit_torch.data import WordTokenizer, synthetic_stories
    from tpukit_torch.model import GPTConfig
    from tpukit_torch.serve.engine import ServeConfig, ServeEngine
    from tpukit_torch.serve.ledger import serve_from_ledger

    tok = WordTokenizer(synthetic_stories(64))
    cfg = GPTConfig(dim=32, head_dim=8, heads=4, num_layers=2, vocab_size=tok.vocab_size,
                    max_position_embeddings=64, compute_dtype=torch.float32)
    params = torch.load(params_path, map_location="cpu")
    serve = ServeConfig(slots=2, buckets=(8, 16), max_new_tokens=10, window_steps=8)
    engine = ServeEngine(params, cfg, serve, eos_id=int(tok.eos_token_id), device="cpu",
                         replica=replica)
    comps = serve_from_ledger(engine, directory, replica, max_wall_s=wall_s)
    print(f"replica {replica}: served {len(comps)} completions")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""`python -m tpukit_torch.bench.induction`: train and checkpoint a small
induction target for speculative serving (twin of tpukit's
`tools/train_induction.py`).

Speculation pays when the target's next tokens are predictable; a random
target accepts almost nothing. This trains the tiled-phrase rows the
`repetitive` stream profile serves (`bench.serving._induction_train`, the
same trainer the `spec_decode` record uses) and saves tpukit's
consolidated checkpoint (`checkpoint.save_auto`), which the port's serving
entry point restores params-only, as tpukit's `main-serve.py` does:

    python -m tpukit_torch.bench.induction --dim 64 --num_layers 2 \\
        --steps 400 --out ckpt_induction
    python -m tpukit_torch.serve --dim 64 --head_dim 16 --heads 4 \\
        --num_layers 2 --sequence_length 128 --disable_amp \\
        --checkpoint "$(ls ckpt_induction/checkpoint-step*.msgpack)" \\
        --draft ngram --stream_profile repetitive

The shape flags must equal the serving run's (the params-only reader
checks the tree), and `--row_len` must cover the serving positions
(largest bucket + max_new_tokens + spec_k): positions past the trained
range decode noise. Runs on cuda unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--head_dim", type=int, default=16)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--num_layers", type=int, default=2)
    ap.add_argument("--sequence_length", type=int, default=128,
                    help="position-table size; must match the serving --sequence_length")
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--row_len", type=int, default=40,
                    help="training row length: cover the largest bucket + max_new_tokens + "
                    "spec_k of the serving run")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", type=str, default="ckpt_induction")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    flags = ap.parse_args(argv)

    import torch

    from tpukit_torch import checkpoint as ckpt_lib
    from tpukit_torch import resolve_device
    from tpukit_torch.bench.serving import _induction_train
    from tpukit_torch.data import get_tokenizer
    from tpukit_torch.model import GPTConfig

    device = resolve_device(flags.device)
    tokenizer = get_tokenizer()
    tokenizer.pad_token_id = 2
    cfg = GPTConfig(dim=flags.dim, head_dim=flags.head_dim, heads=flags.heads,
                    num_layers=flags.num_layers, vocab_size=tokenizer.vocab_size,
                    max_position_embeddings=flags.sequence_length,
                    compute_dtype=torch.float32)
    state, loss = _induction_train(cfg, tokenizer, flags.steps, flags.row_len, lr=flags.lr,
                                   seed=flags.seed, device=device)
    path = ckpt_lib.save_auto(state, "consolidated", directory=flags.out)
    print(f"induction target: loss {loss:.4f} after {flags.steps} steps -> {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

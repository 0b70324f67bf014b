"""The port stands alone: `tpukit_torch` and `chip_smoke.py` import with
`jax`, `tpukit`, `flax` and `msgpack` unimportable, contain (with
`ce_ablation.py` and `fleet_cards.py`) no import of any of them, default
to cuda and refuse to fall back to the CPU silently."""

import ast
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import tpukit_torch
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ROOT = Path(__file__).resolve().parent.parent
REFUSED = ("jax", "jaxlib", "tpukit", "flax", "msgpack")  # the port imports none of these
PORT_FILES = sorted((ROOT / "tpukit_torch").rglob("*.py")) + [ROOT / "chip_smoke.py",
                                                            ROOT / "ce_ablation.py",
                                                            ROOT / "fleet_cards.py"]

_BLOCKER = """
import importlib.abc, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError(f"{name} is refused in this process")
        return None

sys.meta_path.insert(0, Refuse())
import importlib
for mod in MODULES:
    importlib.import_module(mod)
assert not [m for m in sys.modules if m.split(".")[0] in REFUSED]
print("imported", len(MODULES))
"""


def _port_modules():
    mods = ["tpukit_torch"] + [
        m.name for m in pkgutil.walk_packages(tpukit_torch.__path__, "tpukit_torch.")
    ]
    return mods + ["chip_smoke"]


def _run(args, cwd=ROOT, env=None, timeout=120):
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_port_imports_without_jax_or_tpukit():
    mods = _port_modules()
    assert "tpukit_torch.ops.paged_attention" in mods and "tpukit_torch.serve.engine" in mods
    assert {"tpukit_torch.serve.fleet", "tpukit_torch.serve.ledger",
            "tpukit_torch.serve.replica_world"} <= set(mods)
    assert {"tpukit_torch.analysis", "tpukit_torch.analysis.comm_ir",
            "tpukit_torch.analysis.plan", "tpukit_torch.analysis.rules",
            "tpukit_torch.analysis.__main__", "tpukit_torch.native"} <= set(mods)
    assert {"tpukit_torch.bench", "tpukit_torch.bench.ladder", "tpukit_torch.bench.records",
            "tpukit_torch.bench.serving", "tpukit_torch.bench.induction",
            "tpukit_torch.bench.__main__", "tpukit_torch.ops.deferred"} <= set(mods)
    proc = _run([sys.executable, "-c", f"MODULES = {mods!r}\nREFUSED = {REFUSED!r}\n" + _BLOCKER])
    assert proc.returncode == 0, proc.stderr
    assert f"imported {len(mods)}" in proc.stdout


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_source_has_no_jax_or_tpukit_import(path):
    """No import of jax, tpukit, flax or msgpack (the port's own
    `tpukit_torch.msgpack` is not msgpack)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in REFUSED, \
                f"{path.name}:{node.lineno} imports {name}"


def test_entry_points_default_to_cuda_and_refuse_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(tpukit_torch.CudaUnavailableError, match="device='cpu'"):
        tpukit_torch.resolve_device()
    from tpukit_torch.model import GPTConfig, init_params

    with pytest.raises(tpukit_torch.CudaUnavailableError):
        init_params(GPTConfig(num_layers=1, dim=16, head_dim=4, heads=4, vocab_size=32))
    assert tpukit_torch.resolve_device("cpu").type == "cpu"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_serve_cli_runs_on_cpu_when_asked():
    proc = _run([sys.executable, "-m", "tpukit_torch.serve", "--device", "cpu",
                 "--num_layers", "1", "--dim", "32", "--head_dim", "8", "--heads", "4",
                 "--sequence_length", "32", "--requests", "4", "--slots", "2",
                 "--buckets", "8,16", "--max_new_tokens", "4", "--page_size", "8",
                 "--fused_decode"])
    assert proc.returncode == 0, proc.stderr
    assert "served 4 requests / " in proc.stdout
    bad = _run([sys.executable, "-m", "tpukit_torch.serve", "--device", "cpu",
                "--checkpoint", "ckpt.pt"])  # never served as seeded weights in its place
    assert bad.returncode != 0 and "RuntimeError: --checkpoint ckpt.pt: failed integrity " \
        "verification (missing file)" in bad.stderr and "served" not in bad.stdout


def test_chip_smoke_fails_without_a_gpu(tmp_path):
    """No CUDA device: exit code not 0 and no result line. Alone in a
    directory without the package: the same."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = _run([sys.executable, "chip_smoke.py"], env=env)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    alone = _run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env)
    assert alone.returncode != 0 and '"ok"' not in alone.stdout

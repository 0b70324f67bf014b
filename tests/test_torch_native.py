"""The port's native tokenizer (`tpukit_torch/native`) against the Python
encoder and tpukit's (`tests/test_native.py` is the model): the ids and
masks byte for byte on the fixture corpus, on the piece classes the regex
makes (words, punctuation runs, leading spaces, whitespace, the unicode
fallback) and on truncation; the same bytes on 1 and 8 threads;
`WordTokenizer`'s dispatch under tpukit's condition (64 texts or more,
padded to `max_length` and truncated); `TPUKIT_NATIVE=0`; the build in
`build/tpukit_torch/native-<hash>/`, nothing beside the source. Skipped
only where `g++` is missing."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tpukit import native as tk_native
from tpukit.data import WordTokenizer as TkWordTokenizer
from tpukit_torch import native
from tpukit_torch.data import WordTokenizer, get_tokenizer, synthetic_stories
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ROOT = Path(__file__).resolve().parent.parent
NO_CXX = shutil.which(os.environ.get("CXX", "g++")) is None
if NO_CXX:
    print("tests/test_torch_native.py: no g++ on PATH, the native tokenizer cannot build")
pytestmark = pytest.mark.skipif(NO_CXX, reason="no g++: the native tokenizer cannot build")

EDGE = ["", "   ", "Hello, world!! 'tis  a--test\nnewline", "unicode café — dash",
        "x" * 500, 'She said "What a big ball!"', "\n\n\t tabs\tand  runs  ", "123 4'5 ,,, ."]


@pytest.fixture(scope="module")
def toks():
    """The port's tokenizer and tpukit's over the same corpus."""
    corpus = synthetic_stories(256)
    return WordTokenizer(corpus), TkWordTokenizer(corpus)


def _python(tok, texts, max_len):
    ids, mask = [], []
    for t in texts:
        e = tok._encode_one(t)[:max_len]
        ids.append(e + [tok.pad_token_id] * (max_len - len(e)))
        mask.append([1] * len(e) + [0] * (max_len - len(e)))
    return np.asarray(ids, np.int32), np.asarray(mask, np.int32)


@pytest.mark.parametrize("texts,max_len,threads", [
    (synthetic_stories(300, seed=7), 96, None), (EDGE, 64, 2), (EDGE, 3, 1)],
    ids=["corpus", "edge", "truncated"])
def test_native_matches_python_and_tpukit(toks, texts, max_len, threads):
    tok, tk_tok = toks
    assert native.is_available(), native.build_error()
    ids, mask = native.NativeEncoder(tok._id_to_token, tok.unk_token_id).encode_batch(
        texts, max_len, tok.pad_token_id, n_threads=threads)
    assert ids.dtype == mask.dtype == np.int32 and ids.shape == (len(texts), max_len)
    for ref_ids, ref_mask in (_python(tok, texts, max_len), _python(tk_tok, texts, max_len)):
        assert ids.tobytes() == ref_ids.tobytes() and mask.tobytes() == ref_mask.tobytes()
    if tk_native.is_available():
        tk_ids, tk_mask = tk_native.NativeEncoder(tk_tok._id_to_token,
                                                  tk_tok.unk_token_id).encode_batch(
            texts, max_len, tk_tok.pad_token_id, n_threads=threads)
        assert ids.tobytes() == tk_ids.tobytes() and mask.tobytes() == tk_mask.tobytes()


def test_native_threads_deterministic(toks):
    tok, _ = toks
    enc = native.NativeEncoder(tok._id_to_token, tok.unk_token_id)
    texts = synthetic_stories(500, seed=11)
    a = enc.encode_batch(texts, 64, tok.pad_token_id, n_threads=1)
    b = enc.encode_batch(texts, 64, tok.pad_token_id, n_threads=8)
    for x, y in zip(a, b):
        assert x.tobytes() == y.tobytes()


def test_wordtokenizer_dispatches_under_tpukits_condition():
    """64 padded, truncated texts go native and give the Python encoder's
    bytes (and tpukit's `WordTokenizer`'s); 63 texts, or no truncation,
    stay in Python."""
    tok, plain = get_tokenizer(), get_tokenizer()
    plain._native = None  # the Python path
    texts = synthetic_stories(64, seed=9)
    before = native.encodes
    out = tok(texts, padding="max_length", max_length=80, truncation=True)
    assert native.encodes == before + 1
    ref = plain(texts, padding="max_length", max_length=80, truncation=True)
    tk = TkWordTokenizer(synthetic_stories(4096, seed=0) + synthetic_stories(256, seed=1))
    tk._native = None
    tk_ref = tk(texts, padding="max_length", max_length=80, truncation=True)
    for key in ("input_ids", "attention_mask"):
        assert out[key].tobytes() == ref[key].tobytes() == np.asarray(
            tk_ref[key], np.int32).tobytes()
    tok(texts[:63], padding="max_length", max_length=80, truncation=True)
    tok(texts, padding="max_length", max_length=80)
    tok(texts, truncation=True)
    assert native.encodes == before + 1
    assert tok.decode(out["input_ids"][0], skip_special_tokens=True) in texts[0]


def test_native_builds_outside_the_source_and_can_be_disabled():
    """The library lives under `build/tpukit_torch/native-<hash>/`, keyed
    by the source; nothing is written beside `tokenizer.cpp`; a process
    with `TPUKIT_NATIVE=0` keeps the Python encoder."""
    assert native.is_available()
    path = native.library_path()
    assert path.exists() and path.parent.name.startswith("native-")
    assert path.is_relative_to(ROOT / "build" / "tpukit_torch")
    assert sorted(p.name for p in Path(native.__file__).parent.iterdir()
                  if p.name != "__pycache__") == ["__init__.py", "tokenizer.cpp"]
    code = ("from tpukit_torch import native; from tpukit_torch.data import get_tokenizer, "
            "synthetic_stories; t = get_tokenizer(); "
            "t(synthetic_stories(64), padding='max_length', max_length=16, truncation=True); "
            "print(native.is_available(), native.encodes, native.build_error())")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120, env={**os.environ, "TPUKIT_NATIVE": "0"})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["False", "0", "disabled", "via", "TPUKIT_NATIVE=0"]

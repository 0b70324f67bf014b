"""The offline fixture corpus, word-level tokenizer and dataset pipeline
(twin of `tpukit/data.py:64-353`).

The port runs without network access, on the card's machine and here.
This is tpukit's offline branch, copied: a deterministic TinyStories-style
corpus, a word tokenizer over it (the Python encoder; tpukit's C++ batch
encoder, byte-identical to it, is not ported), `get_dataset` (the fixture
corpus, train split sliceable) and `transform_dataset` (pad to
`max_length`, truncate, dense int32 arrays).
"""

from __future__ import annotations

import functools
import re
from typing import Optional, Union

import numpy as np

_NAMES = ["Tom", "Lily", "Max", "Mia", "Ben", "Sue", "Sam", "Anna", "Tim", "Amy"]
_ANIMALS = ["cat", "dog", "bird", "frog", "bunny", "duck", "bear", "fox", "mouse", "pony"]
_ADJS = ["big", "small", "happy", "sad", "brown", "red", "little", "kind", "funny", "soft"]
_OBJECTS = ["ball", "hat", "book", "cake", "tree", "boat", "kite", "flower", "apple", "box"]
_PLACES = ["park", "garden", "house", "forest", "beach", "farm", "school", "yard", "pond", "hill"]
_VERBS = ["found", "saw", "liked", "wanted", "made", "took", "lost", "shared", "hugged", "chased"]

_TEMPLATES = [
    "One day, {name} went to the {place}. {name} {verb} a {adj} {obj}. "
    'She said "What a {adj} {obj}!" {name} was very {adj2}.',
    "The {adj} {adj2} {animal} lived in the {place}. One day, the {animal} {verb} a {obj}. "
    "The {animal} was {adj2} all day.",
    '{name} had a {adj} {animal}. The {animal} {verb} a {obj} in the {place}. '
    '{name} said "Good {animal}!" and they played together.',
    "One day, {name} and {name2} went to the {place}. They {verb} a {adj} {obj}. "
    '{name2} said "Let us share it." So they did, and they were {adj2}.',
    "There was a {adj} {obj} in the {place}. {name} {verb} it and showed the {animal}. "
    "The {animal} was {adj2}. The end.",
]


def synthetic_stories(num_stories: int, seed: int = 0) -> list[str]:
    """Deterministic TinyStories-like corpus for offline serving and tests."""
    rng = np.random.RandomState(seed)
    stories = []
    for _ in range(num_stories):
        t = _TEMPLATES[rng.randint(len(_TEMPLATES))]
        name, name2 = rng.choice(_NAMES, 2, replace=False)
        stories.append(
            t.format(
                name=name,
                name2=name2,
                animal=rng.choice(_ANIMALS),
                adj=rng.choice(_ADJS),
                adj2=rng.choice(_ADJS),
                obj=rng.choice(_OBJECTS),
                place=rng.choice(_PLACES),
                verb=rng.choice(_VERBS),
            )
        )
    return stories


# GPT-2-style pieces: a word with optional leading space, a punctuation run
# with optional leading space, or whitespace; "".join(pieces) is the text.
_PIECE_RE = re.compile(r" ?[A-Za-z0-9']+| ?[^A-Za-z0-9\s]+|\s")

_UNK, _EOS, _PAD = 0, 1, 2  # pad at 2: every recipe sets pad_token_id = 2


class WordTokenizer:
    """Word-level tokenizer with the GPT2Tokenizer surface the recipes use:
    callable batching with padding and truncation, `decode`, `vocab_size`,
    `eos_token_id`, settable `pad_token_id`. Unknown pieces degrade to
    per-character tokens, so any text round-trips."""

    special_tokens = ["<|unk|>", "<|endoftext|>", "<|pad|>"]

    def __init__(self, corpus: list[str], model_max_length: int = 512):
        pieces = set()
        for text in corpus:
            pieces.update(_PIECE_RE.findall(text))
        chars = {chr(c) for c in range(32, 127)} | {"\n"}
        vocab_tokens = list(self.special_tokens) + sorted(chars | pieces)
        self._id_to_token = vocab_tokens
        self._token_to_id = {t: i for i, t in enumerate(vocab_tokens)}
        self.model_max_length = model_max_length
        self.pad_token_id = _PAD
        self.eos_token_id = _EOS
        self.unk_token_id = _UNK

    @property
    def vocab_size(self) -> int:
        return len(self._id_to_token)

    def _encode_one(self, text: str) -> list[int]:
        ids = []
        for piece in _PIECE_RE.findall(text):
            tid = self._token_to_id.get(piece)
            if tid is not None:
                ids.append(tid)
            else:
                ids.extend(self._token_to_id.get(ch, _UNK) for ch in piece)
        return ids

    def __call__(self, texts, padding: Union[bool, str, None] = None,
                 max_length: Optional[int] = None, truncation: bool = False) -> dict:
        """Lists of ids and masks; with `padding="max_length"` the int32
        arrays `[N, max_length]`, padded with `pad_token_id` and mask 0."""
        if isinstance(texts, str):
            texts = [texts]
        max_length = max_length or self.model_max_length
        encoded = [self._encode_one(t) for t in texts]
        if truncation:
            encoded = [ids[:max_length] for ids in encoded]
        if padding != "max_length":
            return {"input_ids": encoded,
                    "attention_mask": [[1] * len(ids) for ids in encoded]}
        pad = max_length - np.asarray([len(ids) for ids in encoded])
        return {
            "input_ids": np.asarray([ids + [self.pad_token_id] * p
                                     for ids, p in zip(encoded, pad)], dtype=np.int32),
            "attention_mask": np.asarray([[1] * len(ids) + [0] * p
                                          for ids, p in zip(encoded, pad)], dtype=np.int32),
        }

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        pieces = []
        specials = {_UNK, _EOS, self.pad_token_id}
        for tid in np.asarray(ids).reshape(-1).tolist():
            if skip_special_tokens and tid in specials:
                continue
            if 0 <= tid < len(self._id_to_token):
                pieces.append(self._id_to_token[tid])
        return "".join(pieces)


_FIXTURE_TRAIN_SIZE = 4096
_FIXTURE_VALIDATION_SIZE = 256


@functools.lru_cache(maxsize=1)
def _fixture_corpus() -> tuple[list[str], list[str]]:
    """The deterministic (train, validation) fixture corpus, built once per
    process. Callers treat the lists as read-only."""
    return (
        synthetic_stories(_FIXTURE_TRAIN_SIZE, seed=0),
        synthetic_stories(_FIXTURE_VALIDATION_SIZE, seed=1),
    )


def get_tokenizer(max_length: int = 512) -> WordTokenizer:
    """The offline tokenizer: `WordTokenizer` over the fixture corpus, the
    fallback branch of tpukit's `get_tokenizer`. The port never reaches
    for the HF hub."""
    train_texts, validation_texts = _fixture_corpus()
    return WordTokenizer(train_texts + validation_texts, model_max_length=max_length)


class ListDataset:
    """A list of {"text": str} rows (the fixture's stand-in for the HF
    dataset object)."""

    def __init__(self, texts: list[str]):
        self.texts = texts

    def __len__(self):
        return len(self.texts)

    def __getitem__(self, i):
        return {"text": self.texts[i]}


def _parse_slice(n: int, slice_size: Optional[Union[str, int]]) -> int:
    """The `train[:{slice_size}]` split-string semantics: percent strings
    ("50%"), count strings ("1000") or ints."""
    if slice_size is None or slice_size == "":
        return n
    if isinstance(slice_size, str) and slice_size.endswith("%"):
        return int(n * float(slice_size[:-1]) / 100.0)
    return min(int(slice_size), n)


def get_dataset(slice_size: Optional[Union[str, int]] = None):
    """(train, validation) of the fixture corpus: the train split sliced by
    `slice_size`, validation always whole. The port has no hub access;
    TinyStories itself waits until its files are in the repository."""
    train_texts, validation_texts = _fixture_corpus()
    n = _parse_slice(len(train_texts), slice_size)
    return ListDataset(train_texts[:n]), ListDataset(validation_texts)


class ArrayDataset:
    """A tokenized dataset as dense numpy arrays, `transform_dataset`'s
    output."""

    def __init__(self, input_ids: np.ndarray, attention_mask: np.ndarray):
        self.input_ids = input_ids
        self.attention_mask = attention_mask

    def __len__(self):
        return self.input_ids.shape[0]

    def __getitem__(self, idx):
        return {"input_ids": self.input_ids[idx], "attention_mask": self.attention_mask[idx]}


def transform_dataset(dataset, tokenizer, max_length: int = 512) -> ArrayDataset:
    """Tokenize with max-length padding and truncation; int32 arrays out."""
    texts = [dataset[i]["text"] for i in range(len(dataset))]
    out = tokenizer(texts, padding="max_length", max_length=max_length, truncation=True)
    return ArrayDataset(np.asarray(out["input_ids"], dtype=np.int32),
                        np.asarray(out["attention_mask"], dtype=np.int32))

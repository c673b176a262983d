"""Data pipeline of the port, numpy only: a byte-level tokenizer over a
real in-repo text corpus and deterministic sharded batching with exact
step-resume (the fault-tolerance contract: restoring step N reproduces the
batches the failed run would have seen). It is the port's own copy of the
reference's ``repro/data/pipeline.py``: both read the same files in the
same order and give the same batches.

The corpus is the repository's own source + docs (real, offline text). The
paper's calibration protocol (128 sequences x 2048 tokens from WikiText2)
maps onto :func:`calibration_batch` with the same sampling structure.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

PAD, BOS, EOS = 256, 257, 258
VOCAB = 260  # 256 bytes + specials, padded even


def load_corpus(root: Optional[str] = None, max_bytes: int = 8_000_000) -> np.ndarray:
    """Concatenate repo text files into a uint16 token array (byte-level)."""
    root_p = Path(root) if root else Path(__file__).resolve().parents[3]
    chunks = []
    total = 0
    exts = (".py", ".md", ".txt", ".toml", ".json")
    for p in sorted(root_p.rglob("*")):
        if p.suffix not in exts or not p.is_file() or "artifacts" in p.parts:
            continue
        try:
            b = p.read_bytes()
        except OSError:
            continue
        chunks.append(np.frombuffer(b, np.uint8).astype(np.uint16))
        chunks.append(np.array([EOS], np.uint16))
        total += len(b)
        if total > max_bytes:
            break
    if not chunks:
        raise FileNotFoundError(f"no corpus files under {root_p}")
    return np.concatenate(chunks)


@dataclasses.dataclass
class TokenDataset:
    """Deterministic LM batches over a flat token stream.

    Batch for step ``i`` is a pure function of (i, seed, shape) — resuming at
    step N after a failure replays exactly the stream the lost run saw.
    Multi-host: each host reads only its ``host_id`` slice of the batch.
    """

    tokens: np.ndarray
    batch: int
    seq: int
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1

    def __post_init__(self):
        assert self.batch % self.n_hosts == 0
        self._n = len(self.tokens)
        rng = np.random.default_rng(self.seed)
        self._offset = int(rng.integers(0, self._n))

    def batch_at(self, step: int) -> dict:
        b_loc = self.batch // self.n_hosts
        per_step = self.batch * self.seq
        out = np.empty((b_loc, self.seq), np.int32)
        for j in range(b_loc):
            row = self.host_id * b_loc + j
            start = (self._offset + step * per_step + row * self.seq) % self._n
            idx = (start + np.arange(self.seq)) % self._n
            out[j] = self.tokens[idx]
        return {"tokens": out, "labels": out.copy()}

    def iterate(self, start_step: int = 0) -> Iterator[dict]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


def calibration_batch(tokens: np.ndarray, n_samples: int = 128, seq: int = 2048,
                      seed: int = 0) -> np.ndarray:
    """The paper's calibration sampling: n random sequences of `seq` tokens."""
    rng = np.random.default_rng(seed)
    n = len(tokens)
    out = np.empty((n_samples, seq), np.int32)
    for i in range(n_samples):
        s = int(rng.integers(0, n - seq - 1))
        out[i] = tokens[s : s + seq]
    return out

"""Deterministic synthetic token stream for LM training examples/smokes:
a Zipf-distributed 'corpus' with Markov bigram structure so losses fall
measurably during the few-hundred-step example runs.

The port's own copy of ``repro.data.tokens`` (numpy only): for the same
seed it yields the same token ids and cursors as the reference."""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


class TokenStream:
    def __init__(self, vocab: int, seed: int = 0, zipf_a: float = 1.2,
                 markov_states: int = 64):
        self.vocab = vocab
        self.rng = np.random.default_rng(seed)
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        base = ranks ** (-zipf_a)
        self.base = base / base.sum()
        # a few per-state distributions (permuted base) => learnable bigrams
        self.n_states = markov_states
        self.perms = [self.rng.permutation(vocab)
                      for _ in range(markov_states)]

    def sample(self, n: int) -> np.ndarray:
        out = np.empty(n, np.int64)
        state = 0
        # vectorized in blocks for speed; state changes per block
        i = 0
        while i < n:
            blk = min(512, n - i)
            p = self.base[np.argsort(self.perms[state])]
            out[i:i + blk] = self.rng.choice(self.vocab, size=blk, p=p)
            state = int(out[i + blk - 1]) % self.n_states
            i += blk
        return out

    def batches(self, batch: int, seq: int) -> Iterator[np.ndarray]:
        while True:
            yield self.sample(batch * (seq + 1)).reshape(batch, seq + 1)


class SeekableTokenBatches:
    """The LM batch stream with a JSON-able cursor, so a resumed run
    consumes *exactly* the token sequence it would have seen without the
    interruption.

    The cursor captures the generator's bit-generator state plus the
    batch index; ``seek`` restores it in O(1) (no replay).  ``seek`` with
    a bare ``{"step": n}`` cursor (no rng state) falls back to
    fast-forwarding ``n`` batches from the seeded start — equivalent,
    O(n), and what ``lm_batch_iterator(start_step=...)`` uses."""

    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0):
        self.stream = TokenStream(vocab, seed)
        self.vocab, self.batch, self.seq, self.seed = vocab, batch, seq, seed
        self.step = 0

    def next_batch(self) -> Tuple[np.ndarray, np.ndarray]:
        arr = self.stream.sample(
            self.batch * (self.seq + 1)).reshape(self.batch, self.seq + 1)
        self.step += 1
        return arr[:, :-1].astype(np.int32), arr[:, 1:].astype(np.int32)

    def cursor(self) -> dict:
        state = self.stream.rng.bit_generator.state
        # numpy state dicts hold plain ints/strs at depth <= 2: JSON-able
        return {"step": self.step, "rng_state": state}

    def seek(self, cursor: dict) -> None:
        step = int(cursor["step"])
        if "rng_state" in cursor and cursor["rng_state"] is not None:
            self.stream = TokenStream(self.vocab, self.seed)
            self.stream.rng.bit_generator.state = cursor["rng_state"]
            self.step = step
        else:                       # replay from the seeded start
            self.stream = TokenStream(self.vocab, self.seed)
            self.step = 0
            for _ in range(step):
                self.next_batch()

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        while True:
            yield self.next_batch()


def lm_batch_iterator(vocab: int, batch: int, seq: int, seed: int = 0,
                      start_step: int = 0
                      ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yields (tokens (B,S), labels (B,S)) int32 pairs.  ``start_step``
    seeks past the first N batches, yielding the same sequence a fresh
    iterator would from batch N on."""
    it = SeekableTokenBatches(vocab, batch, seq, seed)
    if start_step:
        it.seek({"step": int(start_step)})
    return iter(it)

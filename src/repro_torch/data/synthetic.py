"""Synthetic data: a learnable LM stream and a BABILong-style needle-QA task.

The needle task is the quality probe for ARMT memory (paper Tables 3/4): a
(key, value) fact is planted in filler text, the query comes at the end —
long-context accuracy requires carrying the fact across segments in memory.
All generators are deterministic in (seed, index) for exact resume after
restart (fault tolerance: data order is reproducible from the step counter).
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

# reserved control tokens (vocab must be > 16)
PAD, BOS, FACT, QUERY, ANSWER = 0, 1, 2, 3, 4
N_RESERVED = 8


def lm_stream(vocab: int, batch: int, seq_len: int, *, seed: int = 0,
              start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Markov-chain token stream — learnable structure for loss-drop tests."""
    V = vocab - N_RESERVED
    rng0 = np.random.default_rng(seed)
    trans = rng0.dirichlet(np.ones(64) * 0.1, size=V)   # sparse transitions
    nxt = np.argsort(-trans, axis=1)[:, :64]
    step = start_step
    while True:
        rng = np.random.default_rng((seed, step))
        toks = np.zeros((batch, seq_len + 1), np.int64)
        toks[:, 0] = rng.integers(0, V, batch)
        choice = rng.integers(0, 64, (batch, seq_len))
        explore = rng.random((batch, seq_len)) < 0.1
        rand = rng.integers(0, V, (batch, seq_len))
        for t in range(seq_len):
            nt = nxt[toks[:, t], choice[:, t]]
            toks[:, t + 1] = np.where(explore[:, t], rand[:, t], nt)
        toks += N_RESERVED
        yield {"tokens": toks[:, :-1].astype(np.int32),
               "labels": toks[:, 1:].astype(np.int32)}
        step += 1


def needle_qa(vocab: int, batch: int, seq_len: int, *, seed: int = 0,
              start_step: int = 0, n_keys: int = 64,
              needle_region: Optional[tuple] = None
              ) -> Iterator[Dict[str, np.ndarray]]:
    """[BOS] filler... [FACT key value] filler... [QUERY key ANSWER] -> value.

    Loss is masked to the answer position only; 'answer' field gives the
    gold token for exact-match accuracy.
    """
    V = vocab - N_RESERVED
    n_keys = min(n_keys, V // 2)
    keys = np.arange(n_keys) + N_RESERVED
    vals_base = n_keys
    step = start_step
    lo, hi = needle_region or (0.05, 0.7)
    while True:
        rng = np.random.default_rng((seed, step, 17))
        toks = rng.integers(2 * n_keys + N_RESERVED, max(V, 2 * n_keys + 9)
                            + N_RESERVED, (batch, seq_len)).astype(np.int64)
        ki = rng.integers(0, n_keys, batch)
        key = keys[ki]
        val = (vals_base + rng.integers(0, n_keys, batch) + N_RESERVED)
        pos = rng.integers(int(seq_len * lo), int(seq_len * hi), batch)
        rows = np.arange(batch)
        toks[:, 0] = BOS
        toks[rows, pos] = FACT
        toks[rows, pos + 1] = key
        toks[rows, pos + 2] = val
        toks[rows, seq_len - 3] = QUERY
        toks[rows, seq_len - 2] = key
        toks[rows, seq_len - 1] = ANSWER
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = val                    # predict value after ANSWER
        mask = np.zeros((batch, seq_len), np.float32)
        mask[rows, seq_len - 1] = 1.0
        yield {"tokens": toks.astype(np.int32),
               "labels": labels.astype(np.int32),
               "loss_mask": mask,
               "answer": val.astype(np.int32)}
        step += 1

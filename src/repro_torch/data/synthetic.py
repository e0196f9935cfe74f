"""Synthetic language-classification tasks mirroring the paper's 8 datasets.

No external datasets are downloadable in this environment, so each paper task
is mirrored by a synthetic generator with the same *shape*: C classes, a
vocabulary, sequence length, and a learnable class signal. Sequences are
drawn from class-conditioned token distributions (a mixture of a shared
background unigram model and per-class "keyword" tokens), which gives tasks
that are trivially separable by a full-capacity learner but produce smooth,
optimizer-sensitive learning curves — exactly what the paper's comparisons
(SPRY vs FedAvg vs zero-order) need.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticTask:
    name: str
    n_classes: int
    seq_len: int
    vocab: int
    n_train: int
    n_test: int
    signal: float = 0.25     # fraction of positions carrying class keywords


# name -> (C, seq, n_train, n_test): mirrors Appendix B scale ratios (scaled down)
TASKS = {
    # high-signal toy task for fast CI convergence checks
    "toy": SyntheticTask("toy", 2, 16, 256, 2000, 400, signal=0.6),
    "agnews": SyntheticTask("agnews", 4, 64, 512, 8000, 1000),
    "sst2": SyntheticTask("sst2", 2, 32, 512, 4000, 500),
    "yelp": SyntheticTask("yelp", 2, 64, 512, 8000, 1000),
    "yahoo": SyntheticTask("yahoo", 10, 64, 512, 10000, 1000),
    "snli": SyntheticTask("snli", 3, 48, 512, 6000, 800),
    "mnli": SyntheticTask("mnli", 3, 48, 512, 6000, 800),
    "squadv2": SyntheticTask("squadv2", 2, 128, 512, 4000, 500),
    "multirc": SyntheticTask("multirc", 2, 96, 512, 3000, 400),
}


def make_task(name: str, seed: int = 0, vocab: int | None = None,
              seq_len: int | None = None):
    """Generate (x_train, y_train, x_test, y_test) numpy arrays for a task."""
    spec = TASKS[name]
    vocab = vocab or spec.vocab
    seq_len = seq_len or spec.seq_len
    rng = np.random.default_rng(seed)

    # shared background unigram distribution (zipf-ish)
    ranks = np.arange(1, vocab + 1)
    bg = (1.0 / ranks) / np.sum(1.0 / ranks)
    # per-class keyword sets (disjoint slices of the vocab tail)
    kw_per_class = max(4, vocab // (8 * spec.n_classes))
    keywords = [
        rng.choice(vocab // 2, size=kw_per_class, replace=False) + vocab // 2
        for _ in range(spec.n_classes)
    ]

    def sample(n):
        y = rng.integers(0, spec.n_classes, size=n)
        x = rng.choice(vocab, size=(n, seq_len), p=bg)
        mask = rng.random((n, seq_len)) < spec.signal
        for c in range(spec.n_classes):
            rows = y == c
            kw = rng.choice(keywords[c], size=(int(rows.sum()), seq_len))
            x[rows] = np.where(mask[rows], kw, x[rows])
        return x.astype(np.int32), y.astype(np.int32)

    x_tr, y_tr = sample(spec.n_train)
    x_te, y_te = sample(spec.n_test)
    return x_tr, y_tr, x_te, y_te

"""Client-side batching for the FL simulator."""
from __future__ import annotations

import numpy as np


class ClientDataset:
    """A client's shard of a task: indices into the global arrays."""

    def __init__(self, x: np.ndarray, y: np.ndarray, indices: np.ndarray):
        self.x = x
        self.y = y
        self.indices = np.asarray(indices)

    def __len__(self):
        return len(self.indices)

    def sample_batch(self, rng: np.random.Generator, batch_size: int):
        take = rng.choice(self.indices, size=batch_size,
                          replace=len(self.indices) < batch_size)
        return self.x[take], self.y[take]


def batch_iterator(x, y, batch_size, rng: np.random.Generator, epochs=1):
    n = len(x)
    for _ in range(epochs):
        perm = rng.permutation(n)
        for i in range(0, n - batch_size + 1, batch_size):
            take = perm[i:i + batch_size]
            yield x[take], y[take]


def stack_client_batches(clients, rng, batch_size):
    """Sample one batch per client and stack to (M, B, S) for the vmapped
    round step."""
    xs, ys = [], []
    for c in clients:
        bx, by = c.sample_batch(rng, batch_size)
        xs.append(bx)
        ys.append(by)
    return np.stack(xs), np.stack(ys)

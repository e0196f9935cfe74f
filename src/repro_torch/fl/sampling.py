"""Client sampling per FL round."""
from __future__ import annotations

import numpy as np


def sample_clients(rng: np.random.Generator, n_total: int, n_per_round: int):
    return rng.choice(n_total, size=min(n_per_round, n_total), replace=False)

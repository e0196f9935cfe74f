"""Dirichlet client partitioning (paper §5 / Appendix B).

``dirichlet_partition`` splits a labelled dataset across N clients where the
per-client class mixture is drawn from Dir(alpha). alpha=1.0 reproduces the
paper's homogeneous split, alpha=0.1 the heterogeneous split.
"""
from __future__ import annotations

import numpy as np


def dirichlet_partition(labels: np.ndarray, n_clients: int, alpha: float,
                        seed: int = 0, min_per_client: int = 2):
    """Return list of index arrays, one per client.

    Implementation: for each class, split its sample indices among clients
    with proportions ~ Dir(alpha) (the standard Hsu et al. protocol the paper
    cites via [37]).
    """
    rng = np.random.default_rng(seed)
    labels = np.asarray(labels)
    n_classes = int(labels.max()) + 1
    client_indices = [[] for _ in range(n_clients)]
    for c in range(n_classes):
        idx = np.flatnonzero(labels == c)
        rng.shuffle(idx)
        props = rng.dirichlet(np.full(n_clients, alpha))
        # cumulative split points
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for client, part in enumerate(np.split(idx, cuts)):
            client_indices[client].extend(part.tolist())
    out = []
    for client in range(n_clients):
        idx = np.array(sorted(client_indices[client]), dtype=np.int64)
        out.append(idx)
    # guarantee every client has at least min_per_client samples (steal from
    # the largest client) so local training is well-defined
    sizes = np.array([len(i) for i in out])
    for client in range(n_clients):
        while len(out[client]) < min_per_client:
            donor = int(np.argmax([len(i) for i in out]))
            out[client] = np.append(out[client], out[donor][-1])
            out[donor] = out[donor][:-1]
    return out


def heterogeneity_coefficients(labels: np.ndarray, parts, alpha: float):
    """The paper's alpha_{m,c} = n_c/|D| - n_{m,c}*alpha_c/|D_m| (Thm 4.1).

    Returns an (n_clients, n_classes) array. Under the paper's convention
    alpha_c = 1.0 for the homogeneous split; we pass the Dirichlet
    concentration used for the split.
    """
    labels = np.asarray(labels)
    n_classes = int(labels.max()) + 1
    n = len(labels)
    global_frac = np.array([(labels == c).sum() / n for c in range(n_classes)])
    coeffs = np.zeros((len(parts), n_classes))
    for m, idx in enumerate(parts):
        lm = labels[idx]
        dm = max(1, len(lm))
        for c in range(n_classes):
            coeffs[m, c] = global_frac[c] - (lm == c).sum() * alpha / dm
    return coeffs

"""Paged multi-tenant LoRA adapter cache for serving. Port of
``repro/launch/adapter_cache.py`` (``SyntheticAdapterStore``,
``AdapterCache``).

A deployment finetunes one PEFT tree per client (the paper's federated
personalisation); serving then decodes requests from many clients against
one frozen base. The cache keeps ``capacity`` adapter pages resident in
page-stacked buffers, each LoRA factor stored as (P, din, r) / (P, r, dout)
(with the layer axis first for the stacked groups), and evicts the least
recently used unpinned page on overflow. Where the reference rebinds its
buffers functionally, a page is written here in place.

Stores supply the per-client trees: ``SyntheticAdapterStore`` fabricates
deterministic distinct adapters. Reading adapters from per-client
checkpoints (the reference's ``CheckpointAdapterStore``) waits for the
port's checkpoint module.
"""
from __future__ import annotations

from collections import OrderedDict

import torch

from repro_torch.configs import SpryConfig
from repro_torch.core.forward_grad import fold_in
from repro_torch.obs import NULL
from repro_torch.peft import init_peft
from repro_torch.utils.pytree import tree_leaves, tree_paths, tree_unflatten_like

# peft groups whose LoRA factors are stacked on a leading n_layers axis
_STACKED_GROUPS = ("layers", "enc_layers")


class SyntheticAdapterStore:
    """Deterministic fabricated adapters on ``device``: adapter ``aid`` is
    ``init_peft`` from a generator seeded with ``fold_in(seed, aid)``, with
    its B factors drawn as 0.05*N(0,1) (``init_peft`` zeros them; identity
    adapters would make every tenant identical and hide routing bugs). The
    same (seed, aid) gives the same tree on every call."""

    def __init__(self, cfg, spry_cfg=None, seed: int = 0, device="cpu"):
        self.cfg = cfg
        self.spry_cfg = spry_cfg or SpryConfig()
        self.seed = seed
        self.device = torch.device(device)

    def template(self):
        return self.load(0)

    def load(self, aid: int):
        key = fold_in(self.seed, aid)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(key)
        tree = init_peft(self.cfg, gen, self.spry_cfg)
        leaves = []
        for counter, (path, leaf) in enumerate(tree_paths(tree), start=1):
            if path[-1] == "B":
                gen.manual_seed(fold_in(key, counter))
                leaf = (0.05 * torch.randn(leaf.shape, generator=gen,
                                           device=self.device)).to(leaf.dtype)
            leaves.append(leaf)
        return tree_unflatten_like(tree, leaves)


class AdapterCache:
    """``capacity`` resident adapter pages with LRU eviction and lazy
    materialisation from ``store``.

    ``acquire(aid)`` returns the adapter's page index, loading and evicting
    as needed; ``pin``/``unpin`` protect pages referenced by in-flight
    requests from eviction. ``multi_peft(row_pages)`` builds the
    index-augmented peft tree the models' multi-adapter projection route
    consumes; ``page_tree(page)`` slices one page back out as a plain
    single-adapter tree (equal to what the store loaded).
    """

    def __init__(self, store, capacity: int, telemetry=None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.store = store
        self.capacity = capacity
        self._stacked = {}            # group -> target -> {"A","B"} buffers
        self._pages = OrderedDict()   # aid -> page, LRU order (oldest first)
        self._free = list(range(capacity))
        self._pins = {}               # aid -> refcount
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        # the ints above stay the source of truth (stats() is telemetry-free
        # API); the counters mirror them into the telemetry registry
        tel = telemetry if telemetry is not None else NULL
        self.telemetry = tel
        self._tc_hits = tel.counter("adapter_cache.hits")
        self._tc_misses = tel.counter("adapter_cache.misses")
        self._tc_evictions = tel.counter("adapter_cache.evictions")
        self._tc_pins = tel.counter("adapter_cache.pins")
        self._tg_resident = tel.gauge("adapter_cache.resident")

        template = store.template()
        self.device = tree_leaves(template)[0].device
        for group, gtree in template.items():
            if group == "head":
                continue   # classifier head is not a per-row LoRA page
            paged = {}
            for target, pair in gtree.items():
                if not (isinstance(pair, dict) and set(pair) == {"A", "B"}):
                    raise ValueError(
                        f"AdapterCache pages LoRA trees only; "
                        f"{group}/{target} has entries {sorted(pair)}")
                axis = 1 if group in _STACKED_GROUPS else 0
                paged[target] = {
                    name: torch.zeros(
                        leaf.shape[:axis] + (capacity,) + leaf.shape[axis:],
                        dtype=leaf.dtype, device=leaf.device)
                    for name, leaf in pair.items()
                }
            self._stacked[group] = paged

    # -- residency -----------------------------------------------------------

    def resident(self):
        """aids currently resident, least-recently-used first."""
        return list(self._pages)

    def acquire(self, aid: int) -> int:
        """Page index for ``aid``, materialising (and evicting) if needed."""
        if aid in self._pages:
            self.hits += 1
            self._tc_hits.inc()
            self._pages.move_to_end(aid)
            return self._pages[aid]
        self.misses += 1
        self._tc_misses.inc()
        if self._free:
            page = self._free.pop()
        else:
            victim = next((a for a in self._pages
                           if self._pins.get(a, 0) == 0), None)
            if victim is None:
                raise RuntimeError(
                    "all resident adapter pages are pinned by in-flight "
                    "requests; raise the cache capacity or max batch")
            page = self._pages.pop(victim)
            self.evictions += 1
            self._tc_evictions.inc()
        with self.telemetry.span("adapter_cache.load", aid=aid):
            self._materialize(page, self.store.load(aid))
        self._pages[aid] = page
        self._tg_resident.set(len(self._pages))
        return page

    def pin(self, aid: int) -> int:
        page = self.acquire(aid)
        self._pins[aid] = self._pins.get(aid, 0) + 1
        self._tc_pins.inc()
        return page

    def unpin(self, aid: int) -> None:
        n = self._pins.get(aid, 0)
        if n <= 1:
            self._pins.pop(aid, None)
        else:
            self._pins[aid] = n - 1

    def _materialize(self, page: int, tree) -> None:
        for group, paged in self._stacked.items():
            gtree = tree[group]
            for target, pair in paged.items():
                for name, buf in pair.items():
                    dst = buf[:, page] if group in _STACKED_GROUPS else buf[page]
                    dst.copy_(gtree[target][name])

    # -- views ---------------------------------------------------------------

    def page_tree(self, page: int):
        """Plain single-adapter peft tree sliced from one resident page
        (views of the page buffers)."""
        out = {}
        for group, paged in self._stacked.items():
            out[group] = {
                target: {
                    name: (buf[:, page] if group in _STACKED_GROUPS
                           else buf[page])
                    for name, buf in pair.items()
                }
                for target, pair in paged.items()
            }
        return out

    def multi_peft(self, row_pages):
        """Index-augmented peft tree for a batch whose row b reads page
        ``row_pages[b]``: every LoRA entry becomes {"A": page-stacked,
        "B": page-stacked, "idx": per-row pages}; ``models.common.proj``
        routes such entries through the multi-adapter projection. Stacked
        groups carry idx as (L, B), so a layer slice gives (B,) beside the
        (P, din, r) factors."""
        idx = torch.as_tensor(row_pages, dtype=torch.int32).to(self.device)
        out = {}
        for group, paged in self._stacked.items():
            if group in _STACKED_GROUPS:
                L = next(iter(next(iter(paged.values())).values())).shape[0]
                gidx = idx[None, :].expand(L, idx.shape[0])
            else:
                gidx = idx
            out[group] = {
                target: dict(pair, idx=gidx)
                for target, pair in paged.items()
            }
        return out

    def stats(self):
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "resident": len(self._pages), "capacity": self.capacity,
                "pinned": sum(self._pins.values())}

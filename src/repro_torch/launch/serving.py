"""Multi-tenant continuous-batching serving engine. Port of
``repro/launch/serving.py`` (``Request``, ``_scatter_row``,
``ServingEngine``).

Requests arrive bound to per-client LoRA adapters (``adapter_id`` into an
``AdapterCache``); the engine decodes up to ``max_batch`` requests in one
batched decode step per token, each row reading its own adapter page
through the multi-adapter projection (the ``lora_dual_multi`` kernel on the
card). New requests are admitted into free rows of the in-flight batch
without draining it: admission runs a B=1 prefill of the new prompt,
writes the resulting row cache into the batch cache in place, and the next
engine step decodes old and new rows together, with per-row positions,
ring slots and adapters.

Per-row outputs match ``serve.greedy_generate`` run per request: rows are
independent through every batched op, the admission prefill is the pass
greedy runs, and the token protocol is the same (first token from the
prefill logits, each decode step appends one).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.launch.serve import build_serve_fns, can_fuse_prefill, tokenwise_prefill
from repro_torch.models import get_model
from repro_torch.obs import NULL


@dataclasses.dataclass
class Request:
    request_id: str
    adapter_id: int
    prompt: np.ndarray            # (P,) int32 prompt tokens
    max_new_tokens: int
    frames: Optional[np.ndarray] = None   # encoder frames (audio family)


def _scatter_row(big, row, b):
    """Write the B=1 ``row`` cache into batch row ``b`` of ``big``, in
    place. Every cache leaf of the ported families carries batch on axis 1
    (after the layer axis)."""
    for key, buf in big.items():
        buf[:, b].copy_(row[key][:, 0])
    return big


class ServingEngine:
    """Request-driven continuous-batching decoder over one frozen base.

    ``adapter_cache``: an ``AdapterCache``; each in-flight row pins its
    adapter's page (pages of completed requests become evictable again).
    ``cache_len`` bounds prompt + generation length for every request. The
    engine runs on the device of ``base``.
    """

    def __init__(self, cfg, base, adapter_cache, max_batch: int,
                 cache_len: int, fused_prefill: bool = True,
                 telemetry=None):
        self.cfg = cfg
        self.base = base
        self.adapters = adapter_cache
        self.max_batch = max_batch
        self.cache_len = cache_len
        self.fused_prefill = fused_prefill
        self.model = get_model(cfg)
        self.device = base["embed"].device
        # host-side telemetry on returned token ids and timestamps only
        tel = telemetry if telemetry is not None else NULL
        self.telemetry = tel
        self._tc_requests = tel.counter("serve.requests")
        self._tc_tokens = tel.counter("serve.gen_tokens")
        self._tc_steps = tel.counter("serve.decode_steps")
        self._tg_queue = tel.gauge("serve.queue_depth")
        self._tg_inflight = tel.gauge("serve.in_flight")
        self._tg_tps = tel.gauge("serve.decode_tok_per_sec")
        self._th_ttft = tel.histogram("serve.ttft_s")
        self._th_latency = tel.histogram("serve.request_latency_s")
        self._th_step = tel.histogram("serve.decode_step_s")
        self._t_submit = {}             # request_id -> perf_counter stamp
        self._ttft = {}                 # request_id -> observed TTFT
        self._decode_tokens = 0         # steady-state accounting (decode
        self._decode_time = 0.0         # steps only, admissions excluded)

        fns = build_serve_fns(cfg, self.model)
        self._decode = fns["decode"]          # batch and B=1 decode alike
        self._prefill1 = fns["prefill"]

        self.cache = self.model.init_cache(cfg, max_batch, cache_len,
                                           device=self.device)
        self._queue = deque()
        # host-side per-row state
        self._active = np.zeros(max_batch, bool)
        self._pos = np.zeros(max_batch, np.int32)
        self._plen = np.zeros(max_batch, np.int32)
        self._tok = np.zeros(max_batch, np.int32)
        self._page = np.zeros(max_batch, np.int32)
        self._aid = np.zeros(max_batch, np.int64)
        self._remaining = np.zeros(max_batch, np.int32)
        self._rid = [None] * max_batch
        self.outputs = {}
        self.steps = 0

    # -- admission -----------------------------------------------------------

    def submit(self, request: Request) -> None:
        if self.telemetry.enabled:
            self._t_submit[request.request_id] = time.perf_counter()
        self._queue.append(request)
        self._tg_queue.set(len(self._queue))

    def _admit(self, b: int, req: Request) -> None:
        if req.frames is not None:
            raise NotImplementedError(
                "encoder frames need the encoder-decoder family (a later "
                "slice); serve them with python -m repro.launch.serve")
        prompt = torch.as_tensor(np.asarray(req.prompt, np.int32).reshape(1, -1),
                                 device=self.device)
        P = prompt.shape[1]
        if P + req.max_new_tokens - 1 > self.cache_len:
            raise ValueError(
                f"request {req.request_id!r}: prompt {P} + "
                f"{req.max_new_tokens} new tokens exceeds cache_len "
                f"{self.cache_len}")
        with self.telemetry.span("serve.admit", request=req.request_id,
                                 prompt_len=int(P)):
            page = self.adapters.pin(req.adapter_id)
            peft1 = self.adapters.page_tree(page)
            cache1 = self.model.init_cache(self.cfg, 1, self.cache_len,
                                           device=self.device)
            if self.fused_prefill and can_fuse_prefill(self.cfg, self.model,
                                                       cache1, P):
                logits, cache1 = self._prefill1(self.base, peft1, cache1, prompt)
            else:
                logits, cache1 = tokenwise_prefill(
                    self.cfg, self.model, self.base, peft1, cache1, prompt,
                    decode=self._decode)
            _scatter_row(self.cache, cache1, b)
            t0 = int(torch.argmax(logits[0]))
        self._active[b] = True
        self._pos[b] = P
        self._plen[b] = P
        self._tok[b] = t0
        self._page[b] = page
        self._aid[b] = req.adapter_id
        self._remaining[b] = req.max_new_tokens - 1
        self._rid[b] = req.request_id
        self.outputs[req.request_id] = [t0]
        if self.telemetry.enabled:
            # the first token exists here (the prefill logits produced it):
            # time-to-first-token runs from submit to this point
            ttft = time.perf_counter() - self._t_submit.get(
                req.request_id, time.perf_counter())
            self._ttft[req.request_id] = ttft
            self._th_ttft.observe(ttft)
            self._tc_requests.inc()
            self._tg_queue.set(len(self._queue))
        if self._remaining[b] == 0:
            self._finish(b)

    def _finish(self, b: int) -> None:
        self._active[b] = False
        self.adapters.unpin(int(self._aid[b]))
        if self.telemetry.enabled:
            rid = self._rid[b]
            done = time.perf_counter()
            latency = done - self._t_submit.pop(rid, done)
            self._th_latency.observe(latency)
            n_tok = len(self.outputs.get(rid, ()))
            self._tc_tokens.add(n_tok)
            self.telemetry.event(
                "request",
                request_id=rid,
                adapter_id=int(self._aid[b]),
                prompt_len=int(self._plen[b]),
                gen_tokens=n_tok,
                ttft_s=round(self._ttft.pop(rid, float("nan")), 6),
                latency_s=round(latency, 6),
                tok_per_sec=(round(n_tok / latency, 3) if latency > 0
                             else None),
            )
        self._rid[b] = None

    # -- stepping ------------------------------------------------------------

    def step(self) -> int:
        """Admit waiting requests into free rows, then run ONE batched
        decode step over the in-flight rows. Returns the number of rows
        still active (0 -> drained)."""
        for b in range(self.max_batch):
            if not self._queue:
                break
            if not self._active[b]:
                self._admit(b, self._queue.popleft())
        if not self._active.any():
            return 0

        # inactive rows ride along with page 0 / pos 0 / token 0; every
        # batched op is row-independent, so their garbage never reaches an
        # active row, and their outputs are dropped here
        pages = np.where(self._active, self._page, 0)
        peft = self.adapters.multi_peft(pages)
        tok = torch.as_tensor(np.where(self._active, self._tok, 0)[:, None],
                              device=self.device)
        pos = torch.as_tensor(np.where(self._active, self._pos, 0),
                              device=self.device)
        n_active = int(self._active.sum())
        t_step = time.perf_counter() if self.telemetry.enabled else 0.0
        logits, self.cache = self._decode(self.base, peft, self.cache, tok, pos)
        self.steps += 1
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        if self.telemetry.enabled:
            # next_tok is on the host, so the decode step has completed
            self._record_step(time.perf_counter() - t_step, n_active)
        for b in range(self.max_batch):
            if not self._active[b]:
                continue
            self._tok[b] = next_tok[b]
            self._pos[b] += 1
            self._remaining[b] -= 1
            self.outputs[self._rid[b]].append(int(next_tok[b]))
            if self._remaining[b] == 0:
                self._finish(b)
        return int(self._active.sum())

    def _record_step(self, dt: float, n_active: int) -> None:
        self._tc_steps.inc()
        self._th_step.observe(dt)
        self._tg_inflight.set(n_active)
        # steady-state decode throughput: batched decode steps only, the
        # admission prefills (cold path) are deliberately excluded
        self._decode_tokens += n_active
        self._decode_time += dt
        if self._decode_time > 0:
            self._tg_tps.set(self._decode_tokens / self._decode_time)

    def run(self, requests=None):
        """Submit ``requests`` (if given) and step until drained. Returns
        {request_id: generated ids}."""
        for req in requests or ():
            self.submit(req)
        while self._queue or self._active.any():
            self.step()
        return dict(self.outputs)

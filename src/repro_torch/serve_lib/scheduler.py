"""Continuous-batching serve scheduler over one persistent KV cache (the
port of `repro/serve_lib/scheduler.py`, greedy decoding).

`Scheduler` owns a fixed pool of `ServeConfig.batch` slots over ONE
persistent cache, contiguous or paged:

  admit   queued requests enter free slots via a ragged prefill
          (`transformer.prefill(lengths=..., update_mask=...)`): each
          prompt is written at its slot with per-slot positions and
          clock, in-flight slots untouched.  The first output token is
          the argmax of the prefill logits.
  decode  one fused `decode_step` over the whole pool with an `active`
          mask: the call shapes never change, so the engine's decisions
          are planned once and every later step hits the plan.
  evict   EOS / max-tokens frees the slot at once for the next queued
          request; a slot's clock masks its stale rows.

It serves every token-input decoder: "attn", "local", "ssm" and
"rglru" blocks; a recurrent block's state is written only for the slots
that step (admitted, or active).  Encoders (no decode step) and archs
that take embeddings (a VLM's prefix) are refused, as in the JAX
package.

On the paged layout (`cache_layout="paged"`, on an arch with "attn"
layers; an arch of sliding-window and recurrent blocks only runs the
contiguous path, as in the JAX package) the host plane `PagedKV` builds each slot's block table at
admission, reuses full prompt pages that an earlier request already
prefilled (prefix sharing, on pure "attn" archs: only the suffix is
prefilled, bucketed by the number of shared pages), allocates the decode
frontier page before each step writes it, and releases the slot's pages
on eviction.  Decode attention then runs the engine's
`paged_attention` kernel.  An int8 KV cache (`cache_dtype="int8"`) keeps
each layer's scale leaves in the same cache dict as its rows, placed by
the same indices, so admission, eviction and prefix sharing treat them
alike.

Prefill is the only shape-variable call: prompt widths are rounded up
to `prefill_bucket` (1 = the group's exact maximum).  Host state is
numpy, as in the JAX package; the tokens, masks and block tables go to
the device once per call, and only the argmax tokens come back.

Not ported yet: temperature sampling, speculative decoding, chunked
prefill and `serve_async` (ROADMAP.md queue 1 item 5).  Each raises
`NotImplementedError`.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time

import numpy as np
import torch

from ..engine import Engine, use_engine
from ..models import transformer as T
from ..models.config import ArchConfig
from . import serve as serve_lib
from .paged import PagedKV, PoolExhausted


@dataclasses.dataclass
class Request:
    """One generation request: `prompt` (L,) int32, emit up to
    `max_new_tokens` (stopping early at `eos_id` if given)."""
    uid: int
    prompt: np.ndarray
    max_new_tokens: int
    temperature: float = 0.0     # > 0 is not ported yet (greedy only)
    eos_id: int | None = None


@dataclasses.dataclass
class Completion:
    uid: int
    tokens: np.ndarray           # (n_emitted,) int32
    finish_reason: str           # "length" | "eos"
    prompt_len: int
    admit_step: int
    finish_step: int


@dataclasses.dataclass
class _Slot:
    req: Request
    emitted: list[int]
    last_token: int
    admit_step: int


class Scheduler:
    """Engine-aware continuous-batching loop over a slot pool.

    `params` must already be in serving dtype and on `scfg.device`.
    `engine` overrides the `ServeConfig`-derived one
    (`serve.warm_start_engine`); every model call runs inside its scope,
    so every kernel shares one decision cache.  `timings` holds the
    host seconds spent in prefill and decode calls (each ends in the
    host reading the tokens back, so the device work is done)."""

    def __init__(self, params, cfg: ArchConfig, scfg: serve_lib.ServeConfig,
                 *, engine: Engine | None = None, prefill_bucket: int = 1):
        if cfg.kind == "encoder":
            raise ValueError("encoder-only arch: no decode step")
        if cfg.embed_inputs or cfg.prefix_tokens:
            raise NotImplementedError(
                "scheduler serves token prompts only (no embeds/VLM prefix)")
        if prefill_bucket < 1:
            raise ValueError(f"prefill_bucket must be >= 1: {prefill_bucket}")
        if scfg.speculate_k:
            raise NotImplementedError(
                "speculative decoding is not ported yet (ROADMAP.md queue 1 "
                "item 5)")
        if scfg.prefill_chunk is not None:
            raise NotImplementedError(
                "chunked prefill is not ported yet (ROADMAP.md queue 1 "
                "item 5)")
        self.params = params
        self.cfg = cfg
        self.scfg = scfg
        self.prefill_bucket = prefill_bucket
        self.device = serve_lib.resolve_device(scfg)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device} but "
                             f"ServeConfig.device is {scfg.device!r}")
        self.engine = (engine if engine is not None
                       else serve_lib.warm_start_engine(scfg))
        self.cache = serve_lib.init_cache(cfg, scfg)
        # the paged plane is live only when the arch has full-attention
        # layers to page: on an arch of sliding-window and recurrent
        # blocks only a paged ServeConfig builds the contiguous cache
        # (rings, states) and runs the contiguous path, as in the JAX
        # package.  Prefix sharing needs
        # every layer's prompt rows in shareable pages: pure "attn" only.
        self.paged: PagedKV | None = None
        if scfg.cache_layout == "paged" and "attn" in cfg.layer_pattern:
            self.paged = PagedKV(
                batch=scfg.batch, max_seq=scfg.max_seq,
                page_size=scfg.page_size, n_pages=scfg.resolved_n_pages,
                prefix_sharing=set(cfg.layer_pattern) == {"attn"})
        self.slots: list[_Slot | None] = [None] * scfg.batch
        self.queue: collections.deque[Request] = collections.deque()
        self.completions: dict[int, Completion] = {}
        self.step_count = 0
        # the JAX package's keys; the speculative ones stay 0 here
        self.stats = {"admitted": 0, "finished": 0, "prefill_calls": 0,
                      "decode_steps": 0, "decode_tokens": 0,
                      "prefill_widths": set(),
                      "prefill_tokens": 0, "prefill_width_sum": 0,
                      "shared_prefix_tokens": 0,
                      "spec_ticks": 0, "draft_tokens": 0,
                      "accepted_draft_tokens": 0}
        self.timings = {"prefill_s": 0.0, "decode_s": 0.0}
        #: prefill calls by width (`stats` keeps the JAX package's keys,
        #: the set of widths only)
        self.prefill_width_calls: collections.Counter[int] = (
            collections.Counter())
        self._live_uids: set[int] = set()

    # -- request intake ----------------------------------------------------

    def submit(self, req: Request) -> None:
        n = int(np.asarray(req.prompt).size)
        if n < 1:
            raise ValueError(f"request {req.uid}: empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError(f"request {req.uid}: max_new_tokens < 1")
        if n + req.max_new_tokens > self.scfg.max_seq:
            raise ValueError(
                f"request {req.uid}: prompt {n} + max_new "
                f"{req.max_new_tokens} exceeds max_seq {self.scfg.max_seq}")
        if req.temperature > 0.0:
            raise NotImplementedError(
                f"request {req.uid}: temperature sampling is not ported yet "
                f"(ROADMAP.md queue 1 item 5); the port decodes greedily")
        if req.uid in self._live_uids:  # queued, in flight, or completed
            raise ValueError(f"duplicate request uid {req.uid}")
        self._live_uids.add(req.uid)
        self.queue.append(req)

    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self.slots)

    def _scope(self):
        return (use_engine(self.engine) if self.engine is not None
                else contextlib.nullcontext())

    def _tensor(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(array).to(self.device)

    def _emit(self, i: int, tok: int, finished: list[Completion]) -> None:
        """Record one token for slot i; evict on EOS/budget."""
        slot = self.slots[i]
        slot.emitted.append(tok)
        slot.last_token = tok
        done_eos = slot.req.eos_id is not None and tok == slot.req.eos_id
        done_len = len(slot.emitted) >= slot.req.max_new_tokens
        if done_eos or done_len:
            comp = Completion(
                uid=slot.req.uid,
                tokens=np.asarray(slot.emitted, np.int32),
                finish_reason="eos" if done_eos else "length",
                prompt_len=int(np.asarray(slot.req.prompt).size),
                admit_step=slot.admit_step, finish_step=self.step_count)
            self.completions[slot.req.uid] = comp
            finished.append(comp)
            self.slots[i] = None  # slot free for the next queued request
            if self.paged is not None:
                # private pages free at once; shared ones live on in
                # other slots or the prefix index
                self.paged.release(i)
            self.stats["finished"] += 1

    # -- the two batch calls ----------------------------------------------

    def _admit(self, finished: list[Completion]) -> None:
        free = [i for i, s in enumerate(self.slots) if s is None]
        if not free or not self.queue:
            return
        picks: list[tuple[int, Request]] = []
        hists: dict[int, int] = {}
        if self.paged is not None:
            # peek-then-pop: PoolExhausted leaves the request queued
            # (backpressure — completions will free pages).  Stuck with
            # every slot free means the pool cannot hold the prompt.
            while free and self.queue:
                i, req = free[0], self.queue[0]
                prompt = np.asarray(req.prompt, np.int32).reshape(-1)
                try:
                    hists[i] = self.paged.admit(i, prompt.tolist())
                except PoolExhausted:
                    if not picks and self.n_active == 0:
                        raise RuntimeError(
                            f"page pool ({self.paged.n_pages} pages of "
                            f"{self.paged.page}) cannot hold request "
                            f"{req.uid}'s prompt ({prompt.size} tokens) "
                            f"even with every slot free — raise "
                            f"ServeConfig.n_pages") from None
                    break
                free.pop(0)
                self.queue.popleft()
                picks.append((i, req))
            if not picks:
                return
        else:
            while free and self.queue:
                picks.append((free.pop(0), self.queue.popleft()))
        self.stats["admitted"] += len(picks)
        # one prefill call per shared-history page count, each at its own
        # group-max suffix width
        buckets: dict[int, list[tuple[int, Request]]] = {}
        for i, req in picks:
            hp = hists.get(i, 0) // self.scfg.page_size \
                if self.paged is not None else 0
            buckets.setdefault(hp, []).append((i, req))
        toks: dict[int, int] = {}
        for hp in sorted(buckets):
            toks.update(self._prefill_group(buckets[hp], hists, hp))
        if self.paged is not None:
            # index the now-resident full prompt pages for later admits
            for i, req in picks:
                self.paged.note_prefilled(
                    i, np.asarray(req.prompt, np.int32).tolist())
            self.stats["shared_prefix_tokens"] = self.paged.shared_tokens
        # the first output token comes from the prefill logits
        for i, _ in picks:
            self._emit(i, toks[i], finished)

    def _prefill_group(self, picks: list[tuple[int, Request]],
                       hists: dict[int, int], hist_pages: int) -> dict[int, int]:
        """One ragged prefill call over `picks` (all sharing `hist_pages`
        resident history pages); returns each admitted slot's token."""
        b = self.scfg.batch
        # with a prefix-cache hit only the un-resident suffix prefills
        maxlen = max(int(np.asarray(r.prompt).size) - hists.get(i, 0)
                     for i, r in picks)
        width = -(-maxlen // self.prefill_bucket) * self.prefill_bucket
        width = min(width, self.scfg.max_seq)
        tokens = np.zeros((b, width), np.int32)
        lengths = np.ones((b,), np.int32)
        mask = np.zeros((b,), bool)
        hist_arr = np.zeros((b,), np.int32)
        for i, req in picks:
            prompt = np.asarray(req.prompt, np.int32).reshape(-1)
            suffix = prompt[hists.get(i, 0):]
            tokens[i, : suffix.size] = suffix
            lengths[i] = suffix.size
            hist_arr[i] = hists.get(i, 0)
            mask[i] = True
            self.slots[i] = _Slot(req=req, emitted=[], last_token=0,
                                  admit_step=self.step_count)
        t0 = time.perf_counter()
        kw = {}
        if self.paged is not None:
            kw = {"block_tables": self._tensor(self.paged.tables),
                  "hist_len": self._tensor(hist_arr), "hist_pages": hist_pages}
        with self._scope(), torch.inference_mode():
            logits, self.cache = T.prefill(
                self.params, self.cfg, self._tensor(tokens), self.cache,
                compute_dtype=self.scfg.compute_dtype,
                lengths=self._tensor(lengths), update_mask=self._tensor(mask),
                **kw)
            out = logits[:, -1].argmax(dim=-1).cpu().numpy()
        self.timings["prefill_s"] += time.perf_counter() - t0
        self.stats["prefill_calls"] += 1
        self.stats["prefill_widths"].add(width)
        self.prefill_width_calls[width] += 1
        self.stats["prefill_tokens"] += int(lengths[mask].sum())
        self.stats["prefill_width_sum"] += width * len(picks)
        return {i: int(out[i]) for i, _ in picks}

    def _decode_active(self, finished: list[Completion]) -> None:
        active = np.asarray([s is not None for s in self.slots])
        if not active.any():
            return
        toks = np.asarray(
            [s.last_token if s is not None else 0 for s in self.slots],
            np.int32)[:, None]
        kw = {}
        if self.paged is not None:
            # each active slot's write-frontier page must exist (and be
            # private) before the fused step writes it; the write
            # position is the slot's clock: prompt_len + emitted - 1
            for i, s in enumerate(self.slots):
                if active[i]:
                    pos = (int(np.asarray(s.req.prompt).size)
                           + len(s.emitted) - 1)
                    self.paged.ensure_decode_page(i, pos)
            kw = {"block_tables": self._tensor(self.paged.tables)}
        t0 = time.perf_counter()
        with self._scope(), torch.inference_mode():
            logits, self.cache = T.decode_step(
                self.params, self.cfg, self.cache, self._tensor(toks),
                compute_dtype=self.scfg.compute_dtype,
                active=self._tensor(active), **kw)
            out = logits[:, -1].argmax(dim=-1).cpu().numpy()
        self.timings["decode_s"] += time.perf_counter() - t0
        self.stats["decode_steps"] += 1
        self.stats["decode_tokens"] += int(active.sum())
        for i in range(len(self.slots)):
            if active[i]:
                self._emit(i, int(out[i]), finished)

    # -- the tick loop -----------------------------------------------------

    def step(self) -> list[Completion]:
        """One scheduler tick: admit into free slots, then one fused
        decode over the pool.  Returns requests finished this tick."""
        finished: list[Completion] = []
        self._admit(finished)
        self._decode_active(finished)
        self.step_count += 1
        return finished

    def run(self, requests=(), *, max_steps: int | None = None
            ) -> dict[int, Completion]:
        """Submit `requests`, drive until queue and pool drain, and
        return {uid: Completion}."""
        for r in requests:
            self.submit(r)
        steps = 0
        while self.queue or self.n_active:
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                raise RuntimeError(
                    f"scheduler did not drain in {max_steps} steps "
                    f"({self.n_active} active, {len(self.queue)} queued)")
        return self.completions

    def serve_async(self, **_):
        raise NotImplementedError(
            "serve_async (the async ingestion plane) is not ported yet "
            "(ROADMAP.md queue 1 item 5)")

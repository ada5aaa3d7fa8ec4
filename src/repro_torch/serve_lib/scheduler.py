"""Continuous-batching serve scheduler over one persistent KV cache (the
port of `repro/serve_lib/scheduler.py`).

`Scheduler` owns a fixed pool of `ServeConfig.batch` slots over ONE
persistent cache, contiguous or paged:

  admit   queued requests enter free slots via a ragged prefill
          (`transformer.prefill(lengths=..., update_mask=...)`): each
          prompt is written at its slot with per-slot positions and
          clock, in-flight slots untouched.  The first output token is
          sampled from the prefill logits.
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
contiguous path, as in the JAX package) the host plane `PagedKV` builds
each slot's block table at admission, reuses full prompt pages that an
earlier request already prefilled (prefix sharing, on pure "attn" archs:
only the suffix is prefilled, bucketed by the number of shared pages),
allocates the decode frontier page before each step writes it, and
releases the slot's pages on eviction.  Decode attention then runs the
engine's `paged_attention` kernel.  An int8 KV cache
(`cache_dtype="int8"`) keeps each layer's scale leaves in the same cache
dict as its rows, placed by the same indices, so admission, eviction and
prefix sharing treat them alike.

Prefill is the only shape-variable call: prompt widths are rounded up
to `prefill_bucket` (1 = the group's exact maximum).  Host state is
numpy, as in the JAX package; the tokens, masks and block tables go to
the device once per call, and only the argmax tokens come back (the
logits rows of the slots that sample).

Sampling: a request with `temperature > 0` carries `key`, a host
`torch.Generator`; each of its tokens is a categorical draw from
softmax(logits / temperature) on the host (`serve.sample`).  torch has
no JAX PRNG, so sampled tokens follow the JAX package's distribution,
not its bits.

Speculative decoding (`ServeConfig.speculate_k` = k): every tick the
draft proposes k tokens per slot (`transformer.draft_propose` on its
private contiguous cache), the target scores the slot's last token and
the k drafts in one (k + 1)-wide pass and accepts the longest greedy
prefix (`verify_step`), and the draft's cache replays the accepted
window (`spec_advance`).  Greedy only; the tokens are plain greedy
decode's.

Chunked prefill (`ServeConfig.prefill_chunk`): a prompt whose
un-resident part is longer than the chunk streams into its slot one
chunk a tick (`prefill(hist_len=...)`'s continuation), each chunk
sharing its tick with the pool's decode, so in-flight slots keep
emitting.  `serve_async` wraps the tick loop in a worker thread behind a
bounded request queue (`AsyncServer`).
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import queue
import threading
import time

import numpy as np
import torch

from ..engine import Engine, use_engine
from ..models import transformer as T
from ..models.config import ArchConfig
from ..quant import quantize_params
from . import serve as serve_lib
from .paged import PagedKV, PoolExhausted


@dataclasses.dataclass
class Request:
    """One generation request: `prompt` (L,) int32, emit up to
    `max_new_tokens` (stopping early at `eos_id` if given).  A positive
    `temperature` samples, with `key`, a host `torch.Generator` (the
    request's own state is left as it was: the slot draws from a copy)."""
    uid: int
    prompt: np.ndarray
    max_new_tokens: int
    temperature: float = 0.0
    key: torch.Generator | None = None
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
    key: torch.Generator | None
    emitted: list[int]
    last_token: int
    admit_step: int
    # chunked ingestion: the prompt tokens already resident in the cache
    # (shared-prefix pages included); while `ingesting` the slot sits out
    # the decode ticks and takes one chunk per `_ingest_tick` until its
    # whole prompt is resident.
    ingest_pos: int = 0
    ingesting: bool = False


def _fork(key: torch.Generator | None) -> torch.Generator | None:
    """A generator with `key`'s state: the slot advances its copy."""
    if key is None:
        return None
    out = torch.Generator(device=key.device)
    out.set_state(key.get_state())
    return out


class Scheduler:
    """Engine-aware continuous-batching loop over a slot pool.

    `params` must already be in serving dtype and on `scfg.device`.
    `engine` overrides the `ServeConfig`-derived one
    (`serve.warm_start_engine`); every model call runs inside its scope,
    so every kernel shares one decision cache.  `timings` holds the
    host seconds spent in prefill, decode and speculative calls (each
    ends in the host reading the tokens back, so the device work is
    done).  With `speculate_k`, `draft_params`/`draft_cfg` name the
    draft model (else `ServeConfig.draft`: the target itself, or its int8
    copy)."""

    def __init__(self, params, cfg: ArchConfig, scfg: serve_lib.ServeConfig,
                 *, engine: Engine | None = None, prefill_bucket: int = 1,
                 draft_params=None, draft_cfg: ArchConfig | None = None):
        if cfg.kind == "encoder":
            raise ValueError("encoder-only arch: no decode step")
        if cfg.embed_inputs or cfg.prefix_tokens:
            raise NotImplementedError(
                "scheduler serves token prompts only (no embeds/VLM prefix)")
        if prefill_bucket < 1:
            raise ValueError(f"prefill_bucket must be >= 1: {prefill_bucket}")
        if (draft_params is None) != (draft_cfg is None):
            raise ValueError("draft_params and draft_cfg come together")
        if draft_params is not None and not scfg.speculate_k:
            raise ValueError("draft_params needs ServeConfig(speculate_k>0)")
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
        # the JAX package's keys
        self.stats = {"admitted": 0, "finished": 0, "prefill_calls": 0,
                      "decode_steps": 0, "decode_tokens": 0,
                      "prefill_widths": set(),
                      "prefill_tokens": 0, "prefill_width_sum": 0,
                      "shared_prefix_tokens": 0,
                      "spec_ticks": 0, "draft_tokens": 0,
                      "accepted_draft_tokens": 0}
        self.timings = {"prefill_s": 0.0, "decode_s": 0.0}
        #: prefill calls by width (`stats` keeps the JAX package's keys,
        #: the set of widths only); the draft's prefills apart
        self.prefill_width_calls: collections.Counter[int] = (
            collections.Counter())
        self.draft_prefill_width_calls: collections.Counter[int] = (
            collections.Counter())
        self._live_uids: set[int] = set()
        # chunked ingestion: chunk calls are exactly `chunk` wide; a chunk
        # aligned to the prefill bucket stays among the admit widths
        self.chunk = scfg.prefill_chunk
        if self.chunk is not None and self.chunk % prefill_bucket:
            raise ValueError(
                f"prefill_chunk {self.chunk} is not a multiple of "
                f"prefill_bucket {prefill_bucket}: the chunk width must "
                f"sit in the bucketed admit-width universe the engine "
                f"plan pre-decides (zero steady-state misses)")
        # -- speculative decoding --------------------------------------
        self.spec_k = scfg.speculate_k
        self.draft_params = self.draft_cfg = self.draft_cache = None
        if self.spec_k:
            if draft_params is not None:
                self.draft_params, self.draft_cfg = draft_params, draft_cfg
            elif scfg.draft == "self-int8":
                self.draft_params, self.draft_cfg = (quantize_params(params),
                                                     cfg)
            else:  # None / "self": the target's params
                self.draft_params, self.draft_cfg = params, cfg
            w = self.spec_k + 1
            for c in {cfg, self.draft_cfg}:
                if "local" in c.layer_pattern:
                    ring = min(c.window, scfg.max_seq)
                    if w > ring:
                        raise ValueError(
                            f"speculate_k={self.spec_k}: the k+1-wide "
                            f"verify writes {w} ring rows but the sliding "
                            f"window holds only {ring} — rollback could "
                            f"not restore a window it overwrote twice")
            # the draft's private contiguous cache in the compute dtype:
            # it takes whole prompts and the accepted verify windows
            self.draft_cache = T.init_cache(
                self.draft_cfg, T.CacheSpec(scfg.max_seq, scfg.batch),
                dtype=scfg.compute_dtype, device=self.device)
            self.timings["spec_s"] = 0.0

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
        if req.temperature > 0.0 and req.key is None:
            raise ValueError(
                f"request {req.uid}: temperature > 0 needs a PRNG key "
                f"(key=torch.Generator().manual_seed(...))")
        if self.spec_k:
            if req.temperature > 0.0:
                raise ValueError(
                    f"request {req.uid}: speculative decoding is greedy-"
                    f"only (acceptance is computed in-graph via argmax; "
                    f"temperature sampling would need a host RNG round-"
                    f"trip per draft token)")
            if n + req.max_new_tokens + self.spec_k > self.scfg.max_seq:
                raise ValueError(
                    f"request {req.uid}: prompt {n} + max_new "
                    f"{req.max_new_tokens} + speculate_k {self.spec_k} "
                    f"exceeds max_seq {self.scfg.max_seq} — the verify "
                    f"pass writes k rows past the final token")
        if req.uid in self._live_uids:  # queued, in flight, or completed
            raise ValueError(f"duplicate request uid {req.uid}")
        self._live_uids.add(req.uid)
        self.queue.append(req)

    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self.slots)

    def _scope(self):
        """The engine's scope and inference mode: both are entered by the
        thread that runs the call (an `AsyncServer` worker too)."""
        stack = contextlib.ExitStack()
        if self.engine is not None:
            stack.enter_context(use_engine(self.engine))
        stack.enter_context(torch.inference_mode())
        return stack

    def _tensor(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(array).to(self.device)

    # -- sampling (host-side, per slot: each request owns its generator) --

    def _sample(self, slot: _Slot, logits_row: torch.Tensor) -> int:
        """One token from a host logits row (V,): the argmax, or a draw
        from softmax(row / temperature) with the slot's generator."""
        return int(serve_lib.sample(logits_row, slot.req.temperature,
                                    slot.key))

    def _pick(self, logits: torch.Tensor, rows) -> dict[int, int]:
        """The next token of each slot in `rows` from `logits` (B, V):
        greedy slots take the argmax on the device; only the rows of the
        slots that sample come to the host."""
        greedy = logits.argmax(dim=-1).cpu().numpy()
        hot = [i for i in rows if self.slots[i].req.temperature > 0.0]
        out = {i: int(greedy[i]) for i in rows}
        if hot:
            host = logits[hot].float().cpu()
            for j, i in enumerate(hot):
                out[i] = self._sample(self.slots[i], host[j])
        return out

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

    def _new_slot(self, req: Request, **kw) -> _Slot:
        return _Slot(req=req, key=_fork(req.key), emitted=[], last_token=0,
                     admit_step=self.step_count, **kw)

    # -- the batch calls ---------------------------------------------------

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
        # chunked ingestion: a pick whose un-resident part is longer than
        # the chunk does not prefill here; its slot starts `ingesting` and
        # `_ingest_tick` streams the prompt in, one chunk a tick
        if self.chunk is not None:
            short: list[tuple[int, Request]] = []
            for i, req in picks:
                n = int(np.asarray(req.prompt).size)
                if n - hists.get(i, 0) > self.chunk:
                    self.slots[i] = self._new_slot(
                        req, ingest_pos=hists.get(i, 0), ingesting=True)
                else:
                    short.append((i, req))
            picks = short
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
            # (an ingesting slot waits for its last chunk)
            for i, req in picks:
                self.paged.note_prefilled(
                    i, np.asarray(req.prompt, np.int32).tolist())
            self.stats["shared_prefix_tokens"] = self.paged.shared_tokens
        if self.spec_k and picks:
            self._draft_prefill(picks)
        # the first output token comes from the prefill logits
        for i, _ in picks:
            self._emit(i, toks[i], finished)

    def _prefill_call(self, tokens, lengths, mask, hist_arr,
                      hist_pages: int, rows) -> dict[int, int]:
        """One prefill of the target: tokens (B, width) and its lengths,
        update mask and histories; returns the token of each slot of
        `rows`."""
        kw = {}
        if self.paged is not None:
            kw = {"block_tables": self._tensor(self.paged.tables),
                  "hist_len": self._tensor(hist_arr),
                  "hist_pages": hist_pages}
        elif hist_arr is not None:
            kw = {"hist_len": self._tensor(hist_arr)}
        t0 = time.perf_counter()
        with self._scope():
            logits, self.cache = T.prefill(
                self.params, self.cfg, self._tensor(tokens), self.cache,
                compute_dtype=self.scfg.compute_dtype,
                lengths=self._tensor(lengths), update_mask=self._tensor(mask),
                **kw)
            out = self._pick(logits[:, -1], rows)
        self.timings["prefill_s"] += time.perf_counter() - t0
        width = tokens.shape[1]
        self.stats["prefill_calls"] += 1
        self.stats["prefill_widths"].add(width)
        self.prefill_width_calls[width] += 1
        self.stats["prefill_tokens"] += int(lengths[mask].sum())
        self.stats["prefill_width_sum"] += width * len(rows)
        return out

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
            self.slots[i] = self._new_slot(req)
        return self._prefill_call(
            tokens, lengths, mask,
            hist_arr if self.paged is not None else None, hist_pages,
            [i for i, _ in picks])

    def _ingest_tick(self, finished: list[Completion]) -> None:
        """Advance every ingesting slot by one `prefill_chunk`-wide chunk:
        one call for all of them (a slot at its first chunk has history 0).
        On the paged layout the slots are grouped by their resident page
        count (`hist_pages` bounds the history gather) and the shallowest
        group goes first.  A slot whose prompt is now resident leaves
        `ingesting`, registers its prefix pages, prefills the draft (when
        speculating) and emits its first token from the chunk's logits:
        what the single-shot admit does, at the last chunk."""
        ing = [(i, s) for i, s in enumerate(self.slots)
               if s is not None and s.ingesting]
        if not ing:
            return
        hp = 0
        if self.paged is not None:
            groups: dict[int, list[tuple[int, _Slot]]] = {}
            for i, s in ing:
                groups.setdefault(
                    s.ingest_pos // self.scfg.page_size, []).append((i, s))
            hp = min(groups)
            ing = groups[hp]
        b, ch = self.scfg.batch, self.chunk
        tokens = np.zeros((b, ch), np.int32)
        lengths = np.ones((b,), np.int32)
        mask = np.zeros((b,), bool)
        hist_arr = np.zeros((b,), np.int32)
        takes: dict[int, int] = {}
        for i, s in ing:
            prompt = np.asarray(s.req.prompt, np.int32).reshape(-1)
            take = min(ch, prompt.size - s.ingest_pos)
            tokens[i, :take] = prompt[s.ingest_pos:s.ingest_pos + take]
            lengths[i] = take
            hist_arr[i] = s.ingest_pos
            mask[i] = True
            takes[i] = take
        toks = self._prefill_call(tokens, lengths, mask, hist_arr, hp,
                                  [i for i, _ in ing])
        done: list[tuple[int, Request]] = []
        for i, s in ing:
            s.ingest_pos += takes[i]
            if s.ingest_pos >= int(np.asarray(s.req.prompt).size):
                s.ingesting = False
                done.append((i, s.req))
        if not done:
            return
        if self.paged is not None:
            for i, req in done:
                self.paged.note_prefilled(
                    i, np.asarray(req.prompt, np.int32).tolist())
            self.stats["shared_prefix_tokens"] = self.paged.shared_tokens
        if self.spec_k:
            self._draft_prefill(done)
        for i, _ in done:
            self._emit(i, toks[i], finished)

    def _draft_prefill(self, picks: list[tuple[int, Request]]) -> None:
        """Prefill the draft's cache with the whole prompts of the slots
        just admitted (the draft shares no prefix: its cache is private
        and contiguous).  Its logits are not read: the first token is the
        target's, and the next tick feeds it to `draft_propose`."""
        b = self.scfg.batch
        maxlen = max(int(np.asarray(r.prompt).size) for _, r in picks)
        width = -(-maxlen // self.prefill_bucket) * self.prefill_bucket
        width = min(width, self.scfg.max_seq)
        tokens = np.zeros((b, width), np.int32)
        lengths = np.ones((b,), np.int32)
        mask = np.zeros((b,), bool)
        for i, req in picks:
            prompt = np.asarray(req.prompt, np.int32).reshape(-1)
            tokens[i, : prompt.size] = prompt
            lengths[i] = prompt.size
            mask[i] = True
        t0 = time.perf_counter()
        with self._scope():
            _, self.draft_cache = T.prefill(
                self.draft_params, self.draft_cfg, self._tensor(tokens),
                self.draft_cache, compute_dtype=self.scfg.compute_dtype,
                lengths=self._tensor(lengths), update_mask=self._tensor(mask))
        self.timings["prefill_s"] += time.perf_counter() - t0
        self.draft_prefill_width_calls[width] += 1

    def _decoding(self) -> np.ndarray:
        """(B,) the slots that decode this tick: occupied and not
        ingesting (an ingesting slot has no token to feed back yet)."""
        return np.asarray([s is not None and not s.ingesting
                           for s in self.slots])

    def _frontier(self, i: int) -> int:
        """Slot i's write position, its clock: prompt + emitted - 1 (the
        first token came from the prefill)."""
        s = self.slots[i]
        return int(np.asarray(s.req.prompt).size) + len(s.emitted) - 1

    def _decode_active(self, finished: list[Completion]) -> None:
        active = self._decoding()
        if not active.any():
            return
        toks = np.asarray(
            [s.last_token if s is not None else 0 for s in self.slots],
            np.int32)[:, None]
        kw = {}
        if self.paged is not None:
            # each active slot's write-frontier page must exist (and be
            # private) before the fused step writes it
            for i in np.flatnonzero(active):
                self.paged.ensure_decode_page(i, self._frontier(i))
            kw = {"block_tables": self._tensor(self.paged.tables)}
        t0 = time.perf_counter()
        with self._scope():
            logits, self.cache = T.decode_step(
                self.params, self.cfg, self.cache, self._tensor(toks),
                compute_dtype=self.scfg.compute_dtype,
                active=self._tensor(active), **kw)
            out = self._pick(logits[:, -1], np.flatnonzero(active).tolist())
        self.timings["decode_s"] += time.perf_counter() - t0
        self.stats["decode_steps"] += 1
        self.stats["decode_tokens"] += int(active.sum())
        for i in range(len(self.slots)):
            if active[i]:
                self._emit(i, out[i], finished)

    def _spec_tick(self, finished: list[Completion]) -> None:
        """One speculative tick: the draft proposes k tokens, the target
        verifies all k + 1 positions in one pass, each slot emits its
        accepted prefix and the target's correction token, and the
        draft's cache replays the accepted window: three model calls for
        the k + 1 decode steps the same tokens would otherwise cost."""
        active = self._decoding()
        if not active.any():
            return
        k = self.spec_k
        last = np.asarray(
            [s.last_token if s is not None else 0 for s in self.slots],
            np.int32)
        kw = {}
        if self.paged is not None:
            # the verify writes pos .. pos + k: every page on the span
            # must exist (and be private) before the pass
            page = self.paged.page
            for i in np.flatnonzero(active):
                pos = self._frontier(i)
                for pg in range(pos // page, (pos + k) // page + 1):
                    self.paged.ensure_decode_page(i, max(pos, pg * page))
            kw = {"block_tables": self._tensor(self.paged.tables)}
        t0 = time.perf_counter()
        with self._scope():
            act, last_t = self._tensor(active), self._tensor(last)
            drafts = T.draft_propose(
                self.draft_params, self.draft_cfg, self.draft_cache, last_t,
                k, compute_dtype=self.scfg.compute_dtype, active=act)
            toks = torch.cat([last_t[:, None], drafts], dim=1)
            g, n_acc, self.cache = T.verify_step(
                self.params, self.cfg, self.cache, toks,
                compute_dtype=self.scfg.compute_dtype, active=act, **kw)
            self.draft_cache = T.spec_advance(
                self.draft_params, self.draft_cfg, self.draft_cache, toks,
                n_acc + 1, compute_dtype=self.scfg.compute_dtype, active=act)
            g_np, acc_np = g.cpu().numpy(), n_acc.cpu().numpy()
        self.timings["spec_s"] += time.perf_counter() - t0
        self.stats["decode_steps"] += 1
        self.stats["spec_ticks"] += 1
        self.stats["draft_tokens"] += k * int(active.sum())
        self.stats["accepted_draft_tokens"] += int(acc_np[active].sum())
        for i in np.flatnonzero(active):
            # the committed frontier before this tick's emissions
            t0_i = self._frontier(i)
            for j in range(int(acc_np[i]) + 1):
                if self.slots[i] is None:  # EOS/budget mid-window
                    break
                self._emit(i, int(g_np[i, j]), finished)
                self.stats["decode_tokens"] += 1
            if self.paged is not None and self.slots[i] is not None:
                # the clock rolled back on the device; release each page
                # that now holds rejected rows only.  The last committed
                # row is t0 + n_acc.
                self.paged.rollback(i, t0_i + int(acc_np[i]))

    # -- the tick loop -----------------------------------------------------

    def step(self) -> list[Completion]:
        """One scheduler tick: admit into free slots, advance chunked
        ingestion, then one fused decode (or draft, verify and replay,
        when speculating) over the pool.  Returns requests finished this
        tick."""
        finished: list[Completion] = []
        self._admit(finished)
        if self.chunk is not None:
            self._ingest_tick(finished)
        if self.spec_k:
            self._spec_tick(finished)
        else:
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

    def serve_async(self, *, max_queue: int = 0,
                    start: bool = True) -> "AsyncServer":
        """Wrap this scheduler in the async ingestion plane: a worker
        thread drives the tick loop, callers submit through a bounded
        queue and get a Future per request.  The scheduler must not be
        stepped directly while the server runs: the worker owns it."""
        return AsyncServer(self, max_queue=max_queue, start=start)


class AsyncServer:
    """Async ingestion plane over a `Scheduler`.

    One worker thread owns the scheduler: it drains the submission queue
    into `Scheduler.submit` and drives `step()` while there is work,
    blocking on the queue when idle; the model never runs concurrently
    with itself, so no lock guards the cache.  Callers touch only the
    queue and the returned futures:

        with sched.serve_async(max_queue=32) as srv:
            futs = [srv.submit(r) for r in requests]
            outs = [f.result(timeout=600) for f in futs]

    Backpressure: with `max_queue > 0`, `submit` blocks while the queue
    is full; pass `timeout=` to get `queue.Full` instead.  A request the
    scheduler rejects (a validation error) fails on its own Future.  If a
    step raises, the worker fails every pending Future with that error
    and stops, so no caller waits for a dead worker.  `shutdown()` stops
    intake, lets the worker drain everything already submitted, and joins
    it."""

    _IDLE_POLL = 0.05  # seconds the idle worker blocks per queue wait

    def __init__(self, sched: Scheduler, *, max_queue: int = 0,
                 start: bool = True):
        if max_queue < 0:
            raise ValueError(f"max_queue must be >= 0: {max_queue}")
        self._sched = sched
        self._q: queue.Queue = queue.Queue(maxsize=max_queue)
        self._futures: dict[int, concurrent.futures.Future] = {}
        self._stop = threading.Event()
        self._started = False
        self.error: BaseException | None = None
        self._thread = threading.Thread(
            target=self._worker, name="serve-async-worker", daemon=True)
        if start:
            self.start()

    def start(self) -> None:
        if not self._started:
            self._started = True
            self._thread.start()

    def submit(self, req: Request,
               timeout: float | None = None) -> concurrent.futures.Future:
        """Queue `req`; returns a Future resolving to its Completion.
        Blocks while the bounded queue is full (backpressure); with
        `timeout=` raises `queue.Full` instead.  Raises RuntimeError
        after `shutdown` or once the worker has died."""
        if self._stop.is_set():
            raise RuntimeError("submit after shutdown")
        if self.error is not None:
            raise RuntimeError("the serve worker died") from self.error
        fut: concurrent.futures.Future = concurrent.futures.Future()
        self._q.put((req, fut), timeout=timeout)
        return fut

    def shutdown(self, wait: bool = True) -> None:
        """Stop intake; the worker drains every request already queued
        or in flight, then exits.  `wait=True` joins it."""
        self._stop.set()
        if wait and self._started:
            self._thread.join()

    def __enter__(self) -> "AsyncServer":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # -- worker side -------------------------------------------------------

    def _intake(self, item) -> None:
        req, fut = item
        try:
            self._sched.submit(req)
        except Exception as e:  # validation error -> the caller's future
            fut.set_exception(e)
            return
        self._futures[req.uid] = fut

    def _drain_submissions(self) -> None:
        while True:
            try:
                self._intake(self._q.get_nowait())
            except queue.Empty:
                return

    def _fail_pending(self, error: BaseException) -> None:
        self.error = error
        self._drain_submissions()
        for fut in self._futures.values():
            fut.set_exception(error)
        self._futures.clear()

    def _worker(self) -> None:
        sched = self._sched
        try:
            while True:
                self._drain_submissions()
                if sched.queue or sched.n_active:
                    for comp in sched.step():
                        fut = self._futures.pop(comp.uid, None)
                        if fut is not None:
                            fut.set_result(comp)
                elif self._stop.is_set() and self._q.empty():
                    return
                else:  # idle: block on the queue instead of spinning
                    try:
                        self._intake(self._q.get(timeout=self._IDLE_POLL))
                    except queue.Empty:
                        pass
        except BaseException as e:  # a dead worker fails its futures
            self._fail_pending(e)

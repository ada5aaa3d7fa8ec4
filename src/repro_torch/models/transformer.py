"""Model assembly: decoder / encoder / hybrid / SSM / VLM from ArchConfig
(the port of `repro/models/transformer.py`): block kinds "attn",
"local" (each with a dense or a MoE feed-forward), "ssm" and "rglru",
token or embedding inputs.

Parameters keep the JAX pytree's layout: `stack["b{j}"]` leaves carry
the leading period axis, `tail` is a list of blocks past the last whole
period, `embed` is (vocab, d_model) and `lm_head` (d_model, vocab).  The
JAX `lax.scan` over periods is a Python loop over views of the stack.

  forward()       full-sequence logits
  prefill()       forward + KV cache construction (ragged, paged, and
                  chunked: `hist_len` continues each slot's cache)
  decode_step()   one token against the cache (vector clock `t`, an
                  `active` mask, block tables on the paged layout)
  verify_step()   speculative decoding: a W-wide teacher-forced pass,
                  greedy acceptance and the rollback of what it rejects
                  (`spec_forward`, `spec_commit`, `spec_advance`,
                  `draft_propose`)

A "local" block attends a sliding window of `cfg.window` keys: its
cache is a per-slot ring of min(window, max_seq) rows on either layout
(only "attn" blocks are paged), written at `t % size`.  An "ssm" block
(`models.ssm`) keeps a conv window and an f32 SSD state per slot, an
"rglru" block (`models.rglru`) a conv window and its h; both are O(1)
in the sequence and keep their slot layout on either layout.

`prefill` and `decode_step` write the cache tensors in place and return
the cache dict with its new clock.  Where the JAX package merges the old
rows of masked slots back (`_merge_slot`, `mode="drop"` scatters), the
port simply never writes them.  A recurrent update computes every slot,
so its new state is written only where the slot is in `active` (decode)
or `update_mask` (prefill): other slots' state stays bit for bit.  An
int8 cache (`init_cache(dtype=
torch.int8)`) stores each K/V row quantized (`quant.kv_quantize`, in the
form the reference computes inside `jax.jit`) with its f32 scale beside
it, written by the same indices as the row; recurrent state stays
bf16 under it, as in the JAX package.

`forward` and `prefill` take `embeds=`: (B, S, D) frame embeddings for
an `embed_inputs` arch (hubert, an encoder: no decode step), or a
(B, P, D) prefix before the tokens for a VLM (internvl2).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.utils.checkpoint

from ..quant.quantize import QuantizedTensor, kv_dequantize, kv_quantize
from ..sparse.nm import SparseTensor
from ..tree import tree_leaves
from . import layers, moe, rglru, ssm
from .config import ArchConfig
from .layers import dense, mlp, rms_norm


def _ffn(p, cfg: ArchConfig, x):
    """The block's feed-forward: (output, MoE aux loss or None)."""
    if cfg.moe is not None:
        return moe.moe_block(p["moe"], cfg, x)
    return mlp(p["mlp"], x), None


def _period_split(cfg: ArchConfig) -> tuple[int, int]:
    period = len(cfg.layer_pattern)
    return cfg.n_layers // period, cfg.n_layers % period


def _blocks(cfg: ArchConfig, stack: dict, tail: list) -> list[tuple]:
    """(kind, block) in layer order: each period's `b{j}` views, then the
    tail, whose block t has the kind of the pattern's position t."""
    n_periods, _ = _period_split(cfg)
    return ([(kind, pp[f"b{j}"]) for pp in _periods(stack, n_periods)
             for j, kind in enumerate(cfg.layer_pattern)]
            + [(cfg.layer_pattern[t], blk) for t, blk in enumerate(tail)])


def _layers(params, cfg: ArchConfig, cache: dict) -> list[tuple]:
    """(kind, block params, block cache) in layer order."""
    return [(kind, p, c) for (kind, p), (_, c) in zip(
        _blocks(cfg, params["stack"], params["tail"]),
        _blocks(cfg, cache["slots"], cache["tail"]), strict=True)]


def _window(cfg: ArchConfig, kind: str) -> int:
    return cfg.window if kind == "local" else 0


# --------------------------------------------------------------------------
# Init
# --------------------------------------------------------------------------


def _block_init(generator, cfg: ArchConfig, kind: str, lead, device,
                dtype) -> dict:
    kw = {"lead": lead, "device": device, "dtype": dtype}
    zeros = lambda: torch.zeros(*lead, cfg.d_model, device=device, dtype=dtype)
    p = {"norm1": zeros()}
    if kind in ("attn", "local"):
        p["attn"] = layers.attn_init(generator, cfg, **kw)
        p["norm2"] = zeros()
        if cfg.moe is not None:
            p["moe"] = moe.moe_init(generator, cfg, **kw)
        else:
            p["mlp"] = layers.mlp_init(generator, cfg.d_model, cfg.d_ff,
                                       cfg.gated_mlp, **kw)
    elif kind == "ssm":
        p["ssm"] = ssm.ssm_init(generator, cfg, **kw)
    elif kind == "rglru":
        p["rec"] = rglru.rglru_init(generator, cfg, **kw)
        p["norm2"] = zeros()
        p["mlp"] = layers.mlp_init(generator, cfg.d_model, cfg.d_ff,
                                   cfg.gated_mlp, **kw)
    else:
        raise ValueError(kind)
    return p


def init_params(cfg: ArchConfig, *, generator: torch.Generator, device=None,
                dtype=torch.float32) -> dict:
    """Random parameters with the JAX `init_params` shapes and scales
    (N(0, 1/fan_in) matrices, N(0, 1/d_model) embeddings, zero biases and
    norm scales, the recurrent blocks' fixed leaves as `ssm.ssm_init` and
    `rglru.rglru_init` make them), drawn from `generator` in `dtype` — the
    values differ from JAX's.  An `embed_inputs` arch has no `embed`."""
    n_periods, n_tail = _period_split(cfg)
    inv = 1.0 / math.sqrt(cfg.d_model)
    normal = lambda *shape: torch.randn(*shape, generator=generator,
                                        device=device, dtype=dtype).mul_(inv)
    params = {}
    if not cfg.embed_inputs:
        params["embed"] = normal(cfg.vocab, cfg.d_model)
    params["stack"] = {
        f"b{j}": _block_init(generator, cfg, kind, (max(n_periods, 1),),
                             device, dtype)
        for j, kind in enumerate(cfg.layer_pattern)}
    params["tail"] = [_block_init(generator, cfg, cfg.layer_pattern[t], (),
                                  device, dtype) for t in range(n_tail)]
    params["final_norm"] = torch.zeros(cfg.d_model, device=device, dtype=dtype)
    if not cfg.tie_embeddings:
        params["lm_head"] = normal(cfg.d_model, cfg.vocab)
    return params


def _index(tree, i: int):
    """The i-th period of a stacked tree (views, no copies).  A
    QuantizedTensor slices both children, `QuantizedTensor(q[i],
    scale[i])`, and a SparseTensor its values and indices (n, m and
    k_dense kept), as `lax.scan` slices the pytree in the JAX package."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, QuantizedTensor):
        return QuantizedTensor(tree.q[i], tree.scale[i])
    if isinstance(tree, SparseTensor):
        return tree.index(i)
    return tree[i]


def _periods(stack: dict, n_periods: int) -> list[dict]:
    return [_index(stack, i) for i in range(n_periods)]


def _unbound_periods(stack, n_periods: int) -> list:
    """`_periods` for the full-sequence path: each tensor leaf `unbind`s
    once (views, as `_index` gives).  Under autograd a stacked leaf's
    gradient then gathers its periods' in one stack, where a select view
    per period would each add a zero-filled tensor of the whole stack
    (traffic growing with the square of the depth).  The cache paths keep
    `_periods`: they write through their views in place."""
    if isinstance(stack, dict):
        parts = {k: _unbound_periods(v, n_periods) for k, v in stack.items()}
        return [{k: parts[k][i] for k in stack} for i in range(n_periods)]
    if isinstance(stack, torch.Tensor):
        return list(stack.unbind(0))[:n_periods]
    return [_index(stack, i) for i in range(n_periods)]


# --------------------------------------------------------------------------
# Full-sequence path
# --------------------------------------------------------------------------


def _block_apply(kind: str, p, cfg: ArchConfig, x, positions):
    """One block of the full-sequence path: (x, MoE aux loss or None)."""
    norm = lambda scale, h: rms_norm(scale, h, cfg.norm_eps,
                                     cast_early=cfg.norm_cast_early)
    if kind in ("attn", "local"):
        x = x + layers.attention_block(p["attn"], cfg, norm(p["norm1"], x),
                                       positions, window=_window(cfg, kind))
        h, aux = _ffn(p, cfg, norm(p["norm2"], x))
        return x + h, aux
    if kind == "ssm":
        return x + ssm.ssm_block(p["ssm"], cfg, norm(p["norm1"], x)), None
    if kind == "rglru":
        x = x + rglru.rglru_block(p["rec"], cfg, norm(p["norm1"], x))
        return x + mlp(p["mlp"], norm(p["norm2"], x)), None
    raise ValueError(kind)


def _embed_in(params, cfg: ArchConfig, tokens, embeds, compute_dtype):
    """The model's input rows: the frame embeddings of an `embed_inputs`
    arch, else the token embeddings, after a VLM's prefix embeddings
    when `embeds` is given."""
    if cfg.embed_inputs:
        if embeds is None:
            raise ValueError(f"{cfg.name} takes frame embeddings (embeds=)")
        return embeds.to(compute_dtype)
    x = params["embed"].to(compute_dtype)[tokens.long()]
    if embeds is not None:
        x = torch.cat([embeds.to(compute_dtype), x], dim=1)
    return x


def _logits_out(params, cfg: ArchConfig, x):
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head.to(x.dtype)


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def _period_apply(cfg: ArchConfig, pp: dict, x, aux, positions):
    """One period of the stack (its blocks in pattern order): the body of
    the reference's scan, (x, aux) -> (x, aux)."""
    for j, kind in enumerate(cfg.layer_pattern):
        x, a = _block_apply(kind, pp[f"b{j}"], cfg, x, positions)
        if a is not None:
            aux = aux + a
    return x, aux


def forward(params, cfg: ArchConfig, tokens: torch.Tensor | None = None, *,
            embeds=None, compute_dtype=torch.bfloat16):
    """tokens (B, S); embeds (B, P, D) for the VLM prefix or (B, S, D) for
    audio (`embed_inputs`) -> (logits (B, S_total, V), aux scalar): the
    sum over blocks of the MoE balance loss (0 without MoE).

    When autograd records a gradient through the stack, each period runs
    under `torch.utils.checkpoint` (non-reentrant): its activations are
    recomputed in the backward, as the reference rematerialises its scan
    body (`jax.checkpoint`, reference `models/transformer.py:181`); the
    tail blocks are not.  The recompute runs inside the caller's
    `use_engine` scope, so the caller takes its gradients there."""
    x = _embed_in(params, cfg, tokens, embeds, compute_dtype)
    b, s = x.shape[0], x.shape[1]
    positions = _positions(b, s, x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    n_periods, _ = _period_split(cfg)
    remat = torch.is_grad_enabled() and (x.requires_grad or any(
        isinstance(t, torch.Tensor) and t.requires_grad
        for t in tree_leaves(params["stack"])))
    for pp in _unbound_periods(params["stack"], n_periods):
        if remat:
            x, aux = torch.utils.checkpoint.checkpoint(
                _period_apply, cfg, pp, x, aux, positions,
                use_reentrant=False)
        else:
            x, aux = _period_apply(cfg, pp, x, aux, positions)
    for t, p in enumerate(params["tail"]):
        x, a = _block_apply(cfg.layer_pattern[t], p, cfg, x, positions)
        if a is not None:
            aux = aux + a
    return _logits_out(params, cfg, x), aux


# --------------------------------------------------------------------------
# Cache + decode path
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CacheSpec:
    """Static description of the per-block cache.  `page_size` and
    `n_pages` select the paged layout: full-attention KV moves from
    per-slot `(B, max_seq, ...)` regions into one pool of `n_pages` fixed
    pages addressed through per-slot block tables; sliding-window rings
    and recurrent state keep their slot layout (they are O(window) and
    O(1) already)."""
    max_seq: int
    batch: int
    page_size: int | None = None
    n_pages: int | None = None


def _slot_cache(kind: str, cfg: ArchConfig, spec: CacheSpec, lead, dtype,
                device) -> dict:
    kv, hd = cfg.n_kv, cfg.head_dim_
    quant = dtype == torch.int8
    zeros = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)
    if kind in ("ssm", "rglru"):
        # int8 quantizes attention rows only: recurrent state is read,
        # updated and written every step and stays bf16
        sdt = torch.bfloat16 if quant else dtype
        if kind == "ssm":
            sc, d_in = cfg.ssm, cfg.ssm.expand * cfg.d_model
            conv_ch = d_in + 2 * sc.n_groups * sc.d_state
            return {"conv": zeros((*lead, spec.batch, sc.conv_width - 1,
                                   conv_ch), sdt),
                    "state": zeros((*lead, spec.batch, d_in // sc.head_dim,
                                    sc.d_state, sc.head_dim), torch.float32)}
        w = cfg.rglru_width or cfg.d_model
        return {"conv": zeros((*lead, spec.batch, 3, w), sdt),
                "h": zeros((*lead, spec.batch, w), sdt)}
    if kind not in ("attn", "local"):
        raise ValueError(kind)
    if kind == "attn" and spec.page_size:
        if not spec.n_pages:
            raise ValueError("paged CacheSpec needs n_pages")
        # physical page p of every layer lives in that layer's own pool at
        # row p: one block table addresses all layers.  Storage holds one
        # page more per layer, the sink of `layers.paged_slot_update`;
        # the pools are views that leave it out.  The int8 codec's per-row
        # scales page with their rows: same page index, same table, and a
        # sink page of their own.
        rows = (*lead, spec.n_pages + 1, spec.page_size, kv)
        cut = (slice(None),) * len(lead) + (slice(0, spec.n_pages),)
        c = {"k_pages": zeros((*rows, hd), dtype)[cut],
             "v_pages": zeros((*rows, hd), dtype)[cut]}
        if quant:
            c["k_scale_pages"] = zeros(rows, torch.float32)[cut]
            c["v_scale_pages"] = zeros(rows, torch.float32)[cut]
        return c
    # a "local" block keeps a ring of its window's rows
    size = spec.max_seq if kind == "attn" else min(cfg.window, spec.max_seq)
    rows = (*lead, spec.batch, size, kv)
    c = {"k": zeros((*rows, hd), dtype), "v": zeros((*rows, hd), dtype)}
    if quant:
        # one f32 scale per stored row per KV head, beside the int8 rows
        c["k_scale"] = zeros(rows, torch.float32)
        c["v_scale"] = zeros(rows, torch.float32)
    return c


def init_cache(cfg: ArchConfig, spec: CacheSpec, dtype=torch.bfloat16,
               device=None) -> dict:
    """{"t": (B,) int32 per-slot clock, "slots": {"b{j}": {...}} with the
    leading period axis, "tail": [...]}.  Contiguous: k/v (B, max_seq,
    KV, hd) per "attn" layer; paged: k_pages/v_pages (n_pages, page, KV,
    hd) per "attn" layer; a "local" layer's ring k/v (B, min(window,
    max_seq), KV, hd) on either layout; an "ssm" layer's conv (B, W - 1,
    conv_ch) and f32 state (B, H, N, P); an "rglru" layer's conv (B, 3,
    W) and h (B, W).  `dtype=torch.int8` selects the int8 codec for the
    attention kinds: the rows are int8 and k_scale/v_scale (B, rows,
    KV), or k_scale_pages/v_scale_pages (n_pages, page, KV), hold their
    f32 scales; recurrent state is then bf16."""
    if not (dtype.is_floating_point or dtype == torch.int8):
        raise ValueError(f"cache dtype {dtype}: a float dtype or int8 (the "
                         f"KV codec)")
    n_periods, n_tail = _period_split(cfg)
    return {"t": torch.zeros(spec.batch, dtype=torch.int32, device=device),
            "slots": {f"b{j}": _slot_cache(kind, cfg, spec, (n_periods,),
                                           dtype, device)
                      for j, kind in enumerate(cfg.layer_pattern)},
            "tail": [_slot_cache(cfg.layer_pattern[t], cfg, spec, (), dtype,
                                 device) for t in range(n_tail)]}


def _store(c: dict, k: torch.Tensor, v: torch.Tensor, paged: bool) -> dict:
    """Cache leaf name -> the values to write for new rows k/v (..., KV,
    D): the rows themselves, or on an int8 cache their codes and scales
    (the jitted form of the reference's codec: its cache writes run
    inside `jax.jit`)."""
    names = (("k_pages", "v_pages", "k_scale_pages", "v_scale_pages")
             if paged else ("k", "v", "k_scale", "v_scale"))
    if names[2] not in c:
        return {names[0]: k, names[1]: v}
    kq, ks = kv_quantize(k, jitted=True)
    vq, vs = kv_quantize(v, jitted=True)
    return dict(zip(names, (kq, vq, ks, vs), strict=True))


def _write_state(c: dict, new: dict, mask) -> None:
    """Write a recurrent block's new state (every slot computed) into its
    cache leaves in place, in their dtypes, only for the slots in `mask`
    (B,) (all when None): the other slots keep theirs bit for bit."""
    for name, val in new.items():
        val = val.to(c[name].dtype)
        if mask is not None:
            val = torch.where(mask.reshape((-1,) + (1,) * (val.dim() - 1)),
                              val, c[name])
        c[name].copy_(val)


def _decode_block(kind: str, p, cfg: ArchConfig, x, t, c: dict, active=None,
                  block_tables=None):
    """One-token step for one block of any kind."""
    if kind in ("attn", "local"):
        return _decode_attn(p, cfg, x, t, c, active, block_tables)
    xin = rms_norm(p["norm1"], x, cfg.norm_eps)
    if kind == "ssm":
        h, conv, state = ssm.ssm_decode_step(p["ssm"], cfg, xin, c["conv"],
                                             c["state"])
        _write_state(c, {"conv": conv, "state": state}, active)
        return x + h
    if kind == "rglru":
        h, conv, hstate = rglru.rglru_decode_step(p["rec"], cfg, xin,
                                                  c["conv"], c["h"])
        x = x + h
        _write_state(c, {"conv": conv, "h": hstate}, active)
        return x + mlp(p["mlp"], rms_norm(p["norm2"], x, cfg.norm_eps))
    raise ValueError(kind)


def _decode_attn(p, cfg: ArchConfig, x, t, c: dict, active=None,
                 block_tables=None):
    """One-token step for one attention block: writes the new KV row of every
    active slot at its own clock position, then attends its valid
    prefix.  Paged blocks (`"k_pages" in c`) resolve the write position
    through `block_tables` (B, n_bt); inactive slots and table holes
    write nowhere.  A contiguous cache shorter than the clock (a "local"
    block's ring) is written at `t % size` and attends its last `size`
    rows."""
    pos = t[:, None]
    q, k_new, v_new = layers.attn_qkv(p["attn"], cfg,
                                      rms_norm(p["norm1"], x, cfg.norm_eps), pos)
    if "k_pages" in c:
        if block_tables is None:
            raise ValueError("paged cache decode needs block_tables")
        page = c["k_pages"].shape[1]
        n_bt = block_tables.shape[1]
        pidx = (t // page).long()
        phys = block_tables.gather(1, pidx.clamp(max=n_bt - 1)[:, None])[:, 0]
        write = pidx < n_bt
        if active is not None:
            write = write & active
        phys = torch.where(write, phys, -1)
        off = t % page
        for name, val in _store(c, k_new[:, 0], v_new[:, 0], True).items():
            layers.paged_slot_update(c[name], phys, off, val)
        # full attention never wraps: the valid length is the clock
        h = layers.paged_cached_attention(p["attn"], cfg, q, c, block_tables,
                                          t + 1)
    else:
        size = c["k"].shape[1]
        idx = t % size
        for name, val in _store(c, k_new[:, 0], v_new[:, 0], False).items():
            layers.slot_update(c[name], idx, val, active)
        kv_len = torch.clamp(t + 1, max=size)
        h = layers.cached_attention(p["attn"], cfg, q, c["k"], c["v"], pos,
                                    kv_len, k_scale=c.get("k_scale"),
                                    v_scale=c.get("v_scale"))
    x = x + h
    return x + _ffn(p, cfg, rms_norm(p["norm2"], x, cfg.norm_eps))[0]


def decode_step(params, cfg: ArchConfig, cache: dict, token: torch.Tensor, *,
                compute_dtype=torch.bfloat16, active=None, block_tables=None):
    """token (B, 1) -> (logits (B, 1, V), cache with the clock advanced).

    `active` (B,) bool masks which slots consume a token: inactive slots
    keep their cache rows and clock, and their logits rows are garbage to
    discard.  `block_tables` (B, n_bt) int32 addresses the paged pools
    (required iff the cache is paged); every layer reads the same
    table.  A recurrent block updates its state for the active slots
    only."""
    if cfg.embed_inputs:
        raise ValueError("encoder-only arch: no decode step")
    t = cache["t"]
    x = params["embed"].to(compute_dtype)[token.long()]
    for kind, p, c in _layers(params, cfg, cache):
        x = _decode_block(kind, p, cfg, x, t, c, active, block_tables)
    new_t = t + 1 if active is None else torch.where(active, t + 1, t)
    return _logits_out(params, cfg, x), {**cache, "t": new_t}


def _ring_place(k: torch.Tensor, lengths: torch.Tensor,
                size: int) -> torch.Tensor:
    """Per-slot ring placement: each slot's last `size` valid rows at
    their ring positions (pos % size).  k (B, S, ...): rows (KV, hd) or
    the int8 codec's scales (KV,).  A slot shorter than the ring keeps
    rows [0, L) at their own positions (rows >= L are pad rows, masked by
    the slot's clock at decode)."""
    s = k.shape[1]
    r = torch.arange(size, device=k.device)[None, :]
    ll = lengths.long()[:, None]
    pos = torch.where(ll >= size, ll - size + torch.remainder(r - ll, size),
                      r).clamp(0, s - 1)
    idx = pos.reshape(pos.shape + (1,) * (k.dim() - 2)).expand(
        -1, -1, *k.shape[2:])
    return torch.gather(k, 1, idx)


def _contiguous_prefill_write(c: dict, store: dict, lengths, update_mask,
                              live_only: bool = False) -> None:
    """Write the prompt rows `store` (`_store`: on an int8 cache their
    codes and scales) into a contiguous cache, in place: rows [0, S) when
    the cache holds them; else a ring: the last rows rolled to their ring
    positions, or, for a ragged batch, each slot's own last rows
    (`_ring_place`).  Slots outside `update_mask` are not written (the
    JAX package merges their old rows back); with `live_only` neither are
    the rows past a slot's length (the JAX chunk continuation writes a
    slot's rows one by one and skips the pad rows)."""
    s = store["k"].shape[1]
    size = c["k"].shape[1]
    keep = None if update_mask is None else update_mask[:, None]
    if live_only:
        r = torch.arange(min(size, s), device=lengths.device)[None, :]
        ll = lengths.long()[:, None]
        live = (r < ll) | (ll >= size)
        keep = live if keep is None else keep & live
    for name, val in store.items():
        dst = c[name]
        if size >= s:
            new, view = val, dst[:, :s]
        elif lengths is None:  # the last `size` rows, rolled to pos % size
            new, view = torch.roll(val[:, -size:], s % size, dims=1), dst
        else:
            new, view = _ring_place(val, lengths, size), dst
        if keep is not None:
            mask = keep.reshape(keep.shape + (1,) * (val.dim() - 2))
            new = torch.where(mask, new.to(dst.dtype), view)
        view.copy_(new)


def _paged_prefill_attn(cfg: ArchConfig, q, k, v, c: dict, positions,
                        lengths, update_mask, block_tables, hist_len,
                        hist_pages: int):
    """Paged prefill: scatter the suffix rows through the block table and
    attend over (gathered history pages + suffix) with the plain scan.

    The attention buffer is logical-row indexed — row r holds the token
    at absolute position r — built from `hist_pages` gathered pages plus
    the suffix at its absolute rows.  Rows past a slot's length and slots
    outside `update_mask` write nowhere in the pool.  On int8 pools the
    suffix is written quantized but attended in float, as the reference
    attends it; only the shared-history rows are read back, dequantized
    to the compute dtype."""
    b, s, kv, hd = k.shape
    n_pool, page = c["k_pages"].shape[0], c["k_pages"].shape[1]
    n_bt = block_tables.shape[1]
    dev = k.device
    ll = lengths.long()
    hist0 = (torch.zeros((b,), device=dev) if hist_len is None
             else hist_len).long()
    j = torch.arange(s, device=dev)[None, :]
    absp = hist0[:, None] + j                       # (B, S) absolute rows
    valid = j < ll[:, None]
    if update_mask is not None:
        valid = valid & update_mask[:, None]
    pidx = (absp // page).clamp(0, n_bt - 1)
    phys = block_tables.gather(1, pidx)
    phys = torch.where(valid, phys, -1)
    off = absp % page
    for name, val in _store(c, k, v, True).items():
        layers.paged_slot_update(c[name], phys, off, val)

    h0 = hist_pages * page
    # one spare row past the buffer takes the rows that write nowhere
    bufk = torch.zeros((b, h0 + s + 1, kv, hd), dtype=k.dtype, device=dev)
    bufv = torch.zeros((b, h0 + s + 1, kv, hd), dtype=v.dtype, device=dev)
    if h0:
        idx = block_tables[:, :hist_pages].clamp(0, n_pool - 1).long()
        hk = c["k_pages"][idx].reshape(b, h0, kv, hd)
        hv = c["v_pages"][idx].reshape(b, h0, kv, hd)
        if "k_scale_pages" in c:
            hk = kv_dequantize(hk, c["k_scale_pages"][idx].reshape(b, h0, kv),
                               k.dtype)
            hv = kv_dequantize(hv, c["v_scale_pages"][idx].reshape(b, h0, kv),
                               v.dtype)
        bufk[:, :h0] = hk.to(k.dtype)
        bufv[:, :h0] = hv.to(v.dtype)
    rows = torch.where(valid, absp, h0 + s)
    bidx = torch.arange(b, device=dev)[:, None]
    bufk[bidx, rows] = k
    bufv[bidx, rows] = v
    return layers.flash_attention(q, bufk[:, :h0 + s], bufv[:, :h0 + s],
                                  positions, hist0 + ll, cfg.is_causal, 0,
                                  min(512, h0 + s))


def _chunk_state(c: dict, hist_len, names: tuple[str, ...]) -> dict:
    """The recurrent state a chunk continuation seeds its scan with: the
    slot's stored state, zero for a slot with no history (a first chunk
    starts from the fresh state, not the slot's previous occupant's; zero
    is the fresh conv window, SSD state and h alike), so one call mixes
    first and continuation chunks."""
    live = hist_len > 0
    return {nm: torch.where(live.reshape((-1,) + (1,) * (c[nm].dim() - 1)),
                            c[nm], torch.zeros((), dtype=c[nm].dtype,
                                               device=c[nm].device))
            for nm in names}


def _chunk_write_mask(lengths, update_mask, s: int):
    """(B, S) rows of a chunk that are written: a slot's first `lengths`
    rows, in the slots of `update_mask`."""
    valid = torch.arange(s, device=lengths.device)[None, :] < lengths[:, None]
    return valid if update_mask is None else valid & update_mask[:, None]


def _chunk_prefill_attn(cfg: ArchConfig, kind: str, q, store: dict, c: dict,
                        positions, lengths, update_mask):
    """Contiguous chunk continuation of an attention block: the chunk's
    rows join a cache that holds each slot's earlier chunks at rows
    [0, hist), `positions` (B, S) carrying the absolute positions.
    Returns the heads (B, S, H, D) before `wo`.

    "attn": every written row lands at its absolute row in one shot, and
    the chunk attends with the per-query `kv_len = min(pos + 1, size)`,
    the decode step's masked read.  "local": a write at position p
    overwrites the ring row of p - size, which is still in the window of
    every earlier query of the chunk, so the ring steps write-then-attend
    one query at a time (only the attention: QKV and the feed-forward stay
    chunk-wide), the decode step's order of operations; rows past a
    slot's chunk length write nothing, so live window rows survive.  The
    JAX package's `_chunk_prefill_attn` does the same."""
    b, s = q.shape[0], q.shape[1]
    size = c["k"].shape[1]
    write = _chunk_write_mask(lengths, update_mask, s)
    scales = lambda: {"k_scale": c.get("k_scale"), "v_scale": c.get("v_scale")}
    if kind == "attn":
        rows = positions.clamp(0, size - 1).long()
        bidx = torch.arange(b, device=q.device)[:, None]
        for name, val in store.items():
            mask = write.reshape(write.shape + (1,) * (val.dim() - 2))
            layers.slot_update_many(
                c[name], rows,
                torch.where(mask, val.to(c[name].dtype), c[name][bidx, rows]))
        return layers.cached_heads(q, c["k"], c["v"],
                                   torch.clamp(positions + 1, max=size),
                                   **scales())
    heads = []
    for i in range(s):
        pos_i = positions[:, i]
        for name, val in store.items():
            layers.slot_update(c[name], pos_i % size, val[:, i], write[:, i])
        heads.append(layers.cached_heads(q[:, i:i + 1], c["k"], c["v"],
                                         torch.clamp(pos_i + 1, max=size),
                                         **scales()))
    return torch.cat(heads, dim=1)


def _prefill_block(kind: str, p, cfg: ArchConfig, x, positions, c: dict,
                   lengths=None, update_mask=None, block_tables=None,
                   hist_len=None, hist_pages: int = 0, history: bool = False):
    """One block of `prefill`.  With `hist_len` a contiguous block
    continues from each slot's resident rows or state (`history`: some
    slot of the call has a nonzero history)."""
    b, s = x.shape[0], x.shape[1]
    xin = rms_norm(p["norm1"], x, cfg.norm_eps)
    if kind in ("ssm", "rglru"):
        names = ("conv", "state") if kind == "ssm" else ("conv", "h")
        st = None if hist_len is None else _chunk_state(c, hist_len, names)
        if kind == "ssm":
            h, *new = ssm.ssm_prefill(p["ssm"], cfg, xin, lengths, state=st)
        else:
            h, *new = rglru.rglru_prefill(p["rec"], cfg, xin, lengths,
                                          state=st)
        x = x + h
        _write_state(c, dict(zip(names, new, strict=True)), update_mask)
        if kind == "ssm":
            return x
        return x + mlp(p["mlp"], rms_norm(p["norm2"], x, cfg.norm_eps))
    q, k, v = layers.attn_qkv(p["attn"], cfg, xin, positions)
    if "k_pages" in c:
        if block_tables is None:
            raise ValueError("paged cache prefill needs block_tables")
        o = _paged_prefill_attn(cfg, q, k, v, c, positions, lengths,
                                update_mask, block_tables, hist_len,
                                hist_pages)
    elif hist_len is not None and (history or kind == "attn"):
        # chunk continuation
        o = _chunk_prefill_attn(cfg, kind, q, _store(c, k, v, False), c,
                                positions, lengths, update_mask)
    else:
        store = _store(c, k, v, False)
        _contiguous_prefill_write(c, store, lengths, update_mask,
                                  live_only=hist_len is not None)
        if hist_len is not None:
            # a ring block where no slot has history: the continuation
            # would step each query over the ring as stored, which holds
            # only this chunk's rows of a slot (earlier rows are masked
            # by the clock), so attend the rows as stored at once (int8:
            # their codes times their scales)
            k, v = ((kv_dequantize(store[n], store[f"{n}_scale"])
                     if f"{n}_scale" in store else store[n].to(c[n].dtype))
                    for n in ("k", "v"))
        o = layers.full_attention(cfg, q, k, v, positions,
                                  _window(cfg, kind), lengths)
    x = x + dense(p["attn"]["wo"], o.reshape(b, s, cfg.n_heads * cfg.head_dim_))
    return x + _ffn(p, cfg, rms_norm(p["norm2"], x, cfg.norm_eps))[0]


def prefill(params, cfg: ArchConfig, tokens: torch.Tensor | None,
            cache: dict, *, embeds=None, compute_dtype=torch.bfloat16,
            lengths=None, update_mask=None, block_tables=None, hist_len=None,
            hist_pages: int = 0):
    """Run the prompt (B, S), filling `cache` in place; returns (last-token
    logits (B, 1, V), cache with its new clock).  `embeds` as `forward`
    takes them: a VLM's (B, P, D) prefix runs before the tokens and the
    clock is then P + S.

    Ragged mode: `lengths` (B,) marks each slot's valid prefix of a
    right-padded `tokens` batch; logits come from each slot's own last
    row and the clock is set to `lengths`.  `update_mask` (B,) restricts
    which slots' rows and clocks are written at all, so a scheduler can
    admit into free slots of a live cache.

    Paged mode: `block_tables` (B, n_bt) addresses the pools.  `hist_len`
    (B,) counts the prompt tokens already resident in each slot's shared
    prefix pages: `tokens` then holds only the suffix, queries take
    absolute positions `hist_len + i`, and the clock counts the history
    too.  `hist_pages` bounds the history gather: max(hist_len) // page.

    Chunked mode: on a contiguous block (any block of a contiguous cache;
    a ring or recurrent block of a paged one) `hist_len` (B,) counts the
    tokens a slot already prefilled in earlier chunk calls: `tokens`
    holds the next chunk, and every kind continues from the slot's
    resident state ("attn" rows land at their absolute rows, a ring steps
    write-then-attend as decode does, a recurrent scan seeds from the
    stored state; `_chunk_prefill_attn`, `_chunk_state`).  A slot with
    `hist_len` 0 starts afresh, so one call mixes first and continuation
    chunks.  A ragged prefill takes no `embeds`, as in the JAX package.

    A "local" block attends its prompt with `layers.local_attention` and
    keeps its last `size` rows in its ring (`_ring_place` per slot for a
    ragged batch); a recurrent block scans the prompt and keeps the state
    at each slot's last valid token."""
    if lengths is not None and (embeds is not None or cfg.prefix_tokens):
        raise NotImplementedError(
            "ragged prefill does not support embeds / VLM prefix archs")
    if block_tables is not None and lengths is None:
        raise NotImplementedError("paged prefill is ragged-only (pass lengths)")
    if hist_len is not None and lengths is None:
        raise NotImplementedError(
            "hist_len (chunked/suffix continuation) is ragged-only (pass "
            "lengths)")
    if hist_pages and hist_len is None:
        raise ValueError("hist_pages needs hist_len")
    if hist_pages and block_tables is None:
        raise ValueError("hist_pages needs block_tables (paged cache)")
    layer_list = _layers(params, cfg, cache)
    if block_tables is not None and hist_pages > block_tables.shape[1]:
        raise ValueError(f"hist_pages {hist_pages} exceeds block table "
                         f"span {block_tables.shape[1]}")
    x = _embed_in(params, cfg, tokens, embeds, compute_dtype)
    b, s = x.shape[0], x.shape[1]
    positions = _positions(b, s, x.device)
    if hist_len is not None:
        positions = positions + hist_len[:, None].to(positions.dtype)
    # a ring continues write-then-attend only where some slot has history
    history = (hist_len is not None
               and any(k == "local" for k, _, _ in layer_list)
               and bool(hist_len.any()))
    kw = {"lengths": lengths, "update_mask": update_mask,
          "block_tables": block_tables, "hist_len": hist_len,
          "hist_pages": hist_pages, "history": history}
    for kind, p, c in layer_list:
        x = _prefill_block(kind, p, cfg, x, positions, c, **kw)
    if lengths is None:
        logits = _logits_out(params, cfg, x[:, -1:])
        new_t = torch.full((b,), s, dtype=torch.int32, device=x.device)
    else:
        last = layers.gather_rows(x, torch.clamp(lengths, 1, s) - 1)
        logits = _logits_out(params, cfg, last)
        new_t = lengths.to(torch.int32)
        if hist_len is not None:
            # the clock counts ALL resident rows, shared prefix included
            new_t = new_t + hist_len.to(torch.int32)
    if update_mask is not None:
        new_t = torch.where(update_mask, new_t, cache["t"])
    return logits, {**cache, "t": new_t}


# --------------------------------------------------------------------------
# Speculative decoding
# --------------------------------------------------------------------------
#
#   spec_forward   one W-wide teacher-forced pass (W = k + 1 verify tokens)
#                  that writes all W rows or states of every slot in place
#                  and returns an `undo` record: copies taken before the
#                  writes, sized to what a rollback of each kind needs;
#   spec_commit    clock = t0 + keep per slot, and the repair: nothing for
#                  full attention (rejected rows sit past the clock,
#                  masked everywhere), the overwritten ring rows past
#                  `keep` restored for a sliding window, the state after
#                  `keep` tokens taken from a (W + 1)-stash for "ssm" and
#                  "rglru".
#
# `verify_step` composes them with the greedy accept rule; `spec_advance`
# replays the verify window through the draft's cache with the target's
# `keep`; `draft_propose` drafts k tokens with k decode steps and puts
# back what they overwrote.  The recurrent kinds step the same
# `*_decode_step` functions the decode path uses, and attention reads the
# rows a sequence of 1-wide steps would have written, as in the JAX
# package.


def _spec_attn(p, cfg: ArchConfig, kind: str, x, pos, c: dict, active,
               block_tables):
    """The W-wide verify of an attention block: (its output after `wo`,
    undo)."""
    b, w = x.shape[0], x.shape[1]
    q, k_new, v_new = layers.attn_qkv(p["attn"], cfg,
                                      rms_norm(p["norm1"], x, cfg.norm_eps),
                                      pos)
    if "k_pages" in c:
        if block_tables is None:
            raise ValueError("paged cache decode needs block_tables")
        page, n_bt = c["k_pages"].shape[1], block_tables.shape[1]
        pidx = (pos // page).long()
        phys = block_tables.gather(1, pidx.clamp(max=n_bt - 1))    # (B, W)
        write = pidx < n_bt
        if active is not None:
            write = write & active[:, None]
        phys = torch.where(write, phys, -1)            # -1: the sink page
        for name, val in _store(c, k_new, v_new, True).items():
            layers.paged_slot_update(c[name], phys, pos % page, val)
        # a per-query valid length pos + 1 makes the pass causal (the
        # plain gather: the paged kernel is Sq == 1 only); full attention
        # never wraps, so rejected rows sit past the rolled-back clock
        # (their pages are released on the host): no undo
        return layers.paged_cached_attention(p["attn"], cfg, q, c,
                                             block_tables, pos + 1), {}
    size = c["k"].shape[1]
    idx = (pos % size).long()                                     # (B, W)
    store = _store(c, k_new, v_new, False)
    scales = {"k_scale": c.get("k_scale"), "v_scale": c.get("v_scale")}
    if kind == "attn":
        # full attention never wraps (headroom is checked at submit): all
        # W rows land before one pass with a per-query valid length
        for name, val in store.items():
            layers.slot_update_many(c[name], idx, val)
        return layers.cached_attention(p["attn"], cfg, q, c["k"], c["v"], pos,
                                       torch.clamp(pos + 1, max=size),
                                       **scales), {}
    # A ring cannot take the W writes at once: the write of token i
    # overwrites the row of position t + i - size, still in the window of
    # every earlier query.  So the attention steps the ring one query at
    # a time (the decode step's write-then-attend), after copying the W
    # rows it overwrites for the rollback (W <= the ring's rows, checked
    # by the Scheduler, so no row is written twice).
    bidx = torch.arange(b, device=x.device)[:, None]
    undo = {"idx": idx, "rows": {name: c[name][bidx, idx] for name in store}}
    heads = []
    for i in range(w):
        for name, val in store.items():
            layers.slot_update(c[name], idx[:, i], val[:, i])
        heads.append(layers.cached_heads(
            q[:, i:i + 1], c["k"], c["v"],
            torch.clamp(pos[:, i] + 1, max=size), **scales))
    o = torch.cat(heads, dim=1).reshape(b, w, cfg.n_heads * cfg.head_dim_)
    return dense(p["attn"]["wo"], o), undo


def _spec_recurrent(kind: str, p, cfg: ArchConfig, xin, c: dict):
    """Step a recurrent block's decode update over the W tokens of xin
    (B, W, D): (outputs (B, W, D), undo), the undo a (W + 1)-stash per
    state leaf, stash[i] the state after i tokens.  The final state is
    written in place for every slot (`spec_commit` picks each slot's)."""
    names = ("conv", "state") if kind == "ssm" else ("conv", "h")
    cur = {name: c[name] for name in names}
    stash = {name: [cur[name]] for name in names}
    ys = []
    for i in range(xin.shape[1]):
        xt = xin[:, i:i + 1]
        if kind == "ssm":
            y, *new = ssm.ssm_decode_step(p["ssm"], cfg, xt, cur["conv"],
                                          cur["state"])
        else:
            y, *new = rglru.rglru_decode_step(p["rec"], cfg, xt, cur["conv"],
                                              cur["h"])
        cur = {name: val.to(c[name].dtype)
               for name, val in zip(names, new, strict=True)}
        for name in names:
            stash[name].append(cur[name])
        ys.append(y)
    undo = {name: torch.stack(vals) for name, vals in stash.items()}
    _write_state(c, cur, None)
    return torch.cat(ys, dim=1), undo


def _spec_block(kind: str, p, cfg: ArchConfig, x, t, c: dict, active=None,
                block_tables=None):
    """The W-wide teacher-forced step of one block at positions t .. t + W
    - 1 per slot: (x, undo), the cache written in place, `undo` what
    `_commit_block` needs to roll the block back to any prefix of [0, W]."""
    w = x.shape[1]
    pos = t[:, None] + torch.arange(w, dtype=t.dtype, device=x.device)[None]
    if kind in ("attn", "local"):
        h, undo = _spec_attn(p, cfg, kind, x, pos, c, active, block_tables)
        x = x + h
        return x + _ffn(p, cfg, rms_norm(p["norm2"], x, cfg.norm_eps))[0], undo
    if kind not in ("ssm", "rglru"):
        raise ValueError(kind)
    h, undo = _spec_recurrent(kind, p, cfg,
                              rms_norm(p["norm1"], x, cfg.norm_eps), c)
    x = x + h
    if kind == "rglru":
        x = x + mlp(p["mlp"], rms_norm(p["norm2"], x, cfg.norm_eps))
    return x, undo


def spec_forward(params, cfg: ArchConfig, cache: dict, tokens, *,
                 compute_dtype=torch.bfloat16, active=None,
                 block_tables=None):
    """tokens (B, W) teacher-forced at positions t .. t + W - 1 -> (logits
    (B, W, V), cache, undo).  All W rows and states are written in place;
    the clock is not advanced: `spec_commit` with `undo` keeps each
    slot's accepted prefix.  `undo` holds copies taken before the writes
    (never views of the cache)."""
    if cfg.embed_inputs:
        raise ValueError("encoder-only arch: no decode step")
    t = cache["t"]
    x = params["embed"].to(compute_dtype)[tokens.long()]
    undo = []
    for kind, p, c in _layers(params, cfg, cache):
        x, u = _spec_block(kind, p, cfg, x, t, c, active, block_tables)
        undo.append(u)
    return _logits_out(params, cfg, x), cache, {"t0": t, "blocks": undo}


def _commit_block(kind: str, c: dict, undo: dict, keep) -> None:
    """Roll one block's speculative writes back to `keep` (B,) tokens, in
    place."""
    if not undo:  # full attention: the clock masks the rejected rows
        return
    if kind == "local":  # put back the ring rows past each slot's keep
        idx = undo["idx"]                                           # (B, W)
        bidx = torch.arange(idx.shape[0], device=idx.device)[:, None]
        kept = (torch.arange(idx.shape[1], device=idx.device)[None, :]
                < keep[:, None])
        for name, old in undo["rows"].items():
            cur = c[name][bidx, idx]
            mask = kept.reshape(kept.shape + (1,) * (cur.dim() - 2))
            c[name][bidx, idx] = torch.where(mask, cur, old)
        return
    # recurrent: the state after `keep` tokens, from the (W + 1)-stash
    slots = torch.arange(keep.shape[0], device=keep.device)
    for name, stash in undo.items():
        c[name].copy_(stash[keep.long(), slots])


def spec_commit(cfg: ArchConfig, cache: dict, undo: dict, keep) -> dict:
    """Accept each slot's first `keep` (B,) of the W speculative tokens:
    the clock t0 + keep, and `_commit_block`'s repairs in place.  keep == 0
    leaves a slot as it was: its rows below the clock, its ring rows and
    its recurrent state bit for bit."""
    keep = keep.to(torch.int32)
    for (kind, c), u in zip(_blocks(cfg, cache["slots"], cache["tail"]),
                            undo["blocks"], strict=True):
        _commit_block(kind, c, u, keep)
    return {**cache, "t": undo["t0"] + keep}


def verify_step(params, cfg: ArchConfig, cache: dict, tokens, *,
                compute_dtype=torch.bfloat16, active=None, block_tables=None):
    """Score W = k + 1 verify tokens (each slot's last token and its k
    drafts) in one pass and accept greedily the longest matching prefix.

    Returns (g (B, W) int32, n_acc (B,), cache): g[b, :n_acc[b] + 1] is
    the stream target-only greedy decode emits (the accepted drafts and
    one correction or bonus token), and the cache is committed to keep =
    n_acc + 1 rows per active slot (0 for the others)."""
    logits, cache, undo = spec_forward(
        params, cfg, cache, tokens, compute_dtype=compute_dtype,
        active=active, block_tables=block_tables)
    g = logits.argmax(dim=-1).to(torch.int32)                      # (B, W)
    match = (g[:, :-1] == tokens[:, 1:]).to(torch.int32)
    n_acc = torch.cumprod(match, dim=1).sum(dim=1).to(torch.int32)  # (B,)
    keep = n_acc + 1
    if active is not None:
        keep = torch.where(active, keep, 0)
        n_acc = torch.where(active, n_acc, 0)
    return g, n_acc, spec_commit(cfg, cache, undo, keep)


def spec_advance(params, cfg: ArchConfig, cache: dict, tokens, keep, *,
                 compute_dtype=torch.bfloat16, active=None,
                 block_tables=None) -> dict:
    """Replay `tokens` (B, W) through `cache` and commit `keep` (B,) of
    them: the draft's half of a speculative tick, its cache taking the
    verify window the target scored, cut to what the target accepted."""
    _, cache, undo = spec_forward(
        params, cfg, cache, tokens, compute_dtype=compute_dtype,
        active=active, block_tables=block_tables)
    keep = keep.to(torch.int32)
    if active is not None:
        keep = torch.where(active, keep, 0)
    return spec_commit(cfg, cache, undo, keep)


def _propose_saves(cfg: ArchConfig, cache: dict, n: int) -> list:
    """Copies of what `n` decode steps from the clock overwrite in a
    contiguous cache: each attention block's rows (t + j) % size, j < n,
    and each recurrent block's state."""
    t = cache["t"]
    saves = []
    for _, c in _blocks(cfg, cache["slots"], cache["tail"]):
        if "k_pages" in c:
            raise ValueError("draft_propose runs on a contiguous cache")
        if "k" in c:
            size = c["k"].shape[1]
            idx = ((t[:, None] + torch.arange(n, dtype=t.dtype,
                                              device=t.device)) % size).long()
            bidx = torch.arange(t.shape[0], device=t.device)[:, None]
            saves.append((c, (bidx, idx), {name: val[bidx, idx]
                                           for name, val in c.items()}))
        else:
            saves.append((c, None, {name: val.clone()
                                    for name, val in c.items()}))
    return saves


def draft_propose(params, cfg: ArchConfig, cache: dict, token, n: int, *,
                  compute_dtype=torch.bfloat16, active=None):
    """Greedily propose `n` draft tokens from `token` (B,): `n` decode
    steps with argmax feedback.  The caller's cache is not advanced: the
    steps write in place, and what they overwrote is put back after them
    (the persistent draft cache advances by `spec_advance` replaying the
    verify window).  Returns (B, n) int32."""
    saves = _propose_saves(cfg, cache, n)
    tok = token.to(torch.int32)
    drafts = []
    try:
        cc = cache
        for _ in range(n):
            logits, cc = decode_step(params, cfg, cc, tok[:, None],
                                     compute_dtype=compute_dtype,
                                     active=active)
            tok = logits[:, -1].argmax(dim=-1).to(torch.int32)
            drafts.append(tok)
    finally:
        for c, where, vals in saves:
            for name, val in vals.items():
                if where is None:
                    c[name].copy_(val)
                else:
                    c[name][where] = val
    return torch.stack(drafts, dim=1)

"""Core model layers on PyTorch tensors (the port of
`repro/models/layers.py`, attention-decoder subset): params are plain
dicts.

Numerics follow the JAX package: RMSNorm scaling by `1 + scale`, rotary
embeddings over interleaved pairs, grouped-query attention with optional
QKV bias and qk-norm, SwiGLU MLPs.  Full-sequence attention is the
chunked online softmax of `_flash_scan`, whose VJP is the reference's
(`FlashScan`: the backward recomputes each chunk's probabilities from the
saved log-sum-exp), or, for causal sliding-window ("local") blocks, the
exact two-chunk `local_attention` (on autograd, as in the reference);
decode attention is a plain masked softmax over the cache (or its ring),
or over the paged pool through the engine's `paged_attention` kernel.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..engine import active_engine
from ..kernels.paged_attention import paged_attention_reference
from ..kernels.ref import wants_grad
from ..quant.quantize import QuantizedTensor
from ..sparse.nm import SparseTensor

NEG_INF = -1e30


# --------------------------------------------------------------------------
# Param init
# --------------------------------------------------------------------------


def dense_init(generator: torch.Generator, d_in: int, d_out: int, *,
               bias: bool = False, lead=(), device=None,
               dtype=torch.float32) -> dict:
    """N(0, 1/d_in) weights (d_in, d_out) and zero bias; `lead` prepends
    axes (the stacked period axis)."""
    # scaled in place: no second weight-sized temporary
    p = {"w": torch.randn(*lead, d_in, d_out, generator=generator,
                          device=device, dtype=dtype).div_(math.sqrt(d_in))}
    if bias:
        p["b"] = torch.zeros(*lead, d_out, device=device, dtype=dtype)
    return p


# --------------------------------------------------------------------------
# Dense, norm, rotary
# --------------------------------------------------------------------------


def dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x @ w (+ b).  Inside a `use_engine` context the matmul routes
    through the engine's planned kernel; outside it, plain `@`.

    A `quant.quantize_params` weight (QuantizedTensor: int8 storage and
    per-channel scales) dispatches the planned `gemm_w8` kernel on an
    int8 engine, so the stored weight never becomes float; on any other
    posture it dequantizes to the compute dtype first.  A
    `sparse.prune_params` weight (SparseTensor: N:M compressed values and
    int8 offsets) dispatches the planned `gemm_sparse` kernel on a sparse
    engine and densifies to the compute dtype on any other posture."""
    w = p["w"]
    x2d = x.reshape(-1, x.shape[-1]).contiguous()
    eng = active_engine()
    quantized = isinstance(w, QuantizedTensor)
    sparse = isinstance(w, SparseTensor)
    if sparse and eng is not None and eng.sparse:
        y2d = eng.sparse_matmul(x2d, w, out_dtype=x.dtype)
    elif quantized and eng is not None and eng.int8:
        y2d = eng.quant_matmul(x2d, w.q, w.scale, out_dtype=x.dtype)
    else:
        if sparse:
            wf = w.densify(x.dtype)
        elif quantized:
            wf = w.dequantize(x.dtype)
        else:
            wf = w.to(x.dtype)
        y2d = (eng.matmul(x2d, wf, out_dtype=x.dtype) if eng is not None
               else x2d @ wf)
    y = y2d.reshape(*x.shape[:-1], w.shape[-1])
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def rms_norm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6,
             cast_early: bool = True) -> torch.Tensor:
    x32 = x.float()
    inv = torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    if cast_early:
        # cast to the compute dtype BEFORE the scale multiply, as the JAX
        # package does (`layers.py:78`)
        return (x32 * inv).to(x.dtype) * (1.0 + scale).to(x.dtype)
    return (x32 * inv * (1.0 + scale.float())).to(x.dtype)


def slot_update(cache: torch.Tensor, idx: torch.Tensor, new: torch.Tensor,
                active: torch.Tensor | None = None) -> torch.Tensor:
    """Write one row per batch slot at that slot's own clock position:
    cache (B, S, ...), idx (B,), new (B, ...).  `active` (B,) bool masks
    the write: inactive slots keep their stored row.  In place (the JAX
    function returns a new array): the cache is the largest decode-time
    tensor, and nothing keeps its old rows."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    idx = idx.long()
    val = new.to(cache.dtype)
    if active is not None:
        keep = active.reshape((-1,) + (1,) * (val.dim() - 1))
        val = torch.where(keep, val, cache[rows, idx])
    cache[rows, idx] = val
    return cache


def slot_update_many(cache: torch.Tensor, idx: torch.Tensor,
                     new: torch.Tensor) -> torch.Tensor:
    """Write W rows per batch slot, in place: cache (B, S, ...), idx (B, W),
    new (B, W, ...).  The speculative verify writes a slot's k + 1 rows at
    once; a caller that must leave a row as it was passes its old value
    (with W > 1 an index sentinel would need W parking rows)."""
    bidx = torch.arange(cache.shape[0], device=cache.device)[:, None]
    cache[bidx, idx.long()] = new.to(cache.dtype)
    return cache


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-slot row gather: x (B, S, ...), idx (B,) -> (B, 1, ...)."""
    rows = torch.arange(x.shape[0], device=x.device)
    return x[rows, idx.long()][:, None]


def paged_slot_update(pool: torch.Tensor, page_idx: torch.Tensor,
                      offset: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Write rows into the paged pool in place: pool (P, page, ...);
    page_idx / offset (...) name each row's physical page and in-page
    row; new (..., *pool.shape[2:]).

    A page index outside [0, P) writes nowhere, as the JAX package's
    `mode="drop"` scatter drops it.  torch has no drop mode, and a
    clamped index would alias a live page, so those rows go to the sink
    page that `transformer.init_cache` keeps in storage just past every
    pool: it is never addressed by a block table and never read."""
    n = pool.shape[0]
    needed = pool.storage_offset() + (n + 1) * pool.stride(0)
    if not pool.is_contiguous() or needed > pool.untyped_storage().nbytes() \
            // pool.element_size():
        raise ValueError("paged_slot_update needs a contiguous pool with a "
                         "sink page past its end (build the cache with "
                         "transformer.init_cache)")
    with_sink = pool.as_strided((n + 1, *pool.shape[1:]), pool.stride(),
                                pool.storage_offset())
    dest = torch.where((page_idx >= 0) & (page_idx < n), page_idx, n)
    with_sink[dest.long(), offset.long()] = new.to(pool.dtype)
    return pool


def rotary(x: torch.Tensor, positions: torch.Tensor,
           theta: float) -> torch.Tensor:
    """x: (B, S, H, D), positions: (B, S) -> x with interleaved pairs
    (x[..., ::2], x[..., 1::2]) rotated (not the NeoX half split)."""
    d = x.shape[-1]
    freq = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                   device=x.device) / d)
    angle = positions[..., None].float() * freq  # (B, S, D/2)
    cos, sin = angle.cos()[:, :, None, :], angle.sin()[:, :, None, :]
    x1, x2 = x[..., ::2].float(), x[..., 1::2].float()
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


# --------------------------------------------------------------------------
# Flash attention (chunked online softmax, custom VJP)
# --------------------------------------------------------------------------


def _chunk_mask(q_pos, k_pos, kv_len, causal: bool, window: int):
    """(B, Sq, C) boolean mask for one KV chunk. q_pos (B,Sq), k_pos (C,)."""
    m = k_pos[None, None, :] < kv_len[:, None, None]
    if causal:
        m = m & (k_pos[None, None, :] <= q_pos[:, :, None])
    if window > 0:
        m = m & (q_pos[:, :, None] - k_pos[None, None, :] < window)
    return m


def _flash_scan(q, k, v, q_pos, kv_len, causal: bool, window: int,
                chunk: int, also_lse: bool = False):
    """The chunked online softmax: o in q's dtype, and with `also_lse`
    (o, lse (B, KV, G, Sq) f32).  f32 inside; the last chunk is sliced
    short where the JAX scan pads it (its padded keys are masked, so they
    add exact zeros)."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    qg = (q.reshape(b, sq, kv, g, d) * (1.0 / math.sqrt(d))).float()
    acc = torch.zeros(b, kv, g, sq, d, dtype=torch.float32, device=q.device)
    m_run = torch.full((b, kv, g, sq), NEG_INF, dtype=torch.float32,
                       device=q.device)
    l_run = torch.zeros(b, kv, g, sq, dtype=torch.float32, device=q.device)
    for c0 in range(0, sk, chunk):
        k_ck = k[:, c0:c0 + chunk].float()
        v_ck = v[:, c0:c0 + chunk].float()
        k_pos = torch.arange(c0, c0 + k_ck.shape[1], device=q.device)
        s = torch.einsum("bqkgd,bckd->bkgqc", qg, k_ck)
        mask = _chunk_mask(q_pos, k_pos, kv_len, causal, window)
        s = torch.where(mask[:, None, None], s, NEG_INF)
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m_run - m_new)
        l_run = l_run * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgqc,bckd->bkgqd", p, v_ck)
        m_run = m_new
    l_safe = l_run.clamp_min(1e-30)
    o = acc / l_safe[..., None]
    o = o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)
    return (o, m_run + torch.log(l_safe)) if also_lse else o


class FlashScan(torch.autograd.Function):
    """The chunked scan's VJP (the reference's `_flash_fwd` / `_flash_bwd`,
    `models/layers.py:225-282`): the forward saves q, k, v, o and the
    log-sum-exp; the backward recomputes each chunk's probabilities from
    `lse` and accumulates dq, dk and dv in f32, so no chunk's scores
    outlive its step (autograd through the loop would keep every chunk's
    (B, KV, G, Sq, C) scores)."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_len, causal: bool, window: int,
                chunk: int):
        o, lse = _flash_scan(q, k, v, q_pos, kv_len, causal, window, chunk,
                             also_lse=True)
        ctx.save_for_backward(q, k, v, q_pos, kv_len, o, lse)
        ctx.spec = (causal, window, chunk)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, q_pos, kv_len, o, lse = ctx.saved_tensors
        causal, window, chunk = ctx.spec
        b, sq, h, d = q.shape
        sk, kv = k.shape[1], k.shape[2]
        g = h // kv
        scale = 1.0 / math.sqrt(d)
        qg = (q.reshape(b, sq, kv, g, d) * scale).float()
        heads = lambda t: t.reshape(b, sq, kv, g, d).permute(0, 2, 3, 1, 4)
        do_g = heads(do).float()
        delta = (do_g * heads(o).float()).sum(dim=-1)    # (B, KV, G, Sq)
        dq = torch.zeros(b, sq, kv, g, d, dtype=torch.float32,
                         device=q.device)
        dk = torch.empty(b, sk, kv, d, dtype=torch.float32, device=q.device)
        dv = torch.empty_like(dk)
        for c0 in range(0, sk, chunk):
            k_ck = k[:, c0:c0 + chunk].float()
            v_ck = v[:, c0:c0 + chunk].float()
            k_pos = torch.arange(c0, c0 + k_ck.shape[1], device=q.device)
            s = torch.einsum("bqkgd,bckd->bkgqc", qg, k_ck)
            mask = _chunk_mask(q_pos, k_pos, kv_len, causal, window)
            s = torch.where(mask[:, None, None], s, NEG_INF)
            p = torch.exp(s - lse[..., None])             # (B, KV, G, Sq, C)
            dv[:, c0:c0 + chunk] = torch.einsum("bkgqc,bkgqd->bckd", p, do_g)
            dp = torch.einsum("bkgqd,bckd->bkgqc", do_g, v_ck)
            ds = p * (dp - delta[..., None])
            dq += torch.einsum("bkgqc,bckd->bqkgd", ds, k_ck)
            dk[:, c0:c0 + chunk] = torch.einsum("bkgqc,bqkgd->bckd", ds, qg)
        dq = (dq * scale).reshape(b, sq, h, d).to(q.dtype)
        return (dq, dk.to(k.dtype), dv.to(v.dtype), None, None, None, None,
                None)


def flash_attention(q, k, v, q_pos, kv_len, causal: bool = True,
                    window: int = 0, chunk: int = 512) -> torch.Tensor:
    """Memory-efficient attention (the reference's `flash_attention`).

    q: (B, Sq, H, D); k, v: (B, Sk, KV, D) with H % KV == 0 (GQA).
    q_pos: (B, Sq) absolute query positions; kv_len: (B,) valid KV length.
    Through `FlashScan` where a gradient is wanted."""
    if wants_grad(q, k, v):
        return FlashScan.apply(q, k, v, q_pos, kv_len, causal, window, chunk)
    return _flash_scan(q, k, v, q_pos, kv_len, causal, window, chunk)


# --------------------------------------------------------------------------
# Exact sliding-window attention: O(S * window) via two-chunk slices
# --------------------------------------------------------------------------


def local_attention(q, k, v, window: int) -> torch.Tensor:
    """Causal sliding-window attention with chunk == window: each query
    chunk attends (previous chunk, own chunk) only.  q (B, S, H, D); k, v
    (B, S, KV, D).  Scores in f32, as the JAX function computes them; the
    score tensor is (B, S / window, KV, G, window, 2 x window).  A prompt
    no longer than the window is one chunk of S rows: the JAX function
    pads it to the window, and the padded keys are masked from every
    valid row, so the result is the same without the (window, 2 x window)
    scores (34 GB at mixtral-8x7b's window of 4096 over 4 x 512)."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    c = window if s > window else s
    nc = -(-s // c)
    pad = nc * c - s
    if pad:
        q, k, v = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (q, k, v))
    qc = q.reshape(b, nc, c, kv, g, d).float() / math.sqrt(d)
    kc = k.reshape(b, nc, c, kv, d)
    vc = v.reshape(b, nc, c, kv, d)
    # chunk n's previous chunk; chunk 0's is zeros (and masked)
    prev = lambda x: F.pad(x, (0, 0) * (x.dim() - 2) + (1, 0))[:, :-1]
    k2 = torch.cat([prev(kc), kc], dim=2).float()  # (B, nc, 2C, KV, D)
    v2 = torch.cat([prev(vc), vc], dim=2).float()
    srel = torch.einsum("bnqkgd,bnckd->bnkgqc", qc, k2)
    q_idx = torch.arange(c, device=q.device)[:, None] + c  # in [prev|own]
    k_idx = torch.arange(2 * c, device=q.device)[None, :]
    first = torch.arange(nc, device=q.device) == 0       # no prev chunk
    mask = (k_idx <= q_idx) & (q_idx - k_idx < window)
    mask = mask[None] & ~(first[:, None, None] & (k_idx < c))
    srel.masked_fill_(~mask[None, :, None, None], NEG_INF)
    p = torch.softmax(srel, dim=-1)
    del srel
    o = torch.einsum("bnkgqc,bnckd->bnqkgd", p, v2)
    return o.reshape(b, nc * c, h, d)[:, :s].to(q.dtype)


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------


def mlp_init(generator, d_model: int, d_ff: int, gated: bool, *, lead=(),
             device=None, dtype=torch.float32) -> dict:
    kw = {"lead": lead, "device": device, "dtype": dtype}
    p = {"wi": dense_init(generator, d_model, d_ff, **kw)}
    if gated:
        p["wg"] = dense_init(generator, d_model, d_ff, **kw)
    p["wo"] = dense_init(generator, d_ff, d_model, **kw)
    return p


def mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = dense(p["wi"], x)
    if "wg" in p:
        h = F.silu(dense(p["wg"], x)) * h
    else:
        h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    return dense(p["wo"], h)


# --------------------------------------------------------------------------
# GQA attention block
# --------------------------------------------------------------------------


def attn_init(generator, cfg, *, lead=(), device=None,
              dtype=torch.float32) -> dict:
    hd, nh, nkv = cfg.head_dim_, cfg.n_heads, cfg.n_kv
    kw = {"lead": lead, "device": device, "dtype": dtype}
    p = {
        "wq": dense_init(generator, cfg.d_model, nh * hd, bias=cfg.qkv_bias, **kw),
        "wk": dense_init(generator, cfg.d_model, nkv * hd, bias=cfg.qkv_bias, **kw),
        "wv": dense_init(generator, cfg.d_model, nkv * hd, bias=cfg.qkv_bias, **kw),
        "wo": dense_init(generator, nh * hd, cfg.d_model, **kw),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros(*lead, hd, device=device, dtype=dtype)
        p["k_norm"] = torch.zeros(*lead, hd, device=device, dtype=dtype)
    return p


def attn_qkv(p: dict, cfg, x: torch.Tensor, positions: torch.Tensor):
    """Project + (qk-norm) + rotary.  Returns q (B,S,H,D), k/v (B,S,KV,D)."""
    b, s, _ = x.shape
    hd = cfg.head_dim_
    q = dense(p["wq"], x).reshape(b, s, cfg.n_heads, hd)
    k = dense(p["wk"], x).reshape(b, s, cfg.n_kv, hd)
    v = dense(p["wv"], x).reshape(b, s, cfg.n_kv, hd)
    if cfg.qk_norm:
        q = rms_norm(p["q_norm"], q, cfg.norm_eps)
        k = rms_norm(p["k_norm"], k, cfg.norm_eps)
    return rotary(q, positions, cfg.rope_theta), rotary(k, positions, cfg.rope_theta), v


def attention_block(p: dict, cfg, x: torch.Tensor, positions: torch.Tensor, *,
                    window: int = 0) -> torch.Tensor:
    """Self-attention over the full sequence (forward path): the exact
    sliding window for a causal `window > 0`, the flash scan otherwise."""
    b, s, _ = x.shape
    q, k, v = attn_qkv(p, cfg, x, positions)
    o = full_attention(cfg, q, k, v, positions, window)
    return dense(p["wo"], o.reshape(b, s, cfg.n_heads * cfg.head_dim_))


def full_attention(cfg, q, k, v, positions, window: int, kv_len=None):
    """Prompt attention of a block, as the JAX `attention_block` and
    `_prefill_block` dispatch it: `local_attention` when the block has a
    causal window (it reads no lengths: a right-padded slot's valid rows
    see only earlier rows), else the flash scan over `kv_len` (B,)
    valid keys (all S by default)."""
    b, s = q.shape[0], q.shape[1]
    if window > 0 and cfg.is_causal:
        return local_attention(q, k, v, window)
    if kv_len is None:
        kv_len = torch.full((b,), s, dtype=torch.int32, device=q.device)
    return flash_attention(q, k, v, positions, kv_len, cfg.is_causal, window,
                           min(512, s))


def cached_attention(p: dict, cfg, q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, q_pos: torch.Tensor,
                     kv_len: torch.Tensor, *, k_scale=None,
                     v_scale=None, exclude=None) -> torch.Tensor:
    """Decode attention: q (B,Sq,H,D) over a cache (B,Smax,KV,D) whose rows
    at or past kv_len are masked; the caller has written the new rows
    first.  Returns the `wo` projection.

    `kv_len` is (B,), or (B, Sq): a valid length per query, which makes a
    W-wide pass over rows written all at once causal (the speculative
    verify, a chunk continuation).  `exclude` (B, Sq, Smax) bool masks
    further rows per query.

    An int8 cache passes its rows raw with their per-row scales
    `k_scale`/`v_scale` (B, Smax, KV): the scales are constant along the
    head dim, so the scores are scaled after the QK^T einsum and v_scale
    folds into the softmax weights; no dequantized copy of the cache is
    made."""
    b, sq = q.shape[0], q.shape[1]
    o = cached_heads(q, k_cache, v_cache, kv_len, k_scale=k_scale,
                     v_scale=v_scale, exclude=exclude)
    return dense(p["wo"], o.reshape(b, sq, cfg.n_heads * cfg.head_dim_))


def cached_heads(q, k_cache, v_cache, kv_len, *, k_scale=None, v_scale=None,
                 exclude=None) -> torch.Tensor:
    """`cached_attention` before the `wo` projection: o (B, Sq, H, D).  A
    caller that attends one query at a time (a ring's sequential scan)
    projects the stacked heads once."""
    b, sq, h, d = q.shape
    kv = k_cache.shape[2]
    g = h // kv
    row = lambda sc: sc.float().transpose(1, 2)[:, :, None, None, :]
    qg = (q.reshape(b, sq, kv, g, d) / math.sqrt(d)).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k_cache.float())
    if k_scale is not None:
        s = s * row(k_scale)
    srange = torch.arange(k_cache.shape[1], device=q.device)
    if kv_len.dim() == 1:
        valid = (srange[None, :] < kv_len[:, None])[:, None, :]  # (B, 1, S)
    else:  # a length per query (B, Sq)
        valid = srange[None, None, :] < kv_len[:, :, None]       # (B, Sq, S)
    if exclude is not None:
        valid = valid & ~exclude
    s = torch.where(valid[:, None, None], s, NEG_INF)
    p_attn = torch.softmax(s, dim=-1)
    if v_scale is not None:
        p_attn = p_attn * row(v_scale)
    o = torch.einsum("bkgqs,bskd->bqkgd", p_attn, v_cache.float())
    return o.reshape(b, sq, h, d).to(q.dtype)


def paged_cached_attention(p: dict, cfg, q: torch.Tensor, c: dict,
                           block_tables: torch.Tensor,
                           kv_len: torch.Tensor) -> torch.Tensor:
    """Decode attention over the paged pool: q (B, 1, H, D) against the
    cache dict's `k_pages`/`v_pages` pools through `block_tables`
    (B, n_bt); int8 pools ship their scale pools `k_scale_pages`/
    `v_scale_pages` through the same table.  Inside an engine whose
    backend registers the `paged_attention` op the planned kernel runs;
    otherwise the plain gather, which equals `cached_attention` on the
    same live rows.  Returns the `wo` projection.

    The W-wide speculative verify (Sq > 1, a per-query `kv_len` (B, W))
    always takes the plain gather, as in the JAX package: the kernel is
    Sq == 1 only, and the verify then plans no `paged_attention` key."""
    b, sq, h, d = q.shape
    k_scale, v_scale = c.get("k_scale_pages"), c.get("v_scale_pages")
    eng = active_engine()
    if (eng is not None and sq == 1
            and eng.registry.has(eng.backend, "paged_attention")):
        o = eng.paged_attention(q, c["k_pages"], c["v_pages"], block_tables,
                                kv_len, k_scale=k_scale, v_scale=v_scale)
    else:
        o = paged_attention_reference(q, c["k_pages"], c["v_pages"],
                                      block_tables, kv_len, k_scale, v_scale)
    return dense(p["wo"], o.reshape(b, sq, cfg.n_heads * cfg.head_dim_))

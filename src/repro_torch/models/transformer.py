"""Model assembly for the dense attention decoder (the port of
`repro/models/transformer.py`, block kind "attn").

Parameters keep the JAX pytree's layout: `stack["b{j}"]` leaves carry
the leading period axis, `tail` is a list of blocks past the last whole
period, `embed` is (vocab, d_model) and `lm_head` (d_model, vocab).  The
JAX `lax.scan` over periods is a Python loop over views of the stack.

  forward()       full-sequence logits
  prefill()       forward + KV cache construction (non-ragged)
  decode_step()   one token against the cache (vector clock `t`)

`prefill` and `decode_step` write the cache tensors in place and return
the cache dict with its new clock.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from . import layers
from .config import ArchConfig
from .layers import dense, mlp, rms_norm


def _check_kinds(cfg: ArchConfig) -> None:
    if (set(cfg.layer_pattern) != {"attn"} or cfg.moe is not None
            or cfg.embed_inputs or cfg.prefix_tokens):
        raise NotImplementedError(
            f"{cfg.name}: the port runs token-input decoders of dense 'attn' "
            f"blocks only so far")


def _period_split(cfg: ArchConfig) -> tuple[int, int]:
    period = len(cfg.layer_pattern)
    return cfg.n_layers // period, cfg.n_layers % period


# --------------------------------------------------------------------------
# Init
# --------------------------------------------------------------------------


def _block_init(generator, cfg: ArchConfig, lead, device, dtype) -> dict:
    kw = {"lead": lead, "device": device, "dtype": dtype}
    zeros = lambda: torch.zeros(*lead, cfg.d_model, device=device, dtype=dtype)
    return {"norm1": zeros(),
            "attn": layers.attn_init(generator, cfg, **kw),
            "norm2": zeros(),
            "mlp": layers.mlp_init(generator, cfg.d_model, cfg.d_ff,
                                   cfg.gated_mlp, **kw)}


def init_params(cfg: ArchConfig, *, generator: torch.Generator, device=None,
                dtype=torch.float32) -> dict:
    """Random parameters with the JAX `init_params` shapes and scales
    (N(0, 1/fan_in) matrices, N(0, 1/d_model) embeddings, zero biases and
    norm scales), drawn from `generator` in `dtype` — the values differ
    from JAX's."""
    _check_kinds(cfg)
    n_periods, n_tail = _period_split(cfg)
    inv = 1.0 / math.sqrt(cfg.d_model)
    normal = lambda *shape: torch.randn(*shape, generator=generator,
                                        device=device, dtype=dtype).mul_(inv)
    params = {"embed": normal(cfg.vocab, cfg.d_model)}
    params["stack"] = {
        f"b{j}": _block_init(generator, cfg, (max(n_periods, 1),), device, dtype)
        for j in range(len(cfg.layer_pattern))}
    params["tail"] = [_block_init(generator, cfg, (), device, dtype)
                      for _ in range(n_tail)]
    params["final_norm"] = torch.zeros(cfg.d_model, device=device, dtype=dtype)
    if not cfg.tie_embeddings:
        params["lm_head"] = normal(cfg.d_model, cfg.vocab)
    return params


def _index(tree, i: int):
    """The i-th period of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _periods(stack: dict, n_periods: int) -> list[dict]:
    return [_index(stack, i) for i in range(n_periods)]


# --------------------------------------------------------------------------
# Full-sequence path
# --------------------------------------------------------------------------


def _block_apply(p, cfg: ArchConfig, x, positions):
    norm = lambda scale, h: rms_norm(scale, h, cfg.norm_eps,
                                     cast_early=cfg.norm_cast_early)
    x = x + layers.attention_block(p["attn"], cfg, norm(p["norm1"], x),
                                   positions)
    return x + mlp(p["mlp"], norm(p["norm2"], x))


def _logits_out(params, cfg: ArchConfig, x):
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head.to(x.dtype)


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def forward(params, cfg: ArchConfig, tokens: torch.Tensor, *,
            compute_dtype=torch.bfloat16):
    """tokens (B, S) -> (logits (B, S, V), aux scalar).  The aux loss is
    the MoE balance term in the JAX package; a dense model returns 0."""
    _check_kinds(cfg)
    x = params["embed"].to(compute_dtype)[tokens.long()]
    b, s = tokens.shape
    positions = _positions(b, s, x.device)
    n_periods, _ = _period_split(cfg)
    for pp in _periods(params["stack"], n_periods):
        for j in range(len(cfg.layer_pattern)):
            x = _block_apply(pp[f"b{j}"], cfg, x, positions)
    for p_tail in params["tail"]:
        x = _block_apply(p_tail, cfg, x, positions)
    return _logits_out(params, cfg, x), torch.zeros((), device=x.device)


# --------------------------------------------------------------------------
# Cache + decode path
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CacheSpec:
    """Static description of the contiguous per-slot KV cache."""
    max_seq: int
    batch: int


def _slot_cache(cfg: ArchConfig, spec: CacheSpec, lead, dtype, device) -> dict:
    shape = (*lead, spec.batch, spec.max_seq, cfg.n_kv, cfg.head_dim_)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_cache(cfg: ArchConfig, spec: CacheSpec, dtype=torch.bfloat16,
               device=None) -> dict:
    """{"t": (B,) int32 per-slot clock, "slots": {"b{j}": {k, v}} with the
    leading period axis, "tail": [...]}; k/v are (B, max_seq, KV, hd)."""
    _check_kinds(cfg)
    if not dtype.is_floating_point:
        raise NotImplementedError(
            f"cache dtype {dtype}: the int8 KV codec is not ported yet")
    n_periods, n_tail = _period_split(cfg)
    return {"t": torch.zeros(spec.batch, dtype=torch.int32, device=device),
            "slots": {f"b{j}": _slot_cache(cfg, spec, (n_periods,), dtype,
                                           device)
                      for j in range(len(cfg.layer_pattern))},
            "tail": [_slot_cache(cfg, spec, (), dtype, device)
                     for _ in range(n_tail)]}


def _decode_block(p, cfg: ArchConfig, x, t, c: dict):
    """One-token step for one block: writes the new KV row of every slot
    at its own clock position, then attends its valid prefix."""
    pos = t[:, None]
    q, k_new, v_new = layers.attn_qkv(p["attn"], cfg,
                                      rms_norm(p["norm1"], x, cfg.norm_eps), pos)
    size = c["k"].shape[1]
    idx = t % size
    layers.slot_update(c["k"], idx, k_new[:, 0])
    layers.slot_update(c["v"], idx, v_new[:, 0])
    kv_len = torch.clamp(t + 1, max=size)
    x = x + layers.cached_attention(p["attn"], cfg, q, c["k"], c["v"], pos,
                                    kv_len)
    return x + mlp(p["mlp"], rms_norm(p["norm2"], x, cfg.norm_eps))


def decode_step(params, cfg: ArchConfig, cache: dict, token: torch.Tensor, *,
                compute_dtype=torch.bfloat16):
    """token (B, 1) -> (logits (B, 1, V), cache with clock t + 1)."""
    t = cache["t"]
    x = params["embed"].to(compute_dtype)[token.long()]
    n_periods, _ = _period_split(cfg)
    for i, pp in enumerate(_periods(params["stack"], n_periods)):
        cc = _index(cache["slots"], i)
        for j in range(len(cfg.layer_pattern)):
            x = _decode_block(pp[f"b{j}"], cfg, x, t, cc[f"b{j}"])
    for p_tail, c_tail in zip(params["tail"], cache["tail"], strict=True):
        x = _decode_block(p_tail, cfg, x, t, c_tail)
    return _logits_out(params, cfg, x), {**cache, "t": t + 1}


def _prefill_block(p, cfg: ArchConfig, x, positions, c: dict):
    b, s = x.shape[0], x.shape[1]
    xin = rms_norm(p["norm1"], x, cfg.norm_eps)
    q, k, v = layers.attn_qkv(p["attn"], cfg, xin, positions)
    size = c["k"].shape[1]
    for name, val in (("k", k), ("v", v)):
        if size >= s:  # full cache: rows [0, s)
            c[name][:, :s] = val.to(c[name].dtype)
        else:          # ring: the last `size` rows, rolled to pos % size
            c[name].copy_(torch.roll(val[:, -size:], s % size, dims=1))
    kv_len = torch.full((b,), s, dtype=torch.int32, device=x.device)
    o = layers.flash_attention(q, k, v, positions, kv_len, cfg.is_causal, 0,
                               min(512, s))
    x = x + dense(p["attn"]["wo"], o.reshape(b, s, cfg.n_heads * cfg.head_dim_))
    return x + mlp(p["mlp"], rms_norm(p["norm2"], x, cfg.norm_eps))


def prefill(params, cfg: ArchConfig, tokens: torch.Tensor, cache: dict, *,
            compute_dtype=torch.bfloat16):
    """Run the prompt (B, S), filling `cache`; returns (last-token logits
    (B, 1, V), cache with clock S)."""
    _check_kinds(cfg)
    x = params["embed"].to(compute_dtype)[tokens.long()]
    b, s = tokens.shape
    positions = _positions(b, s, x.device)
    n_periods, _ = _period_split(cfg)
    for i, pp in enumerate(_periods(params["stack"], n_periods)):
        cc = _index(cache["slots"], i)
        for j in range(len(cfg.layer_pattern)):
            x = _prefill_block(pp[f"b{j}"], cfg, x, positions, cc[f"b{j}"])
    for p_tail, c_tail in zip(params["tail"], cache["tail"], strict=True):
        x = _prefill_block(p_tail, cfg, x, positions, c_tail)
    logits = _logits_out(params, cfg, x[:, -1:])
    t = torch.full((b,), s, dtype=torch.int32, device=x.device)
    return logits, {**cache, "t": t}

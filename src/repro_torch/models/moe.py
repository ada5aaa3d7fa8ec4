"""Token-choice top-k Mixture-of-Experts (the port of
`repro/models/moe.py`; granite 32 experts top-8).

GShard-style capacity dispatch: every (token, choice) gets a position in
its expert's buffer in token-major order; positions at or past the
capacity C = `MoEConfig.capacity(S)` are dropped (their combine weight is
zero, the residual passes through).  Two dispatch implementations, picked
by `cfg.moe.impl` as in the JAX package:

  "einsum"  the one-hot dispatch/combine einsums; the expert matmuls are
            plain einsums too and never reach the engine.
  "sort"    a stable argsort of the selections by expert, a scatter of
            the tokens into (E, C) buffers and a gather back.  Inside an
            engine scope its three expert matmuls go through
            `Engine.grouped_matmul` (the grouped kernel on the `hopper`
            backend).

The JAX package's `constrain` calls place the buffers on a device mesh;
on one card they have no meaning and are left out.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..engine import active_engine
from .layers import dense_init


def moe_init(generator: torch.Generator, cfg, *, lead=(), device=None,
             dtype=torch.float32) -> dict:
    """Router (d_model, E) and stacked expert weights wi/wg (E, d_model,
    d_ff), wo (E, d_ff, d_model) with the JAX `moe_init` scales; `lead`
    prepends axes (the stacked period axis)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    normal = lambda *shape: torch.randn(*lead, *shape, generator=generator,
                                        device=device, dtype=dtype)
    return {
        "router": dense_init(generator, d, e, lead=lead, device=device,
                             dtype=dtype),
        "experts": {"wi": normal(e, d, f).div_(math.sqrt(d)),
                    "wg": normal(e, d, f).div_(math.sqrt(d)),
                    "wo": normal(e, f, d).div_(math.sqrt(f))},
    }


def capacity(cfg, seq: int) -> int:
    """Expert capacity C at sequence length `seq`; the formula lives on
    `MoEConfig.capacity`, and this mirrors the JAX package's `capacity`."""
    return cfg.moe.capacity(seq)


def moe_block(p, cfg, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y, aux_loss); dispatch impl per cfg.moe.impl."""
    if cfg.moe.impl == "sort":
        return moe_block_sorted(p, cfg, x)
    return moe_block_einsum(p, cfg, x)


def _route(p, cfg, x: torch.Tensor):
    """Shared router in f32: (gates (B,S,k), sel (B,S,k), aux scalar).
    The router product is a plain `@` in the JAX package too."""
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    logits = x.float() @ p["router"]["w"].float()
    gates, sel = torch.topk(logits, k, dim=-1)
    gates = torch.softmax(gates, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    one_hot_sel = F.one_hot(sel[..., 0], e).float()
    aux = e * torch.sum(one_hot_sel.mean(dim=(0, 1)) * probs.mean(dim=(0, 1)))
    return gates, sel, aux


def _expert_ffn(we, x_in: torch.Tensor) -> torch.Tensor:
    """x_in (E, ..., D) -> (E, ..., D) through per-expert SwiGLU.

    Inside a `use_engine` scope the three per-expert contractions go
    through the engine's `grouped_gemm` decision; otherwise plain
    einsums."""
    wi, wg, wo = (we[n].to(x_in.dtype) for n in ("wi", "wg", "wo"))
    eng = active_engine()
    if eng is not None:
        e, d = x_in.shape[0], x_in.shape[-1]
        xf = x_in.reshape(e, -1, d).contiguous()
        h = eng.grouped_matmul(xf, wi)
        g = eng.grouped_matmul(xf, wg)
        out = eng.grouped_matmul(F.silu(g) * h, wo)
        return out.reshape(x_in.shape)
    h = torch.einsum("e...d,edf->e...f", x_in, wi)
    g = torch.einsum("e...d,edf->e...f", x_in, wg)
    return torch.einsum("e...f,efd->e...d", F.silu(g) * h, wo)


def moe_block_sorted(p, cfg, x: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort-based dispatch: argsort selections by expert, scatter tokens
    into (E, C) buffers, gather back weighted.  The stable sort keeps
    token-major priority, so the same selections drop as on the einsum
    path.  The JAX package vmaps a per-example function; here the batch
    is a dimension of every op."""
    m = cfg.moe
    b, s, d = x.shape
    e, k = m.n_experts, m.top_k
    c = capacity(cfg, s)
    gates, sel, aux = _route(p, cfg, x)
    sk = s * k
    e_flat = sel.reshape(b, sk)                          # expert per selection
    order = torch.argsort(e_flat, dim=-1, stable=True)   # token-major priority
    sorted_e = e_flat.gather(1, order)
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos = torch.arange(sk, device=x.device) - first      # slot within expert
    keep = pos < c
    # dropped selections all go to the dump row E*C: its value is whichever
    # write lands last, and it is sliced off before anything reads it
    dst = torch.where(keep, sorted_e * c + pos, e * c)
    tok = order // k                                     # source token index
    buf = x.new_zeros((b, e * c + 1, d))
    buf.scatter_(1, dst[..., None].expand(b, sk, d),
                 x.gather(1, tok[..., None].expand(b, sk, d)))
    # inverse permutation: where did selection i land? (order is a
    # permutation, so every entry is written once)
    slot_of_sel = torch.empty_like(dst).scatter_(1, order, dst)
    xin = buf[:, :e * c].reshape(b, e, c, d).transpose(0, 1)   # (E,B,C,D)
    out = _expert_ffn(p["experts"], xin)                       # (E,B,C,D)
    out_b = out.transpose(0, 1).reshape(b, e * c, d)
    # a zero row at E*C, so dropped selections gather zeros
    out_b = torch.cat([out_b, out_b.new_zeros((b, 1, d))], dim=1)
    picked = out_b.gather(1, slot_of_sel[..., None].expand(b, sk, d))
    y = (picked.reshape(b, s, k, d)
         * gates.to(x.dtype)[..., None]).sum(dim=2)
    return y, aux


def moe_block_einsum(p, cfg, x: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """GShard one-hot dispatch, in plain tensor ops."""
    m = cfg.moe
    b, s, d = x.shape
    e, k = m.n_experts, m.top_k
    c = capacity(cfg, s)
    gates, sel, aux = _route(p, cfg, x)

    # Position of each (token, choice) in its expert's buffer: a causal
    # count over the flattened (S*k) selection stream, per example.
    flat = F.one_hot(sel.reshape(b, s * k), e)           # (B,Sk,E)
    pos = torch.cumsum(flat, dim=1) - flat               # selections before
    pos_sel = (pos * flat).sum(dim=-1)                   # (B, S*k)
    keep = (pos_sel < c).to(x.dtype)
    # one-hot over C; a position past C gives a zero row (dropped)
    oh_pos = (pos_sel[..., None]
              == torch.arange(c, device=x.device)).to(x.dtype)  # (B,Sk,C)
    sel_e = flat.to(x.dtype) * keep[..., None]                   # (B,Sk,E)
    w_flat = gates.reshape(b, s * k).to(x.dtype)

    # dispatch / combine (B,S,E,C): sum over the k choice slots
    disp = torch.einsum("bte,btc->btec", sel_e, oh_pos)
    disp = disp.reshape(b, s, k, e, c).sum(dim=2)
    comb = torch.einsum("bte,btc,bt->btec", sel_e, oh_pos, w_flat)
    comb = comb.reshape(b, s, k, e, c).sum(dim=2)

    xin = torch.einsum("bsec,bsd->ebcd", disp, x)        # (E,B,C,D)
    we = p["experts"]
    h = torch.einsum("ebcd,edf->ebcf", xin, we["wi"].to(x.dtype))
    g = torch.einsum("ebcd,edf->ebcf", xin, we["wg"].to(x.dtype))
    h = F.silu(g) * h
    out = torch.einsum("ebcf,efd->ebcd", h, we["wo"].to(x.dtype))
    y = torch.einsum("bsec,ebcd->bsd", comb, out)
    return y, aux

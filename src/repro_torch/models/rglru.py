"""RG-LRU recurrent block (RecurrentGemma / Griffin; the port of
`repro/models/rglru.py`).

The temporal-mixing branch: linear_x -> causal conv(4) -> RG-LRU gated
linear recurrence, multiplied by a GELU side branch, projected back.

    r_t = sigmoid(W_a u_t)            recurrence gate
    i_t = sigmoid(W_x u_t)            input gate
    a_t = exp(-c * softplus(Lambda) * r_t),  c = 8
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

The recurrence h_t = a_t h_{t-1} + b_t is associative in its (a, b)
pairs, so prefill scans it in log2(S) doubling steps (Hillis-Steele)
instead of S sequential ones.  Decode is the O(1) per-token update.
Every projection goes through `layers.dense` (the engine's GEMM).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import dense, dense_init
from .ssm import _causal_conv, _ragged_conv_state

_C = 8.0


def rglru_init(generator: torch.Generator, cfg, *, lead=(), device=None,
               dtype=torch.float32) -> dict:
    """The JAX `rglru_init` tree: N(0, 1/fan_in) projections, N(0, 1/4)
    conv taps, zero conv bias, and Lambda such that a^(1/c) spans
    [0.9, 0.999].  Drawn in f32 and cast to `dtype`."""
    w = cfg.rglru_width or cfg.d_model
    d = cfg.d_model
    kw = {"lead": lead, "device": device, "dtype": dtype}
    f32 = {"device": device, "dtype": torch.float32}
    lam = torch.log(torch.expm1(-torch.log(torch.linspace(0.9, 0.999, w,
                                                          **f32))))
    return {
        "lin_x": dense_init(generator, d, w, **kw),
        "lin_y": dense_init(generator, d, w, **kw),
        "conv_w": (torch.randn(*lead, 4, w, generator=generator, **f32)
                   / 2.0).to(dtype),
        "conv_b": torch.zeros(*lead, w, device=device, dtype=dtype),
        "w_a": dense_init(generator, w, w, **kw),
        "w_x": dense_init(generator, w, w, **kw),
        "lam": lam.expand(*lead, w).to(dtype).clone(),
        "lin_out": dense_init(generator, w, d, **kw),
    }


def _gates(p, u):
    """(a, b) of the recurrence in f32 for u (B, S, W)."""
    r = torch.sigmoid(dense(p["w_a"], u).float())
    i = torch.sigmoid(dense(p["w_x"], u).float())
    log_a = -_C * F.softplus(p["lam"]) * r  # in lam's dtype, as the JAX code
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * u.float())
    return a, b


def _scan(a, b):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t along dim 1 (h_{-1} = 0):
    log2(S) doubling steps, each combining every position with the one
    `off` before it, (a1, b1) then (a2, b2) -> (a1 a2, a2 b1 + b2)."""
    s = a.shape[1]
    off = 1
    while off < s:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]], 1)
        if 2 * off < s:  # the last step's products are not read
            a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], 1)
        off *= 2
    return b


def rglru_scan(p, u, h0=None, valid=None):
    """u (B, S, W) -> (h (B, S, W) in u's dtype, h_last (B, W) f32).

    `valid` (B, S) bool marks real rows in a ragged (right-padded)
    batch: pad rows become the identity element (a = 1, b = 0), so h is
    frozen past each slot's length and `h_last` is the state at that
    slot's final valid token.  `h0` (B, W) seeds the scan through
    b[:, 0]."""
    a, b = _gates(p, u)
    if valid is not None:
        a = torch.where(valid[..., None], a, 1.0)
        b = torch.where(valid[..., None], b, 0.0)
    if h0 is not None:
        b = b.clone()
        b[:, 0] += a[:, 0] * h0.float()
    h = _scan(a, b)
    return h.to(u.dtype), h[:, -1]


def rglru_prefill(p, cfg, x, lengths=None, state=None):
    """Full-sequence temporal-mixing block (forward / prefill) that also
    returns the decode state: (out, conv state (B, 3, W), h at each
    slot's last valid token (B, W) f32).  Ragged (`lengths` (B,)): pad
    rows are the scan's identity and the conv state is re-gathered at
    per-slot offsets.  `state` {"conv", "h"} continues a chunked prefill
    from the stored conv window and h (`ssm.ssm_prefill`'s rule for the
    conv state)."""
    y = F.gelu(dense(p["lin_y"], x), approximate="tanh")
    u_in = dense(p["lin_x"], x)
    conv_in = None if state is None else state["conv"]
    u, conv_state = _causal_conv(p["conv_w"], p["conv_b"], u_in, conv_in,
                                 act=False)
    valid = None
    if lengths is not None:
        valid = (torch.arange(x.shape[1], device=x.device)[None, :]
                 < lengths[:, None])
        conv_state = _ragged_conv_state(u_in, lengths, p["conv_w"].shape[0],
                                        conv_in)
    h, h_last = rglru_scan(p, u, h0=None if state is None else state["h"],
                           valid=valid)
    return dense(p["lin_out"], h * y), conv_state, h_last


def rglru_block(p, cfg, x):
    """Full-sequence temporal-mixing block (forward)."""
    return rglru_prefill(p, cfg, x)[0]


def rglru_decode_step(p, cfg, x, conv_state, h):
    """x (B, 1, D); conv_state (B, 3, W); h (B, W) -> (out, conv_state,
    h in x's dtype) for every slot: the caller keeps the states of the
    slots that do not step."""
    y = F.gelu(dense(p["lin_y"], x), approximate="tanh")
    u, conv_state = _causal_conv(p["conv_w"], p["conv_b"],
                                 dense(p["lin_x"], x), conv_state, act=False)
    a, b = _gates(p, u)
    h_new = a[:, 0] * h.float() + b[:, 0]
    out = dense(p["lin_out"], h_new[:, None].to(x.dtype) * y)
    return out, conv_state, h_new.to(x.dtype)

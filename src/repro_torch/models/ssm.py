"""Mamba-2 SSD (state-space duality) blocks — mamba2-780m (the port of
`repro/models/ssm.py`).

Chunked SSD form (Dao & Gu 2024): within a chunk the recurrence is the
masked matrix product (C B^T ⊙ L) x̄; across chunks a loop over the
chunks carries the (H, N, P) state.  Decode is the O(1) recurrent update
on the same state.

Layer i/o follows Mamba-2: in_proj -> (z, x, B, C, dt), causal depthwise
conv over (x, B, C), SSD, gated RMSNorm, out_proj.  The projections are
plain matmuls (`x @ w`), as in the JAX package: no engine kernel runs in
this block.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import dense_init, rms_norm


def _dims(cfg):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    heads = d_in // s.head_dim
    conv_ch = d_in + 2 * s.n_groups * s.d_state
    return s, d_in, heads, conv_ch


def ssm_init(generator: torch.Generator, cfg, *, lead=(), device=None,
             dtype=torch.float32) -> dict:
    """The JAX `ssm_init` tree: N(0, 1/fan_in) projections, N(0, 1/W) conv
    taps, zero conv bias and norm, A_log = log(linspace(1, 16, H)), D = 1,
    and dt_bias the softplus inverse of dt ~ logU[1e-3, 1e-1].  Drawn in
    f32 and cast to `dtype`, as the JAX launcher casts its tree."""
    s, d_in, heads, conv_ch = _dims(cfg)
    d_proj = 2 * d_in + 2 * s.n_groups * s.d_state + heads
    kw = {"lead": lead, "device": device, "dtype": dtype}
    f32 = {"device": device, "dtype": torch.float32}
    tile = lambda t: t.expand(*lead, *t.shape).to(dtype).clone()
    dt = torch.empty(*lead, heads, **f32).uniform_(
        math.log(1e-3), math.log(1e-1), generator=generator)
    return {
        "in_proj": dense_init(generator, cfg.d_model, d_proj, **kw),
        "conv_w": (torch.randn(*lead, s.conv_width, conv_ch, generator=generator,
                               **f32) / math.sqrt(s.conv_width)).to(dtype),
        "conv_b": torch.zeros(*lead, conv_ch, device=device, dtype=dtype),
        "A_log": tile(torch.log(torch.linspace(1.0, 16.0, heads, **f32))),
        "D": torch.ones(*lead, heads, device=device, dtype=dtype),
        "dt_bias": torch.log(torch.expm1(torch.exp(dt))).to(dtype),
        "norm": torch.zeros(*lead, d_in, device=device, dtype=dtype),
        "out_proj": dense_init(generator, d_in, cfg.d_model, **kw),
    }


def _causal_conv(w, b, x, state=None, act: bool = True):
    """Depthwise causal conv, width W.  x (B, L, C); state (B, W-1, C) for
    decode.  Returns (y, new_state): the taps summed in the JAX order."""
    width = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, width - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i].to(x.dtype) for i in range(width))
    y = y + b.to(x.dtype)
    new_state = xp[:, -(width - 1):]
    return (F.silu(y) if act else y), new_state


def ragged_conv_state(x, lengths, width: int):
    """Per-slot decode state of `_causal_conv` after a ragged prefill.

    x (B, S, C) is the raw conv input (pre-activation); lengths (B,) the
    per-slot valid prefix.  Returns (B, width-1, C): the last width-1
    valid rows of each slot, zero-padded on the left for slots shorter
    than the conv window — the `new_state` a length-L unpadded
    `_causal_conv` call would have produced."""
    s = x.shape[1]
    w1 = width - 1
    idx = (lengths[:, None].long() - w1
           + torch.arange(w1, device=x.device)[None, :])
    st = torch.gather(x, 1, idx.clamp(0, s - 1)[:, :, None].expand(
        -1, -1, x.shape[2]))
    return torch.where((idx >= 0)[:, :, None], st, 0).to(x.dtype)


def _ragged_conv_state(x, lengths, width: int, conv_in=None):
    """`ragged_conv_state` of a prefill, or of a chunk continuation from
    the stored window `conv_in` (B, W-1, C): gathered over [conv_in ‖ x]
    with each slot's valid prefix shifted by the W-1 stored rows."""
    if conv_in is None:
        return ragged_conv_state(x, lengths, width)
    return ragged_conv_state(torch.cat([conv_in.to(x.dtype), x], dim=1),
                             lengths + (width - 1), width)


def _split(p, cfg, u):
    """u (..., d_proj) -> z (d_in), xbc (d_in + 2 G N), dt (H): the JAX
    `jnp.split` at indices [d_in, 2 d_in + 2 G N], as sizes."""
    s, d_in, heads, _ = _dims(cfg)
    gn = s.n_groups * s.d_state
    z, xbc, dt = torch.split(u, [d_in, d_in + 2 * gn, heads], dim=-1)
    return z, xbc, dt, (s, d_in, heads, gn)


def _split_xbc(xbc, d_in: int, gn: int):
    """The conv output -> x (d_in), B (G N), C (G N): `jnp.split` at
    [d_in, d_in + gn]."""
    return torch.split(xbc, [d_in, gn, gn], dim=-1)


def _expand_groups(t, h: int):
    """(nc, B, C, G, N) -> (nc, B, C, H, N) by repeating groups."""
    g = t.shape[3]
    if g == h:
        return t
    return t.repeat_interleave(h // g, dim=3)


def ssd_chunked(x, dt, a_log, b_mat, c_mat, d_skip, chunk: int, h0=None):
    """x (B, L, H, P); dt (B, L, H) (post-softplus); b_mat, c_mat
    (B, L, G, N).  Returns (y (B, L, H, P) f32, final_state (B, H, N, P)).

    The JAX three-operand einsums are taken as an elementwise product
    and one batched contraction each, so no (nc, B, C, C, H, P) operand
    is formed; `lax.scan` over chunks is a loop."""
    bsz, slen, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    nc = -(-slen // chunk)
    pad = nc * chunk - slen
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, 0, 0, pad))
    a = -torch.exp(a_log.float())                              # (H,)
    da = dt.float() * a                                        # (B, L, H)
    xbar = x.float() * dt.float()[..., None]

    def reshape_c(t):  # (B, L, ...) -> (nc, B, chunk, ...)
        return t.reshape(bsz, nc, chunk, *t.shape[2:]).transpose(0, 1)

    da_c = reshape_c(da)                                       # (nc,B,C,H)
    x_c = reshape_c(xbar)                                      # (nc,B,C,H,P)
    b_c = reshape_c(b_mat.float())                             # (nc,B,C,G,N)
    c_c = reshape_c(c_mat.float())

    cs = torch.cumsum(da_c, dim=2)                             # (nc,B,C,H)
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]          # t, s
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                device=x.device))
    # exp(seg) above the diagonal may be inf: the mask drops it
    l_mat = torch.where(tri[None, None, :, :, None], torch.exp(seg), 0.0)
    del seg

    # intra-chunk: (C B^T ⊙ L) x̄, heads grouped over G
    cb = torch.einsum("ubtgn,ubsgn->ubtsg", c_c, b_c)
    hpg = h // g
    w = (cb[..., None] * l_mat.reshape(*l_mat.shape[:4], g, hpg)).reshape(
        l_mat.shape)                                           # (nc,B,C,C,H)
    del l_mat, cb
    y_intra = torch.einsum("ubtsh,ubshp->ubthp", w, x_c)
    del w

    # per-chunk terminal state and decay-to-end
    decay_end = torch.exp(cs[:, :, -1:, :] - cs)               # (nc,B,C,H)
    s_chunk = torch.einsum("ubshn,ubshp->ubhnp", _expand_groups(b_c, h),
                           decay_end[..., None] * x_c)
    chunk_decay = torch.exp(torch.sum(da_c, dim=2))            # (nc,B,H)

    state = (torch.zeros(bsz, h, n, p, dtype=torch.float32, device=x.device)
             if h0 is None else h0.float())
    starts = []
    for i in range(nc):
        starts.append(state)
        state = state * chunk_decay[i][..., None, None] + s_chunk[i]
    s_starts = torch.stack(starts)                             # (nc,B,H,N,P)

    # inter-chunk: C_t · exp(cs_t) S_start
    y_inter = torch.einsum("ubthn,ubhnp->ubthp",
                           torch.exp(cs)[..., None] * _expand_groups(c_c, h),
                           s_starts)
    y = (y_intra + y_inter).transpose(0, 1).reshape(bsz, nc * chunk, h, p)
    y = y + d_skip.float()[None, None, :, None] * x.float()
    return y[:, :slen].float(), state


def ssm_prefill(p, cfg, x, lengths=None, state=None):
    """Full-sequence SSD block (forward / prefill) that also returns the
    decode state: (out (B, S, D), conv state (B, W-1, conv_ch), SSD state
    (B, H, N, P) f32).  Ragged (`lengths` (B,)): dt = 0 past a slot's
    length makes each pad step the identity on the SSD state (decay
    exp(0) = 1, input x dt = 0), so the final state is the state at the
    slot's last valid token; the conv state is re-gathered at per-slot
    offsets.  `state` {"conv", "state"} continues a chunked prefill from
    the stored conv window and SSD state; the conv state after the chunk
    is then gathered over [stored window ‖ chunk], as a chunk may be
    shorter than the conv window."""
    u = x @ p["in_proj"]["w"].to(x.dtype)
    z, xbc, dt, (s, d_in, heads, gn) = _split(p, cfg, u)
    conv_in = None if state is None else state["conv"]
    xbc_c, conv_state = _causal_conv(p["conv_w"], p["conv_b"], xbc, conv_in)
    xs, b_mat, c_mat = _split_xbc(xbc_c, d_in, gn)
    bsz, length = x.shape[0], x.shape[1]
    xs = xs.reshape(bsz, length, heads, s.head_dim)
    b_mat = b_mat.reshape(bsz, length, s.n_groups, s.d_state)
    c_mat = c_mat.reshape(bsz, length, s.n_groups, s.d_state)
    dt_full = F.softplus(dt.float() + p["dt_bias"])
    if lengths is not None:
        valid = (torch.arange(length, device=x.device)[None, :, None]
                 < lengths[:, None, None])
        dt_full = torch.where(valid, dt_full, 0.0)
        conv_state = _ragged_conv_state(xbc, lengths, s.conv_width, conv_in)
    y, state_out = ssd_chunked(xs, dt_full, p["A_log"], b_mat, c_mat, p["D"],
                               s.chunk,
                               h0=None if state is None else state["state"])
    y = y.reshape(bsz, length, d_in).to(x.dtype)
    y = rms_norm(p["norm"], y * F.silu(z), cfg.norm_eps)
    return y @ p["out_proj"]["w"].to(x.dtype), conv_state, state_out


def ssm_block(p, cfg, x):
    """Full-sequence SSD block (forward). x (B, S, D)."""
    return ssm_prefill(p, cfg, x)[0]


def ssm_decode_step(p, cfg, x, conv_state, ssd_state):
    """Single-token recurrent update.  x (B, 1, D); conv_state
    (B, W-1, conv_ch); ssd_state (B, H, N, P) f32.  Returns (out,
    conv_state, ssd_state) for every slot: the caller keeps the states
    of the slots that do not step."""
    u = x @ p["in_proj"]["w"].to(x.dtype)
    z, xbc, dt, (s, d_in, heads, gn) = _split(p, cfg, u)
    xbc, conv_state = _causal_conv(p["conv_w"], p["conv_b"], xbc, conv_state)
    xs, b_mat, c_mat = _split_xbc(xbc, d_in, gn)
    bsz = x.shape[0]
    xs = xs.reshape(bsz, heads, s.head_dim).float()
    b_mat = _expand_groups(
        b_mat.reshape(1, bsz, 1, s.n_groups, s.d_state), heads)[0, :, 0]
    c_mat = _expand_groups(
        c_mat.reshape(1, bsz, 1, s.n_groups, s.d_state), heads)[0, :, 0]
    dt_f = F.softplus(dt.float()[:, 0] + p["dt_bias"])        # (B, H)
    a = -torch.exp(p["A_log"].float())
    decay = torch.exp(dt_f * a)                                # (B, H)
    xbar = xs * dt_f[..., None]
    ssd_state = (ssd_state * decay[..., None, None]
                 + torch.einsum("bhn,bhp->bhnp", b_mat.float(), xbar))
    y = torch.einsum("bhn,bhnp->bhp", c_mat.float(), ssd_state)
    y = y + p["D"].float()[None, :, None] * xs
    y = y.reshape(bsz, 1, d_in).to(x.dtype)
    y = rms_norm(p["norm"], y * F.silu(z), cfg.norm_eps)
    return y @ p["out_proj"]["w"].to(x.dtype), conv_state, ssd_state

"""Functional cycle-level systolic-array simulator + roundabout geometry.

The port of `repro/core/simulator.py`, the accelerator plane's one JAX
module.  Two purposes (DESIGN.md Sec. 2):

1.  `simulate_gemm(a, b, dataflow, shape)` executes a logical R x C array
    cycle by cycle (a Python loop over cycles on explicit per-PE register
    tensors, where the reference runs `jax.lax.scan`) for all three
    dataflows and returns (output, cycles).  The output must equal a @ b
    and the cycle count must match the streaming term of Eq. 4 — the
    correctness oracle for the paper's claim that reshaped /
    multi-dataflow execution is functionally a GEMM.  Every cycle is a
    few tensor ops (register shifts, one fused multiply-add, and for WS
    the bottom edge's scatter-add), each in f32 as the reference's: the
    multiply-add is `addcmul`, one rounding per cycle on the card and on
    the CPU alike, as XLA fuses the reference's product and sum.
    `simulate_gemm_batch` carries a leading batch dimension through the
    same loop where the reference `vmap`s.

2.  `pinwheel_decomposition(r_l, r_p)` produces the physical placement of
    a reshaped logical array: the four chained sub-arrays of Sec. 3.2
    occupy a pinwheel around the physical square, so every inter-PE hop
    on the roundabout path is between adjacent PEs (Fig. 7b), with only
    the center (R_p - 2*R_l)^2 PEs idle.  `roundabout_ring` emits the
    per-hop route and `validate_roundabout` checks every hop is
    Manhattan-distance-1.  This half is numpy, copied from the reference.

Tensors stay on their own device.  Anything else (numpy arrays, lists)
becomes an f32 tensor on `device=`, whose default is "cuda": with no
card that raises instead of falling back to the CPU.

Cycle-count conventions: the simulator counts cycles in which at least
one PE consumes streaming data; Eq. 4's streaming term (R + C + S - 1)
additionally counts the final writeback cycle, so
`cycles_sim == eq4_stream_term(dataflow, shape, tile) - 1`.
"""

from __future__ import annotations

import numpy as np
import torch

from .dataflow import Dataflow, LogicalShape


# ---------------------------------------------------------------------------
# Cycle-level dataflow simulation
# ---------------------------------------------------------------------------


def eq4_stream_term(dataflow: Dataflow, shape: LogicalShape, m: int, k: int, n: int) -> int:
    """The (R + C + streaming_dim - 1) pipeline term of Eq. 4."""
    r, c = shape.rows, shape.cols
    stream = {Dataflow.WS: m, Dataflow.OS: k, Dataflow.IS: n}[dataflow]
    return r + c + stream - 1


def _f32(x, device) -> torch.Tensor:
    """A tensor as f32 on its own device; anything else on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"simulator device={device!r} but no CUDA device is available; "
            f"pass device='cpu' to simulate on the CPU")
    return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)


def _edge_stream(src: torch.Tensor, n_cycles: int, depth: int,
                 along_rows: bool) -> torch.Tensor:
    """The skewed edge inputs of every cycle, [..., n_cycles, lanes]:
    lane i at cycle t reads element (t - i) of its line of `src` (a row
    of src when `along_rows`, else a column), zero outside [0, depth) —
    the reference's per-cycle `where(valid, src[clip(...)], 0)`."""
    lanes = src.shape[-2] if along_rows else src.shape[-1]
    dev = src.device
    t = torch.arange(n_cycles, device=dev)[:, None]
    lane = torch.arange(lanes, device=dev)[None, :]
    pos = t - lane                                   # [n_cycles, lanes]
    valid = (pos >= 0) & (pos < depth)
    pos = pos.clamp(0, depth - 1)
    if along_rows:   # src [..., lanes, depth]: src[..., i, pos[t, i]]
        got = src[..., lane.expand_as(pos), pos]
    else:            # src [..., depth, lanes]: src[..., pos[t, j], j]
        got = src[..., pos, lane.expand_as(pos)]
    return torch.where(valid, got, torch.zeros((), device=dev))


def _simulate_os(a: torch.Tensor, b: torch.Tensor, r: int, c: int, k: int):
    """Output-stationary: C[i,j] accumulates in PE(i,j); A streams east
    from the west edge (row-skewed), B streams south from the north edge
    (column-skewed).  a [..., r, k], b [..., k, c]."""
    n_cycles = r + c + k - 2
    a_in = _edge_stream(a, n_cycles, k, along_rows=True)    # [..., T, r]
    b_in = _edge_stream(b, n_cycles, k, along_rows=False)   # [..., T, c]
    batch = a.shape[:-2]
    a_reg = a.new_zeros(*batch, r, c)
    b_reg = a.new_zeros(*batch, r, c)
    acc = a.new_zeros(*batch, r, c)
    for t in range(n_cycles):
        a_reg = torch.cat([a_in[..., t, :, None], a_reg[..., :, :-1]], dim=-1)
        b_reg = torch.cat([b_in[..., t, None, :], b_reg[..., :-1, :]], dim=-2)
        acc.addcmul_(a_reg, b_reg)
    return acc, n_cycles


def _simulate_ws(a: torch.Tensor, b: torch.Tensor, m: int, k: int, n: int):
    """Weight-stationary: B[k,n] preloaded at PE(k,n) (array is K x N);
    A streams east (element A[t - kk, kk] enters row kk), partial sums
    flow south and exit the bottom edge skewed by column, where each
    output element receives its one partial sum by a scatter-add.
    a [..., m, k], b [..., k, n]."""
    n_cycles = m + k + n - 2
    dev = a.device
    a_in = _edge_stream(a, n_cycles, m, along_rows=False)   # [..., T, k]
    batch = a.shape[:-2]
    # bottom edge: psum[k-1, j] is output row (t - (k-1) - j), column j
    col = torch.arange(n, device=dev)
    mo = torch.arange(n_cycles, device=dev)[:, None] - (k - 1) - col[None]
    out_valid = (mo >= 0) & (mo < m)                        # [T, n]
    out_idx = mo.clamp(0, m - 1) * n + col[None]            # flat [T, n]
    zero = torch.zeros((), device=dev)
    a_reg = a.new_zeros(*batch, k, n)
    psum = a.new_zeros(*batch, k, n)
    top = a.new_zeros(*batch, 1, n)
    out = a.new_zeros(*batch, m * n)
    for t in range(n_cycles):
        a_reg = torch.cat([a_in[..., t, :, None], a_reg[..., :, :-1]], dim=-1)
        psum = torch.cat([top, psum[..., :-1, :]], dim=-2).addcmul_(a_reg, b)
        edge = torch.where(out_valid[t], psum[..., k - 1, :], zero)
        out.scatter_add_(-1, out_idx[t].expand_as(edge), edge)
    return out.reshape(*batch, m, n), n_cycles


def _check_dims(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.shape[-1] != b.shape[-2]:
        raise ValueError(f"GEMM dim mismatch: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")


def _pad(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """x [..., r, c] zero-padded at the end to [..., rows, cols]."""
    out = x.new_zeros(*x.shape[:-2], rows, cols)
    out[..., :x.shape[-2], :x.shape[-1]] = x
    return out


def _simulate(a: torch.Tensor, b: torch.Tensor, dataflow: Dataflow,
              shape: LogicalShape | None):
    """The single-pass simulation on [..., M, K] @ [..., K, N] operands."""
    m, k = a.shape[-2:]
    n = b.shape[-1]
    if dataflow == Dataflow.OS:
        shape = shape or LogicalShape(m, n)
        if m > shape.rows or n > shape.cols:
            raise ValueError(f"OS tile {m}x{n} exceeds array {shape}")
        out, cycles = _simulate_os(_pad(a, shape.rows, k),
                                   _pad(b, k, shape.cols),
                                   shape.rows, shape.cols, k)
        return out[..., :m, :n], cycles
    if dataflow == Dataflow.WS:
        shape = shape or LogicalShape(k, n)
        if k > shape.rows or n > shape.cols:
            raise ValueError(f"WS tile K x N = {k}x{n} exceeds array {shape}")
        out, cycles = _simulate_ws(_pad(a, m, shape.rows),
                                   _pad(b, shape.rows, shape.cols),
                                   m, shape.rows, shape.cols)
        return out[..., :, :n], cycles
    if dataflow == Dataflow.IS:
        # IS is WS on the transposed problem: O^T = B^T @ A^T with the
        # input matrix stationary (logical shape rows=M, cols=K holds A;
        # the streaming dim is N).
        shape = shape or LogicalShape(m, k)
        if m > shape.rows or k > shape.cols:
            raise ValueError(f"IS tile M x K = {m}x{k} exceeds array {shape}")
        out_t, cycles = _simulate(b.transpose(-1, -2), a.transpose(-1, -2),
                                  Dataflow.WS,
                                  LogicalShape(shape.cols, shape.rows))
        return out_t.transpose(-1, -2), cycles
    raise ValueError(dataflow)


def simulate_gemm(a, b, dataflow: Dataflow, shape: LogicalShape | None = None,
                  *, device="cuda"):
    """Run one (M x K) @ (K x N) tile through the logical array.

    `shape` defaults to the exact array the tile needs (the caller tiles
    larger GEMMs; this simulates a single array pass, the unit of Eq. 4).
    Returns (output [M, N] f32 on the operands' device, cycles). Raises if
    the tile exceeds the array.
    """
    a, b = _f32(a, device), _f32(b, device)
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"need [M,K] x [K,N], got {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    _check_dims(a, b)
    return _simulate(a, b, dataflow, shape)


def simulate_gemm_batch(a, b, dataflow: Dataflow,
                        shape: LogicalShape | None = None, *, device="cuda"):
    """Batched `simulate_gemm`: run B same-shaped tiles through one
    cycle-level pass, the batch a leading dimension of every register.

    `a` is [B, M, K], `b` is [B, K, N]; returns ([B, M, N], cycles).  The
    per-tile cycle count is identical across the batch (it depends only
    on the tile dims), matching Eq. 4's single-tile T_exe — this is the
    execution backend `simulate_mapping` uses to validate a whole mapper
    decision in one pass instead of a Python loop over tiles.
    """
    a, b = _f32(a, device), _f32(b, device)
    if a.ndim != 3 or b.ndim != 3 or a.shape[0] != b.shape[0]:
        raise ValueError(f"need [B,M,K] x [B,K,N], got {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    _check_dims(a, b)
    return _simulate(a, b, dataflow, shape)


def simulate_mapping(a, b, cfg, *, device="cuda"):
    """Functionally execute a mapper-chosen `MappingConfig` end to end.

    Pads (M, K, N) up to tile multiples, carves A and B into the
    (m_t x k_t) / (k_t x n_t) tile grids, streams every (mi, ni, ki)
    tile triple through `simulate_gemm_batch` on the configured logical
    shape + dataflow, and reduces partials over the k grid — the
    functional counterpart of the analytical model's NUM_t tile loop.
    Returns (output [M, N], per_tile_cycles); output must equal a @ b.
    """
    a, b = _f32(a, device), _f32(b, device)
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"need [M,K] x [K,N], got {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    _check_dims(a, b)
    m, k = a.shape
    n = b.shape[1]
    m_t, k_t, n_t = min(cfg.tile_m, m), min(cfg.tile_k, k), min(cfg.tile_n, n)
    gm, gk, gn = -(-m // m_t), -(-k // k_t), -(-n // n_t)
    a_p = _pad(a, gm * m_t, gk * k_t)
    b_p = _pad(b, gk * k_t, gn * n_t)
    # [gm, gk, m_t, k_t] / [gk, gn, k_t, n_t] tile grids
    a_tiles = a_p.reshape(gm, m_t, gk, k_t).permute(0, 2, 1, 3)
    b_tiles = b_p.reshape(gk, k_t, gn, n_t).permute(0, 2, 1, 3)
    a_all = a_tiles[:, None].expand(gm, gn, gk, m_t, k_t)
    b_all = b_tiles.permute(1, 0, 2, 3)[None].expand(gm, gn, gk, k_t, n_t)
    out_tiles, cycles = simulate_gemm_batch(
        a_all.reshape(-1, m_t, k_t), b_all.reshape(-1, k_t, n_t),
        cfg.dataflow, cfg.shape)
    out_grid = out_tiles.reshape(gm, gn, gk, m_t, n_t).sum(dim=2)
    out = out_grid.permute(0, 2, 1, 3).reshape(gm * m_t, gn * n_t)
    return out[:m, :n], cycles


# ---------------------------------------------------------------------------
# Roundabout geometry (pinwheel placement)
# ---------------------------------------------------------------------------


def pinwheel_decomposition(r_l: int, r_p: int) -> list[dict]:
    """Physical placement of the 4 chained sub-arrays for a wide logical
    shape R_l x 4*(R_p - R_l) on an R_p x R_p array (Sec. 3.2, Fig. 6).

    Returns 4 strips in chain order; each strip dict has:
      'coords': np.ndarray [R_l, C_s, 2] physical (row, col) per logical
                (local_row, local_col) position,
      'orientation': degrees the strip's streaming direction is rotated.
    """
    if not (0 < r_l <= r_p // 2):
        raise ValueError(f"need 0 < R_l <= R_p/2, got R_l={r_l}, R_p={r_p}")
    c_s = r_p - r_l
    rows, cols = np.meshgrid(np.arange(r_l), np.arange(c_s), indexing="ij")

    def strip(pr, pc, orientation):
        return {"coords": np.stack([pr, pc], axis=-1), "orientation": orientation}

    # chain order A (top, ->E), B (right, ->S), C (bottom, ->W), D (left, ->N)
    return [
        strip(rows, cols, 0),                                  # top strip
        strip(cols, r_p - 1 - rows, 90),                       # right strip
        strip(r_p - 1 - rows, r_p - 1 - cols, 180),            # bottom strip
        strip(r_p - 1 - cols, rows, 270),                      # left strip
    ]


def logical_to_physical(r_l: int, r_p: int) -> np.ndarray:
    """Map logical (row, col) of the R_l x 4*C_s shape -> physical (row, col).

    Logical columns [s*C_s, (s+1)*C_s) live on strip s; the chain runs
    A->B->C->D so data leaving strip s's last column enters strip s+1's
    first column after a 90-degree corner turn.
    """
    strips = pinwheel_decomposition(r_l, r_p)
    c_s = r_p - r_l
    out = np.zeros((r_l, 4 * c_s, 2), dtype=np.int64)
    for s, st in enumerate(strips):
        out[:, s * c_s:(s + 1) * c_s, :] = st["coords"]
    return out


def _l_route(start: tuple[int, int], end: tuple[int, int], primary: str) -> list[tuple[int, int]]:
    """L-shaped walk from `start` to `end` (exclusive of start, inclusive of
    end) moving first along `primary` ('row' or 'col'), then the other."""
    path = []
    r, c = start
    er, ec = end
    order = ("col", "row") if primary == "col" else ("row", "col")
    for axis in order:
        while (c != ec if axis == "col" else r != er):
            if axis == "col":
                c += 1 if ec > c else -1
            else:
                r += 1 if er > r else -1
            path.append((r, c))
    return path


def roundabout_ring(r_l: int, r_p: int, lane: int) -> tuple[np.ndarray, list[int]]:
    """The closed physical route streaming data of logical row `lane` takes:
    4 strips + 4 corner transits.  Returns (path [steps, 2], corner_hops).

    Corner transits pass through PEs belonging to other lanes' logical
    positions in pass-through mode (Sec. 3.4: a PE can simultaneously MAC
    and forward roundabout traffic).  Each corner costs exactly R_l hops —
    the 4 * R_l bypass term of Eq. 4.
    """
    mapping = logical_to_physical(r_l, r_p)
    c_s = r_p - r_l
    # strip flow axes: top: east (col), right: south (row),
    # bottom: west (col), left: north (row)
    primary = ("col", "row", "col", "row")
    path: list[tuple[int, int]] = []
    corner_hops: list[int] = []
    for s in range(4):
        seg = mapping[lane, s * c_s:(s + 1) * c_s]
        path.extend(map(tuple, seg.tolist()))
        nxt = tuple(mapping[lane, ((s + 1) * c_s) % (4 * c_s)].tolist())
        corner = _l_route(tuple(seg[-1].tolist()), nxt, primary[s])
        corner_hops.append(len(corner))
        path.extend(corner[:-1])  # next strip's first cell re-added next loop
    return np.asarray(path, dtype=np.int64), corner_hops


def validate_roundabout(r_l: int, r_p: int) -> dict:
    """Check the lightweight-wiring claims; returns stats, raises on violation.

    * placement is injective (no PE used twice) and covers exactly
      R_l * C_l == R_p^2 - (R_p - 2*R_l)^2 PEs (center square idles);
    * every hop of every lane's full ring (strips + corner transits) is
      between Manhattan-adjacent PEs — the "internal connection manner"
      uses neighbor links only (Fig. 7b);
    * each of the 4 corner transits costs exactly R_l hops, and the ring
      closes — Eq. 4's 4*R_l bypass term.
    """
    mapping = logical_to_physical(r_l, r_p)
    flat = mapping.reshape(-1, 2)
    seen = {tuple(p) for p in flat.tolist()}
    if len(seen) != flat.shape[0]:
        raise AssertionError(f"pinwheel placement not injective for R_l={r_l}, R_p={r_p}")
    expected = r_p * r_p - (r_p - 2 * r_l) ** 2
    if flat.shape[0] != expected:
        raise AssertionError(f"used {flat.shape[0]} PEs, expected {expected}")
    for lane in range(r_l):
        ring, corner_hops = roundabout_ring(r_l, r_p, lane)
        closed = np.vstack([ring, ring[:1]])
        dist = np.abs(np.diff(closed, axis=0)).sum(axis=1)
        if not np.all(dist == 1):
            bad = int(np.argmax(dist != 1))
            raise AssertionError(
                f"non-adjacent hop lane={lane} step {bad}: {closed[bad]} -> {closed[bad + 1]}")
        if any(h != r_l for h in corner_hops):
            raise AssertionError(
                f"lane {lane}: corner hops {corner_hops}, expected 4 x {r_l}")
    return {
        "used_pes": flat.shape[0],
        "idle_pes": (r_p - 2 * r_l) ** 2,
        "bypass_hops_per_lane": 4 * r_l,
    }

"""ReDas analytical performance model (paper Sec. 4.2, Eq. 3-5).

The port's own copy of `repro/core/analytical_model.py`: the same numpy
operations in the same order, so every result is bit for bit the
reference's.

Estimates cycles / DRAM traffic / SRAM traffic / PE utilization for one
GEMM workload under a concrete (hardware config x GEMM mapping) candidate.

    T_total = T_start + NUM_t * max(T_exe, T_rd&wt) + T_end          (Eq. 3)

with the double-buffered (ping-pong) overlap of compute and DRAM.  Our
implementation evaluates the per-operand DRAM traffic with a closed-form
loop-nest reuse model (equivalent to the paper's "reuse-sensitive tile
access sequence" for uniform traffic) and uses

    T_mid = max(NUM_t * T_exe, total_dram_cycles)

which equals Eq. 3's sum-of-maxes when traffic is uniform across
iterations and is a tight lower bound otherwise; the difference is
second-order and documented in DESIGN.md.

T_exe (Eq. 4) is dataflow-specific.  The paper prints the WS version; OS
replaces the preload term with an output-drain term and streams K_t, IS
streams N_t:

    WS: min(R,C) + (R + C + M_t - 1) + bypass
    OS:            (R + C + K_t - 1) + min(R,C) + bypass
    IS: min(R,C) + (R + C + N_t - 1) + bypass

where bypass = 4*min(R,C) when the logical shape differs from the
physical square (roundabout corner turns), else 0 (Sec. 4.2).

The DRAM access-time functions T_r / T_w (Eq. 5) use the paper's
linear-interpolation-over-prerecorded-latency approach: effective
bandwidth ramps with DMA transaction size.

Every piece of the model (reuse walk, DRAM ramp, Eq. 4 pipeline terms,
Eq. 3 assembly) is written as a *shape-polymorphic* NumPy kernel: the
same code evaluates one candidate (0-d arrays, the scalar oracle used by
`AnalyticalModel.estimate`) or a flat tensor of thousands of candidates
(`AnalyticalModel.estimate_batch`, the mapper's vectorized search
engine).  Scalar and batched paths therefore agree bit-for-bit; the
batched path is what makes full-model mapping cheap enough for compile
time (DESIGN.md §Batched search engine).
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache

import numpy as np

from .dataflow import Dataflow, LogicalShape, bypass_cycles

# Canonical loop-order vocabulary (outermost -> innermost over 'mkn').
# Batched candidates refer to orders by index into this tuple.
LOOP_ORDERS: tuple[str, ...] = ("mnk", "mkn", "nmk", "nkm", "kmn", "knm")

# ---------------------------------------------------------------------------
# Workload and mapping-candidate descriptions
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GEMM:
    """One GEMM workload: (M x K) @ (K x N), `count` back-to-back instances.

    `name` is a human label ("resnet50/conv2_1/im2col"), `count` collapses
    repeated identical GEMMs (e.g. the 8 gate matmuls of an LSTM step x
    timesteps) so model evaluation stays O(#distinct shapes).
    """

    M: int
    K: int
    N: int
    count: int = 1
    name: str = ""

    @property
    def macs(self) -> int:
        return self.M * self.K * self.N * self.count

    @property
    def flops(self) -> int:
        return 2 * self.macs

    def __post_init__(self):
        if min(self.M, self.K, self.N, self.count) < 1:
            raise ValueError(f"degenerate GEMM {self}")


@dataclasses.dataclass(frozen=True)
class MappingConfig:
    """One point of the ReDas search space (Fig. 10).

    Hardware configuration: dataflow + logical shape + buffer allocation.
    GEMM mapping: tile size + loop order (outermost->innermost over 'mkn').
    `alloc` = SRAM capacity fractions for (input A, weight B, output O)
    buffers; sum <= 1 (Eq. 2 generalized to the whole multi-mode SRAM).
    """

    dataflow: Dataflow
    shape: LogicalShape
    tile_m: int
    tile_k: int
    tile_n: int
    loop_order: str = "mnk"
    alloc: tuple[float, float, float] = (0.3, 0.3, 0.4)

    def __post_init__(self):
        if sorted(self.loop_order) != ["k", "m", "n"]:
            raise ValueError(f"loop_order must be a permutation of 'mkn': {self.loop_order}")
        if min(self.tile_m, self.tile_k, self.tile_n) < 1:
            raise ValueError("tile dims must be >= 1")
        if sum(self.alloc) > 1.0 + 1e-9:
            raise ValueError(f"buffer over-allocated: {self.alloc}")


@dataclasses.dataclass(frozen=True)
class CostReport:
    """Everything the mapper / energy model / benchmarks need."""

    cycles: float
    compute_cycles: float
    dram_cycles: float
    start_cycles: float
    end_cycles: float
    config_cycles: float
    bypass_cycles_total: float
    num_tiles: int
    macs: int
    dram_read_bytes: float
    dram_write_bytes: float
    sram_bytes: float
    pe_utilization: float  # MACs / (cycles * physical PEs)
    valid: bool = True
    reason: str = ""

    @property
    def dram_bytes(self) -> float:
        return self.dram_read_bytes + self.dram_write_bytes


INVALID = lambda reason: CostReport(  # noqa: E731 - compact sentinel factory
    cycles=math.inf, compute_cycles=math.inf, dram_cycles=math.inf,
    start_cycles=0, end_cycles=0, config_cycles=0, bypass_cycles_total=0,
    num_tiles=0, macs=0, dram_read_bytes=0, dram_write_bytes=0, sram_bytes=0,
    pe_utilization=0.0, valid=False, reason=reason)


# ---------------------------------------------------------------------------
# DRAM model: T_r(s) / T_w(s) by linear interpolation over a prerecorded
# efficiency table (Sec. 4.2 "approximation method").
# ---------------------------------------------------------------------------

# (transaction bytes, fraction of peak bandwidth actually achieved).
# Shape of the curve follows DRAMsim3-style measurements: small DMA
# transactions are dominated by row activation / command overhead.
_DRAM_EFFICIENCY_TABLE: tuple[tuple[float, float], ...] = (
    (64.0, 0.05),
    (256.0, 0.15),
    (1024.0, 0.31),
    (4096.0, 0.55),
    (16384.0, 0.76),
    (65536.0, 0.89),
    (262144.0, 0.95),
    (1048576.0, 0.97),
    (4194304.0, 0.985),
)
_DRAM_FIXED_LATENCY_CYCLES = 64.0  # CAS + controller queue at 700 MHz

_DRAM_X = np.array([p[0] for p in _DRAM_EFFICIENCY_TABLE])
_DRAM_Y = np.array([p[1] for p in _DRAM_EFFICIENCY_TABLE])


def dram_efficiency(nbytes):
    """Piecewise-linear interpolation of effective-bandwidth fraction.

    Shape-polymorphic: accepts a scalar or an ndarray of transaction
    sizes (clamped to the table's ends, exact at the knots).
    """
    x = np.clip(np.asarray(nbytes, dtype=np.float64), _DRAM_X[0], _DRAM_X[-1])
    i = np.clip(np.searchsorted(_DRAM_X, x, side="right") - 1, 0, len(_DRAM_X) - 2)
    x0, y0 = _DRAM_X[i], _DRAM_Y[i]
    t = (x - x0) / (_DRAM_X[i + 1] - x0)
    out = y0 + t * (_DRAM_Y[i + 1] - y0)
    return float(out) if np.ndim(nbytes) == 0 else out


def dram_access_cycles(nbytes, peak_bytes_per_cycle: float):
    """T_r(s) == T_w(s): fixed latency + size / effective bandwidth.

    Shape-polymorphic like `dram_efficiency` (0 cycles for empty bursts).
    """
    cyc = _DRAM_FIXED_LATENCY_CYCLES + np.asarray(nbytes, dtype=np.float64) / (
        peak_bytes_per_cycle * dram_efficiency(nbytes))
    out = np.where(np.asarray(nbytes) <= 0, 0.0, cyc)
    return float(out) if np.ndim(nbytes) == 0 else out


# ---------------------------------------------------------------------------
# Closed-form loop-nest reuse model
# ---------------------------------------------------------------------------


def operand_fetch_count(loop_order: str, trips_m, trips_k, trips_n,
                        index_dims: frozenset[str], capacity_tiles):
    """How many tile-granularity DRAM fetches operand X needs.

    Walking the 3-deep loop nest from innermost outward: a loop over a dim
    d NOT indexing X reuses the buffered working set iff every distinct X
    tile touched by the loops inner to d fits in X's buffer allocation;
    otherwise each trip of d re-fetches them.  Dims in `index_dims` always
    multiply (they address distinct tiles).  Matches an exhaustive LRU walk
    for all 6 orders (tested in tests/test_analytical_model.py).

    Shape-polymorphic kernel: `trips_*` / `capacity_tiles` are ints (the
    scalar oracle) or equal-shape int arrays (one element per candidate
    sharing `loop_order`).  Returns -1 where the buffer cannot hold one
    tile (invalid mapping).
    """
    trips = {"m": trips_m, "k": trips_k, "n": trips_n}
    cap = np.asarray(capacity_tiles, dtype=np.int64)
    fetches = np.ones_like(cap)
    working_set = np.ones_like(cap)  # distinct X tiles touched inner to current
    for dim in reversed(loop_order):  # innermost -> outermost
        n = np.asarray(trips[dim], dtype=np.int64)
        if dim in index_dims:
            fetches = fetches * n
            working_set = working_set * n
        else:
            # overflow -> no reuse across this loop: refetch per trip;
            # else full reuse across this loop, counts unchanged.
            fetches = np.where(working_set > cap, fetches * n, fetches)
    return np.where(cap < 1, -1, fetches)


def output_k_reuse(loop_order: str, trips_m, trips_k, trips_n, capacity_tiles):
    """True where each output tile's K-reduction completes without HBM spills.

    The output tile (m, n) is revisited across the k loop; partials stay
    on chip iff all distinct output tiles touched by loops inner to k fit
    in the output buffer (OS keeps them in the PE array itself: the
    capacity check still gates the *buffer-side* accumulators for tails).
    Shape-polymorphic like `operand_fetch_count`.
    """
    trips = {"m": trips_m, "k": trips_k, "n": trips_n}
    cap = np.asarray(capacity_tiles, dtype=np.int64)
    working_set = np.ones_like(cap)
    for dim in reversed(loop_order):
        if dim == "k":
            return (working_set <= cap) & (cap >= 1)
        working_set = working_set * np.asarray(trips[dim], dtype=np.int64)
    raise AssertionError("k not in loop order")


def _operand_fetch_count(loop_order: str, trips: dict[str, int],
                         index_dims: frozenset[str], capacity_tiles: int) -> int:
    """Scalar view of `operand_fetch_count` (the oracle-path entry)."""
    return int(operand_fetch_count(loop_order, trips["m"], trips["k"],
                                   trips["n"], index_dims, capacity_tiles))


def _output_k_reuse(loop_order: str, trips: dict[str, int], capacity_tiles: int) -> bool:
    """Scalar view of `output_k_reuse` (the oracle-path entry)."""
    return bool(output_k_reuse(loop_order, trips["m"], trips["k"],
                               trips["n"], capacity_tiles))


# ---------------------------------------------------------------------------
# Per-dataflow T_exe (Eq. 4 family)
# ---------------------------------------------------------------------------


def tile_exe_cycles(cfg: MappingConfig, eff_m: int, eff_k: int, eff_n: int) -> float:
    """Cycles for the array to process one tile (Eq. 4, per dataflow).

    eff_* are the tile dims actually used (tail tiles are smaller, but the
    array still sweeps its pipeline; we charge the configured logical
    dims for ramp terms and the streaming dim's effective length).
    """
    r, c = cfg.shape.rows, cfg.shape.cols
    byp = bypass_cycles(cfg.shape)
    ramp = r + c - 1
    if cfg.dataflow == Dataflow.WS:
        return min(r, c) + (ramp + eff_m) + byp
    if cfg.dataflow == Dataflow.OS:
        return (ramp + eff_k) + min(r, c) + byp
    return min(r, c) + (ramp + eff_n) + byp  # IS


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


@lru_cache(maxsize=200_000)
def _estimate_cached(gemm: GEMM, cfg: MappingConfig, hw_key: tuple) -> CostReport:
    (r_p, sram_bytes, word_bytes, peak_bpc, config_cycles, bypass_enabled,
     setup_floor) = hw_key

    # --- tile legality -----------------------------------------------------
    m_t = min(cfg.tile_m, gemm.M)
    k_t = min(cfg.tile_k, gemm.K)
    n_t = min(cfg.tile_n, gemm.N)

    s_i = m_t * k_t * word_bytes  # input tile bytes
    s_w = k_t * n_t * word_bytes  # weight tile bytes
    s_o = m_t * n_t * word_bytes  # output tile bytes

    # Ping-pong double buffering halves usable capacity per operand (Eq. 2).
    cap_a = int(cfg.alloc[0] * sram_bytes / 2)
    cap_b = int(cfg.alloc[1] * sram_bytes / 2)
    cap_o = int(cfg.alloc[2] * sram_bytes / 2)
    if s_i > cap_a or s_w > cap_b or s_o > cap_o:
        return INVALID(
            f"tile does not fit buffers: S_i={s_i}/{cap_a} S_w={s_w}/{cap_b} S_o={s_o}/{cap_o}")

    trips = {  # exact integer ceil-div, shared convention with estimate_batch
        "m": -(-gemm.M // m_t),
        "k": -(-gemm.K // k_t),
        "n": -(-gemm.N // n_t),
    }
    num_t = trips["m"] * trips["k"] * trips["n"]

    # --- DRAM traffic via loop-nest reuse (per single GEMM instance) -------
    fetches_a = _operand_fetch_count(cfg.loop_order, trips, frozenset("mk"), cap_a // max(s_i, 1))
    fetches_b = _operand_fetch_count(cfg.loop_order, trips, frozenset("kn"), cap_b // max(s_w, 1))
    if fetches_a < 0 or fetches_b < 0:
        return INVALID("operand buffer cannot hold one tile")
    out_tiles = trips["m"] * trips["n"]
    k_on_chip = _output_k_reuse(cfg.loop_order, trips, cap_o // max(s_o, 1))
    if k_on_chip:
        writes_o, reads_o = out_tiles, 0
    else:
        # partial sums round-trip through DRAM once per k sweep
        writes_o = out_tiles * trips["k"]
        reads_o = out_tiles * (trips["k"] - 1)

    t_r_i = dram_access_cycles(s_i, peak_bpc)
    t_r_w = dram_access_cycles(s_w, peak_bpc)
    t_io_o = dram_access_cycles(s_o, peak_bpc)
    dram_cycles = (fetches_a * t_r_i + fetches_b * t_r_w + (writes_o + reads_o) * t_io_o)
    dram_read_bytes = fetches_a * s_i + fetches_b * s_w + reads_o * s_o
    dram_write_bytes = writes_o * s_o

    # --- compute time ------------------------------------------------------
    t_exe = tile_exe_cycles(cfg, m_t, k_t, n_t)
    if not bypass_enabled and not cfg.shape.is_square:
        # accelerators without roundabout paths pay no bypass (they cannot
        # reshape at all -- their shape space already excludes this).
        t_exe -= bypass_cycles(cfg.shape)
    compute_cycles = num_t * t_exe

    # --- Eq. 3 assembly (per instance) --------------------------------------
    t_start = max(t_r_i + t_r_w, float(max(config_cycles, setup_floor)))
    t_end = t_io_o
    t_mid = max(compute_cycles, dram_cycles)
    cycles_one = t_start + t_mid + t_end
    cycles = cycles_one * gemm.count

    # SRAM traffic: every tile execution streams its operands through the
    # multi-mode buffers; DRAM-side fills/spills add their own port traffic.
    sram_stream = num_t * (s_i + s_w) + (writes_o + reads_o) * s_o
    sram_bytes_total = (sram_stream + dram_read_bytes + dram_write_bytes) * gemm.count

    macs = gemm.macs
    util = macs / (cycles * r_p * r_p) if cycles > 0 else 0.0
    byp_total = (bypass_cycles(cfg.shape) if bypass_enabled else 0) * num_t * gemm.count

    return CostReport(
        cycles=cycles,
        compute_cycles=compute_cycles * gemm.count,
        dram_cycles=dram_cycles * gemm.count,
        start_cycles=t_start * gemm.count,
        end_cycles=t_end * gemm.count,
        config_cycles=float(config_cycles * gemm.count),
        bypass_cycles_total=float(byp_total),
        num_tiles=num_t * gemm.count,
        macs=macs,
        dram_read_bytes=dram_read_bytes * gemm.count,
        dram_write_bytes=dram_write_bytes * gemm.count,
        sram_bytes=sram_bytes_total,
        pe_utilization=util,
    )


class AnalyticalModel:
    """Eq. 3-5 evaluator bound to one accelerator's hardware constants."""

    def __init__(
        self,
        *,
        array_size: int = 128,
        sram_bytes: int = 4 * 2**20,
        word_bytes: int = 1,  # int8 (Table 4)
        freq_hz: float = 700e6,
        dram_bw_bytes_per_s: float = 256e9,
        config_cycles: int = 128,
        bypass_enabled: bool = True,
        setup_floor: int = 0,
    ):
        self.array_size = array_size
        self.sram_bytes = sram_bytes
        self.word_bytes = word_bytes
        self.freq_hz = freq_hz
        self.peak_bytes_per_cycle = dram_bw_bytes_per_s / freq_hz
        self.config_cycles = config_cycles
        self.bypass_enabled = bypass_enabled
        self.setup_floor = setup_floor

    def _hw_key(self) -> tuple:
        return (
            self.array_size, self.sram_bytes, self.word_bytes,
            self.peak_bytes_per_cycle, self.config_cycles,
            self.bypass_enabled, self.setup_floor,
        )

    def estimate(self, gemm: GEMM, cfg: MappingConfig) -> CostReport:
        """Full Eq. 3 cost of `gemm` under mapping `cfg`."""
        return _estimate_cached(gemm, cfg, self._hw_key())

    def estimate_batch(
        self,
        gemm: GEMM,
        *,
        rows: np.ndarray,
        cols: np.ndarray,
        tile_m: np.ndarray,
        tile_k: np.ndarray,
        tile_n: np.ndarray,
        order_ids: np.ndarray,
        stream_dims: np.ndarray,
        alloc: np.ndarray,
    ) -> dict[str, np.ndarray]:
        """Eq. 3 cost of `gemm` under a flat tensor of mapping candidates.

        All per-candidate columns are equal-length arrays: logical shape
        (`rows`/`cols`), raw tile sizes, loop order as an index into
        LOOP_ORDERS, the Eq. 4 streaming dimension (`stream_dims`:
        0 -> M_t, 1 -> K_t, 2 -> N_t, derived from the dataflow), and
        `alloc` as an [n, 3] fraction table.  Runs the same shape-
        polymorphic kernels as the scalar path, so for any candidate
        ``cycles[i]`` equals ``estimate(gemm, cfg_i).cycles`` bit-for-bit
        (invalid candidates get +inf).  Returns a dict of arrays:
        cycles / valid / compute_cycles / dram_cycles / num_tiles.
        """
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        order_ids = np.asarray(order_ids)
        alloc = np.asarray(alloc, dtype=np.float64)

        # --- tile legality (mirrors _estimate_cached line for line) --------
        m_t = np.minimum(np.asarray(tile_m, dtype=np.int64), gemm.M)
        k_t = np.minimum(np.asarray(tile_k, dtype=np.int64), gemm.K)
        n_t = np.minimum(np.asarray(tile_n, dtype=np.int64), gemm.N)

        s_i = m_t * k_t * self.word_bytes
        s_w = k_t * n_t * self.word_bytes
        s_o = m_t * n_t * self.word_bytes

        cap_a = np.floor(alloc[:, 0] * self.sram_bytes / 2).astype(np.int64)
        cap_b = np.floor(alloc[:, 1] * self.sram_bytes / 2).astype(np.int64)
        cap_o = np.floor(alloc[:, 2] * self.sram_bytes / 2).astype(np.int64)
        fits = (s_i <= cap_a) & (s_w <= cap_b) & (s_o <= cap_o)

        trips_m = -(-gemm.M // m_t)
        trips_k = -(-gemm.K // k_t)
        trips_n = -(-gemm.N // n_t)
        num_t = trips_m * trips_k * trips_n

        # --- DRAM traffic via the shared reuse kernels, grouped by order ---
        cap_ta = cap_a // np.maximum(s_i, 1)
        cap_tb = cap_b // np.maximum(s_w, 1)
        cap_to = cap_o // np.maximum(s_o, 1)
        fetches_a = np.empty_like(num_t)
        fetches_b = np.empty_like(num_t)
        k_on_chip = np.empty(num_t.shape, dtype=bool)
        for oid in np.unique(order_ids):
            sel = order_ids == oid
            order = LOOP_ORDERS[int(oid)]
            tm, tk, tn = trips_m[sel], trips_k[sel], trips_n[sel]
            fetches_a[sel] = operand_fetch_count(
                order, tm, tk, tn, frozenset("mk"), cap_ta[sel])
            fetches_b[sel] = operand_fetch_count(
                order, tm, tk, tn, frozenset("kn"), cap_tb[sel])
            k_on_chip[sel] = output_k_reuse(order, tm, tk, tn, cap_to[sel])
        valid = fits & (fetches_a >= 0) & (fetches_b >= 0)

        out_tiles = trips_m * trips_n
        writes_o = np.where(k_on_chip, out_tiles, out_tiles * trips_k)
        reads_o = np.where(k_on_chip, 0, out_tiles * (trips_k - 1))

        peak = self.peak_bytes_per_cycle
        t_r_i = dram_access_cycles(s_i, peak)
        t_r_w = dram_access_cycles(s_w, peak)
        t_io_o = dram_access_cycles(s_o, peak)
        dram_cycles = (fetches_a * t_r_i + fetches_b * t_r_w
                       + (writes_o + reads_o) * t_io_o)

        # --- compute time: Eq. 4 with the dataflow's streaming dim ---------
        byp = np.where(rows == cols, 0,
                       4 * np.minimum(rows, cols)) if self.bypass_enabled else 0
        eff = np.where(stream_dims == 0, m_t,
                       np.where(stream_dims == 1, k_t, n_t))
        t_exe = (np.minimum(rows, cols) + (rows + cols - 1) + eff
                 + byp).astype(np.float64)
        compute_cycles = num_t * t_exe

        # --- Eq. 3 assembly (x count, like the scalar path) ----------------
        t_start = np.maximum(t_r_i + t_r_w,
                             float(max(self.config_cycles, self.setup_floor)))
        t_mid = np.maximum(compute_cycles, dram_cycles)
        cycles_one = t_start + t_mid + t_io_o
        cycles = np.where(valid, cycles_one * gemm.count, np.inf)
        return {
            "cycles": cycles,
            "valid": valid,
            "compute_cycles": compute_cycles * gemm.count,
            "dram_cycles": dram_cycles * gemm.count,
            "num_tiles": num_t * gemm.count,
        }

    def seconds(self, report: CostReport) -> float:
        return report.cycles / self.freq_hz

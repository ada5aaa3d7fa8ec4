"""ReDas Mapper (paper Sec. 4): configuration + mapping search per GEMM.

The port's own copy of `repro/core/mapper.py`: the same numpy
operations in the same order, so every result is bit for bit the
reference's.

Pipeline per GEMM workload (Fig. 10):
  1. search-space generator — hardware configs (logical shape x dataflow x
     buffer allocation) x GEMM mappings (tile size x loop order);
  2. analytical model (core.analytical_model) estimates runtime;
  3. interval sampling engine prunes the space from ~10^10 raw points to
     ~2k candidates (paper: 1923 avg for ResNet-50) with 0.1-2% loss.

Interval sampling concretely:
  * the free tile dimension (the one not pinned by the logical shape,
    Sec. 4.1) is sampled geometrically + the two boundary points
    (whole-dim, max-that-fits) instead of every legal integer;
  * buffer allocations are sampled on a coarse simplex grid (interval 0.2)
    instead of every bank split;
  * loop orders are derived from the dataflow (the order that keeps the
    stationary operand resident and finishes output reductions on-chip)
    instead of all 6 permutations — matching "ReDas Mapper generates loop
    nests based on the tile size and buffer allocation" (Sec. 4.3);
  * repeated GEMM shapes reuse the previous decision (decision cache).

`space_size()` reports the un-pruned cardinality for the Fig. 19
brute-force comparison.

Search execution (vectorized by default): the pruned candidate set is
enumerated once into flat NumPy columns (`CandidateBatch`, exactly the
order `candidates()` yields) and evaluated in one
`AnalyticalModel.estimate_batch` call + argmin — no per-candidate Python
loop.  The scalar loop survives behind ``vectorized=False`` as the
reference oracle; both paths share the analytical-model kernels, so they
pick identical mappings (tested by tests/test_batched_mapper.py, gated
at 0.1% by benchmarks/bench.py in CI).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator

import numpy as np

from .accelerators import AcceleratorSpec
from .analytical_model import LOOP_ORDERS, CostReport, GEMM, MappingConfig
from .dataflow import Dataflow, LogicalShape, tile_dims_for

# Simplex grid of (input, weight, output) SRAM fractions at interval 0.2.
ALLOC_CANDIDATES: tuple[tuple[float, float, float], ...] = (
    (0.2, 0.2, 0.6),
    (0.2, 0.4, 0.4),
    (0.4, 0.2, 0.4),
    (0.4, 0.4, 0.2),
    (0.6, 0.2, 0.2),
    (0.2, 0.6, 0.2),
)

# Loop orders derived per dataflow (outermost -> innermost).  Keeping the
# reduction (k) innermost finishes each output tile on-chip; the stationary
# operand's free dim is placed innermost-but-one so its tile is revisited.
_DERIVED_ORDERS: dict[Dataflow, tuple[str, ...]] = {
    Dataflow.OS: ("mnk", "nmk"),
    Dataflow.WS: ("nmk", "nkm"),
    Dataflow.IS: ("mnk", "mkn"),
}

ALL_ORDERS = LOOP_ORDERS

# Eq. 4 streaming dimension per dataflow: 0 -> M_t, 1 -> K_t, 2 -> N_t.
_STREAM_DIM = {Dataflow.WS: 0, Dataflow.OS: 1, Dataflow.IS: 2}


@dataclasses.dataclass(frozen=True)
class CandidateBatch:
    """The pruned search space of one GEMM as flat columns (one row per
    candidate, in exactly the order `ReDasMapper.candidates()` yields so
    argmin tie-breaking matches the scalar first-strict-min loop)."""

    dataflows: tuple[Dataflow, ...]   # decode table for `df`
    df: np.ndarray                    # index into `dataflows`
    rows: np.ndarray
    cols: np.ndarray
    tile_m: np.ndarray
    tile_k: np.ndarray
    tile_n: np.ndarray
    order_ids: np.ndarray             # index into LOOP_ORDERS
    alloc_ids: np.ndarray             # index into ALLOC_CANDIDATES

    def __len__(self) -> int:
        return self.df.shape[0]

    def config(self, i: int) -> MappingConfig:
        """Materialize row `i` as a MappingConfig."""
        return MappingConfig(
            dataflow=self.dataflows[int(self.df[i])],
            shape=LogicalShape(int(self.rows[i]), int(self.cols[i])),
            tile_m=int(self.tile_m[i]),
            tile_k=int(self.tile_k[i]),
            tile_n=int(self.tile_n[i]),
            loop_order=LOOP_ORDERS[int(self.order_ids[i])],
            alloc=ALLOC_CANDIDATES[int(self.alloc_ids[i])],
        )


@dataclasses.dataclass(frozen=True)
class MappingDecision:
    gemm: GEMM
    config: MappingConfig
    report: CostReport
    candidates_evaluated: int = 0


@dataclasses.dataclass
class ModelMapping:
    """Aggregated mapping of a whole DNN (a sequence of GEMMs)."""

    decisions: list[MappingDecision]

    @property
    def total_cycles(self) -> float:
        return sum(d.report.cycles for d in self.decisions)

    @property
    def total_macs(self) -> int:
        return sum(d.report.macs for d in self.decisions)

    @property
    def total_dram_bytes(self) -> float:
        return sum(d.report.dram_bytes for d in self.decisions)

    @property
    def total_sram_bytes(self) -> float:
        return sum(d.report.sram_bytes for d in self.decisions)

    @property
    def total_config_cycles(self) -> float:
        return sum(d.report.config_cycles for d in self.decisions)

    @property
    def total_bypass_cycles(self) -> float:
        return sum(d.report.bypass_cycles_total for d in self.decisions)

    def pe_utilization(self, array_size: int) -> float:
        t = self.total_cycles
        return self.total_macs / (t * array_size * array_size) if t else 0.0


def _geometric_samples(lo: int, hi: int, *, ratio: float = 2.0) -> list[int]:
    """lo, lo*r, lo*r^2, ... capped at hi; always includes hi."""
    if hi <= lo:
        return [max(hi, 1)]
    out, v = [], float(lo)
    while v < hi:
        out.append(int(round(v)))
        v *= ratio
    out.append(hi)
    return sorted(set(out))


class ReDasMapper:
    """Search engine bound to one accelerator spec (works for baselines too:
    their spec's `shapes`/`dataflows` restrict the space, which is exactly
    how the paper constructs fair baseline mappings, Sec. 5.1)."""

    def __init__(
        self,
        spec: AcceleratorSpec,
        *,
        array_size: int | None = None,
        mode: str = "interval",  # "interval" | "exhaustive-orders"
        free_dim_ratio: float = 2.0,
        max_free_dim: int | None = None,
        vectorized: bool = True,
    ):
        """max_free_dim bounds the un-pinned tile dimension.  Our default
        (None) lets the fixed baseline stream the whole free dim, which
        makes it input-bandwidth-optimal on big-M GEMMs; bounding it
        models baselines that re-preload per tile (the sensitivity study
        behind EXPERIMENTS.md §Paper-validation's magnitude analysis).

        vectorized=False drops to the per-candidate scalar loop — the
        reference oracle the batched engine is gated against."""
        self.spec = spec
        self.array_size = array_size or spec.array_size
        self.model = spec.model(self.array_size)
        self.shapes = spec.shapes_for(self.array_size)
        self.mode = mode
        self.free_dim_ratio = free_dim_ratio
        self.max_free_dim = max_free_dim
        self.vectorized = vectorized
        self._decision_cache: dict[tuple[int, int, int], MappingDecision] = {}

    # -- search space ------------------------------------------------------

    def _free_dim_candidates(self, gemm: GEMM, dataflow: Dataflow,
                             shape: LogicalShape) -> tuple[str, list[int]]:
        dims = tile_dims_for(dataflow, shape)
        free = dims["free"]
        workload = {"M_t": gemm.M, "K_t": gemm.K, "N_t": gemm.N}[free]
        if self.max_free_dim is not None:
            workload = min(workload, self.max_free_dim)
        # interval sampling: geometric ladder from the array side upward
        lo = min(self.array_size, workload)
        return free, _geometric_samples(lo, workload, ratio=self.free_dim_ratio)

    def candidates(self, gemm: GEMM) -> Iterator[MappingConfig]:
        for dataflow in self.spec.dataflows:
            orders = (_DERIVED_ORDERS[dataflow] if self.mode == "interval" else ALL_ORDERS)
            for shape in self.shapes:
                dims = tile_dims_for(dataflow, shape)
                free, free_vals = self._free_dim_candidates(gemm, dataflow, shape)
                for fv in free_vals:
                    sizes = dict(dims)
                    sizes[free] = fv
                    tile_m = sizes.get("M_t", fv if free == "M_t" else None)
                    tile_k = sizes.get("K_t", fv if free == "K_t" else None)
                    tile_n = sizes.get("N_t", fv if free == "N_t" else None)
                    for order in orders:
                        for alloc in ALLOC_CANDIDATES:
                            yield MappingConfig(
                                dataflow=dataflow,
                                shape=shape,
                                tile_m=int(tile_m), tile_k=int(tile_k), tile_n=int(tile_n),
                                loop_order=order,
                                alloc=alloc,
                            )

    def candidate_batch(self, gemm: GEMM) -> CandidateBatch:
        """The same pruned space as `candidates()`, as flat columns.

        Row order matches the generator's nesting exactly — dataflow >
        shape > free-dim value > loop order > buffer allocation — so a
        first-occurrence argmin reproduces the scalar loop's choice.
        Built one dataflow at a time with whole-column repeat/tile ops
        (which tile dim is free depends only on the dataflow, Sec. 4.1).
        """
        dfs = tuple(self.spec.dataflows)
        n_a = len(ALLOC_CANDIDATES)
        alloc_pat = np.arange(n_a, dtype=np.int8)
        cols_out: dict[str, list[np.ndarray]] = {
            k: [] for k in ("df", "rows", "cols", "tile_m", "tile_k",
                            "tile_n", "order_ids", "alloc_ids")}
        for di, dataflow in enumerate(dfs):
            orders = (_DERIVED_ORDERS[dataflow] if self.mode == "interval"
                      else ALL_ORDERS)
            oids = np.asarray([LOOP_ORDERS.index(o) for o in orders], np.int8)
            block = len(orders) * n_a  # inner (order x alloc) pattern
            pat_order = np.repeat(oids, n_a)
            pat_alloc = np.tile(alloc_pat, len(orders))
            fv_parts, shape_rows, shape_cols, counts = [], [], [], []
            for shape in self.shapes:
                _, free_vals = self._free_dim_candidates(gemm, dataflow, shape)
                fv_parts.append(np.asarray(free_vals, np.int64))
                shape_rows.append(shape.rows)
                shape_cols.append(shape.cols)
                counts.append(len(free_vals))
            fv = np.concatenate(fv_parts)          # one row per (shape, fv)
            counts = np.asarray(counts)
            rows = np.repeat(np.asarray(shape_rows, np.int64), counts)
            cols = np.repeat(np.asarray(shape_cols, np.int64), counts)
            n_fv = fv.shape[0]
            fv_col = np.repeat(fv, block)
            rows_col = np.repeat(rows, block)
            cols_col = np.repeat(cols, block)
            if dataflow == Dataflow.OS:    # M_t=rows, N_t=cols, K free
                tm, tk, tn = rows_col, fv_col, cols_col
            elif dataflow == Dataflow.WS:  # K_t=rows, N_t=cols, M free
                tm, tk, tn = fv_col, rows_col, cols_col
            else:                          # IS: M_t=rows, K_t=cols, N free
                tm, tk, tn = rows_col, cols_col, fv_col
            cols_out["df"].append(np.full(n_fv * block, di, np.int8))
            cols_out["rows"].append(rows_col)
            cols_out["cols"].append(cols_col)
            cols_out["tile_m"].append(tm)
            cols_out["tile_k"].append(tk)
            cols_out["tile_n"].append(tn)
            cols_out["order_ids"].append(np.tile(pat_order, n_fv))
            cols_out["alloc_ids"].append(np.tile(pat_alloc, n_fv))
        return CandidateBatch(
            dataflows=dfs,
            **{k: np.concatenate(v) for k, v in cols_out.items()})

    def _search_batched(self, gemm: GEMM) -> tuple[MappingConfig, int]:
        """Evaluate the whole candidate tensor at once; first-min argmin
        reproduces the scalar loop's strict-improvement tie-breaking."""
        batch = self.candidate_batch(gemm)
        stream = np.asarray([_STREAM_DIM[d] for d in batch.dataflows],
                            np.int8)[batch.df]
        alloc = np.asarray(ALLOC_CANDIDATES, np.float64)[batch.alloc_ids]
        res = self.model.estimate_batch(
            gemm, rows=batch.rows, cols=batch.cols, tile_m=batch.tile_m,
            tile_k=batch.tile_k, tile_n=batch.tile_n,
            order_ids=batch.order_ids, stream_dims=stream, alloc=alloc)
        best = int(np.argmin(res["cycles"]))
        if not np.isfinite(res["cycles"][best]):
            raise RuntimeError(f"no valid mapping found for {gemm} on {self.spec.name}")
        return batch.config(best), len(batch)

    def space_size(self, gemm: GEMM) -> int:
        """Un-pruned cardinality (Fig. 19's brute-force space): every legal
        free-dim integer x every 1-word buffer split x all 6 orders."""
        total = 0
        d_phy = 4096  # words per bank (Sec. 4.1)
        for dataflow in self.spec.dataflows:
            for shape in self.shapes:
                free = tile_dims_for(dataflow, shape)["free"]
                workload = {"M_t": gemm.M, "K_t": gemm.K, "N_t": gemm.N}[free]
                # free dim (all integers) x D_sta/D_non splits per Eq.2 x orders
                total += workload * (d_phy * (d_phy + 1) // 2) * len(ALL_ORDERS)
        return total

    # -- search --------------------------------------------------------------

    def map_gemm(self, gemm: GEMM) -> MappingDecision:
        key = (gemm.M, gemm.K, gemm.N)
        hit = self._decision_cache.get(key)
        if hit is not None:
            # repeated shape: reuse previous choice (Sec. 4.3), re-costed at
            # this GEMM's count (estimate() is lru-cached, so this is free).
            rep = self.model.estimate(gemm, hit.config)
            return MappingDecision(gemm, hit.config, rep, candidates_evaluated=0)

        base = dataclasses.replace(gemm, count=1)
        if self.vectorized:
            best_cfg, n_eval = self._search_batched(base)
            best_rep = self.model.estimate(base, best_cfg)
        else:
            best_cfg, best_rep, n_eval = None, None, 0
            for cfg in self.candidates(base):
                rep = self.model.estimate(base, cfg)
                n_eval += 1
                if rep.valid and (best_rep is None or rep.cycles < best_rep.cycles):
                    best_cfg, best_rep = cfg, rep
            if best_cfg is None:
                raise RuntimeError(f"no valid mapping found for {gemm} on {self.spec.name}")
        unit = MappingDecision(base, best_cfg, best_rep, n_eval)
        self._decision_cache[key] = unit
        if gemm.count == 1:
            return dataclasses.replace(unit, gemm=gemm)
        scaled = self.model.estimate(gemm, best_cfg)
        return MappingDecision(gemm, best_cfg, scaled, n_eval)

    def map_model(self, gemms: Iterable[GEMM]) -> ModelMapping:
        return ModelMapping([self.map_gemm(g) for g in gemms])


def fixed_baseline_decision(
    spec: AcceleratorSpec, gemm: GEMM, *, array_size: int | None = None
) -> MappingDecision:
    """The conventional fixed-config mapping (Fig. 3 'Fixed'): native square
    shape, WS dataflow, default tiles/alloc — no search at all."""
    size = array_size or spec.array_size
    model = spec.model(size)
    shape = LogicalShape(size, size)
    best = None
    for free_m in _geometric_samples(size, max(gemm.M, 1)):
        cfg = MappingConfig(
            dataflow=Dataflow.WS, shape=shape,
            tile_m=free_m, tile_k=min(size, gemm.K), tile_n=min(size, gemm.N),
            loop_order="nmk", alloc=(0.4, 0.2, 0.4),
        )
        rep = model.estimate(gemm, cfg)
        if rep.valid and (best is None or rep.cycles < best.report.cycles):
            best = MappingDecision(gemm, cfg, rep)
    assert best is not None
    return best

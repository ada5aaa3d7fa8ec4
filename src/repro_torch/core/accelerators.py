"""Accelerator specifications: ReDas and the five baselines of Table 1.

The port's own copy of `repro/core/accelerators.py`: the same numpy
operations in the same order, so every result is bit for bit the
reference's.

Each spec fixes (i) the legal hardware-configuration space — which logical
shapes and dataflows the mapper may pick — and (ii) the energy/area
constants used by `core.energy`.  All accelerators share Table 4's common
parameters (128x128 PEs, 700 MHz, int8, 4 MB SRAM, 256 GB/s DRAM) so the
comparison isolates dataflow + reshaping capability, exactly like the
paper's methodology (Sec. 5.1: "The same hardware parameters are used for
the above baselines and ReDas for a fair comparison").

Shape spaces:
  TPUv2     fixed 128x128, WS only.
  Gemmini   fixed 128x128, WS + OS (flexible PE, fixed shape).
  Planaria  WS only, coarse-grained: 5 logical shapes composed from
            32x32 sub-arrays (Sec. 2.4: "a limited set of 5 logical
            shapes (without partitioning)").
  DyNNamic  OS only, fine-grained vertical re-chaining (same Eq. 1 family
            at granularity 4), multi-ported buffers.
  SARA      WS+OS+IS, fine-grained (granularity 4), dedicated links and
            1024-ported buffer -> fast setup but costly SRAM/area.
  ReDas     WS+OS+IS, fine-grained Eq. 1 shapes (granularity 4),
            roundabout bypass cycles, 128-cycle reconfiguration.

Energy/area constants are calibrated from Table 5, Fig. 4 and Fig. 13
(derivations in DESIGN.md Sec. 2 and core/energy.py docstrings).
"""

from __future__ import annotations

import dataclasses

from .analytical_model import AnalyticalModel
from .dataflow import ALL_DATAFLOWS, Dataflow, LogicalShape, enumerate_logical_shapes

SRAM_BYTES = 4 * 2**20        # Table 4: 4 MB on-chip SRAM
FREQ_HZ = 700e6               # Table 4: 700 MHz
DRAM_BW = 256e9               # Table 4: 256 GB/s
WORD_BYTES = 1                # Table 4: int8
ARRAY = 128                   # Table 4: 128x128
RESHAPE_GRANULARITY = 4       # Sec. 5.1: granularity limited to 4x4 (as SARA)


@dataclasses.dataclass(frozen=True)
class AcceleratorSpec:
    name: str
    dataflows: tuple[Dataflow, ...]
    shapes: tuple[LogicalShape, ...]
    array_size: int = ARRAY
    sram_bytes: int = SRAM_BYTES
    word_bytes: int = WORD_BYTES
    freq_hz: float = FREQ_HZ
    dram_bw: float = DRAM_BW
    config_cycles: int = 0          # per-GEMM reconfiguration cost
    bypass_enabled: bool = False    # Eq. 4 roundabout corner-turn cycles
    setup_floor: int = 0            # min cycles of T_start (parallel setup etc.)
    # --- energy/area constants (28 nm; see core/energy.py) -----------------
    mac_pj: float = 0.63            # dynamic energy per int8 MAC
    pe_overhead_ratio: float = 1.25 # mux/reg dynamic energy per MAC, x mac_pj
    sram_pj_per_byte: float = 3.92  # concentrated TPU-like buffer (Sec. 5.4)
    dram_pj_per_byte: float = 13.31 # HBM2 (Sec. 5.4)
    leak_w: float = 0.30            # chip leakage (buffer-dominated, Fig. 4)
    area_mm2: float = 15.35         # die area (Fig. 13 ratios)

    def model(self, array_size: int | None = None) -> AnalyticalModel:
        return AnalyticalModel(
            array_size=array_size or self.array_size,
            sram_bytes=self.sram_bytes,
            word_bytes=self.word_bytes,
            freq_hz=self.freq_hz,
            dram_bw_bytes_per_s=self.dram_bw,
            config_cycles=self.config_cycles,
            bypass_enabled=self.bypass_enabled,
            setup_floor=self.setup_floor,
        )

    def shapes_for(self, array_size: int) -> tuple[LogicalShape, ...]:
        """Shape space re-derived for a different physical array size
        (sensitivity study, Fig. 18)."""
        if array_size == self.array_size:
            return self.shapes
        return _shape_space(self.name, array_size)


def _planaria_shapes(r_p: int) -> tuple[LogicalShape, ...]:
    """5 coarse shapes composed from (r_p/4 x r_p/4) sub-arrays."""
    s = r_p // 4  # 32 for a 128 array: 16 sub-arrays
    return (
        LogicalShape(r_p, r_p),
        LogicalShape(r_p // 2, r_p * 2),
        LogicalShape(r_p * 2, r_p // 2),
        LogicalShape(s, r_p * 4),
        LogicalShape(r_p * 4, s),
    )


def _shape_space(name: str, r_p: int) -> tuple[LogicalShape, ...]:
    fixed = (LogicalShape(r_p, r_p),)
    if name in ("tpu", "gemmini"):
        return fixed
    if name == "planaria":
        return _planaria_shapes(r_p)
    # redas / sara / dynnamic: fine-grained Eq. 1 family
    return enumerate_logical_shapes(r_p, granularity=RESHAPE_GRANULARITY)


def make_specs(array_size: int = ARRAY) -> dict[str, AcceleratorSpec]:
    """All six accelerators at a given physical array size."""
    return {
        "tpu": AcceleratorSpec(
            name="tpu",
            dataflows=(Dataflow.WS,),
            shapes=_shape_space("tpu", array_size),
            array_size=array_size,
        ),
        "gemmini": AcceleratorSpec(
            name="gemmini",
            dataflows=(Dataflow.WS, Dataflow.OS),
            shapes=_shape_space("gemmini", array_size),
            array_size=array_size,
            pe_overhead_ratio=1.35,     # dual-dataflow PE muxing
            area_mm2=16.1,
        ),
        "planaria": AcceleratorSpec(
            name="planaria",
            dataflows=(Dataflow.WS,),
            shapes=_shape_space("planaria", array_size),
            array_size=array_size,
            config_cycles=2 * array_size,  # omni-directional fission reconfig
            pe_overhead_ratio=1.45,
            sram_pj_per_byte=4.10,
            leak_w=0.35,
            area_mm2=17.7,
        ),
        "dynnamic": AcceleratorSpec(
            name="dynnamic",
            dataflows=(Dataflow.OS,),
            shapes=_shape_space("dynnamic", array_size),
            array_size=array_size,
            config_cycles=array_size,
            pe_overhead_ratio=1.5,
            sram_pj_per_byte=8.2,       # multi-ported SRAM (Sec. 2.5)
            leak_w=0.42,
            area_mm2=35.5,
        ),
        "sara": AcceleratorSpec(
            name="sara",
            dataflows=ALL_DATAFLOWS,
            shapes=_shape_space("sara", array_size),
            array_size=array_size,
            config_cycles=RESHAPE_GRANULARITY,  # parallel per-sub-array setup
            setup_floor=RESHAPE_GRANULARITY,
            pe_overhead_ratio=1.6,
            sram_pj_per_byte=9.8,       # 1024-ported buffer (Fig. 4)
            leak_w=0.58 + 0.20,         # 580 mW buffer leakage + rest
            area_mm2=76.9,              # ReDas is ~27% of SARA (Sec. 5.4)
        ),
        "redas": AcceleratorSpec(
            name="redas",
            dataflows=ALL_DATAFLOWS,
            shapes=_shape_space("redas", array_size),
            array_size=array_size,
            config_cycles=array_size,   # Sec. 4: 128 cycles for a 128 array
            bypass_enabled=True,
            pe_overhead_ratio=2.79,     # Table 5: (1.61+2.31)/1.29 additional+orig muxes
            sram_pj_per_byte=4.19,      # Sec. 5.4: distributed multi-mode buffer
            leak_w=0.33,
            area_mm2=20.77,             # Table 5
        ),
    }


SPECS = make_specs()
REDAS = SPECS["redas"]
TPU = SPECS["tpu"]

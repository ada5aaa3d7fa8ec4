"""Energy / power-efficiency / EDP / ADP model (paper Sec. 5.3-5.7).

The port's own copy of `repro/core/energy.py`: the same numpy
operations in the same order, so every result is bit for bit the
reference's.

Constants are calibrated against the paper's synthesis results:
  * Table 5 (ReDas, ResNet-50 inference): PE-array energy 5.21 mJ of which
    MACs 1.29 mJ, original muxes/regs 1.61 mJ, additional muxes/regs
    2.31 mJ  ->  per-MAC dynamic energy 1.29 mJ / ~2.05 GMAC = 0.63 pJ and
    a ReDas PE-overhead ratio of (1.61+2.31)/1.29 = 2.79 x MAC energy
    (TPU-like PEs carry only the original 1.61/1.29 = 1.25 x).
  * Sec. 5.4: SRAM access energy — ReDas distributed buffer 4.19 pJ/B,
    TPU concentrated buffer 3.92 pJ/B; SARA/DyNNamic multi-ported SRAMs
    cost 2-2.5x more per access (Fig. 4 trend).
  * Sec. 5.4: off-chip HBM2 13.31 pJ/B.
  * Fig. 4: buffer leakage 56 mW (single-port 1 MB) to 580 mW (SARA).
  * Fig. 13 / Table 5: die areas — ReDas 20.77 mm^2 (TPU +35.3%),
    SARA ~76.9 mm^2 (ReDas is ~27% of SARA), DyNNamic ~35.5 mm^2.

Energy accounting per model inference:
  E = MACs * mac_pj * (1 + overhead_ratio)
    + SRAM_bytes * sram_pj + DRAM_bytes * dram_pj
    + vector_elements * simd_pj + leak_w * runtime.
"""

from __future__ import annotations

import dataclasses

from .accelerators import AcceleratorSpec
from .mapper import ModelMapping

SIMD_PJ_PER_ELEMENT = 1.8   # NN-LUT SIMD op energy (int8 lane, 28 nm)
SIMD_LANES = 4 * 64         # 4 SIMD vector units x 64 lanes (Sec. 3.1)


@dataclasses.dataclass(frozen=True)
class EnergyReport:
    runtime_s: float
    energy_j: float
    mac_j: float
    sram_j: float
    dram_j: float
    simd_j: float
    leak_j: float

    @property
    def power_w(self) -> float:
        return self.energy_j / self.runtime_s if self.runtime_s else 0.0

    @property
    def edp(self) -> float:
        return self.energy_j * self.runtime_s

    def adp(self, area_mm2: float) -> float:
        return area_mm2 * self.runtime_s

    def power_efficiency(self, flops: float) -> float:
        """Throughput per watt: FLOP/s / W == FLOP / J."""
        return flops / self.energy_j if self.energy_j else 0.0


def vector_cycles(vector_elements: int) -> float:
    """SIMD time for the non-GEMM layers; the PE array and SIMD units work
    in a pipeline (Sec. 3.1), so only a fraction is exposed — Fig. 15 shows
    0.1-6.9%; we expose 50% of SIMD time as non-overlapped."""
    return 0.5 * vector_elements / SIMD_LANES


def model_energy(
    spec: AcceleratorSpec,
    mapping: ModelMapping,
    vector_elements: int = 0,
    array_size: int | None = None,
) -> EnergyReport:
    size = array_size or spec.array_size
    scale = (size * size) / float(spec.array_size * spec.array_size)
    gemm_cycles = mapping.total_cycles
    total_cycles = gemm_cycles + vector_cycles(vector_elements)
    runtime = total_cycles / spec.freq_hz

    mac_j = mapping.total_macs * spec.mac_pj * (1.0 + spec.pe_overhead_ratio) * 1e-12
    sram_j = mapping.total_sram_bytes * spec.sram_pj_per_byte * 1e-12
    dram_j = mapping.total_dram_bytes * spec.dram_pj_per_byte * 1e-12
    simd_j = vector_elements * SIMD_PJ_PER_ELEMENT * 1e-12
    leak_j = spec.leak_w * scale * runtime
    return EnergyReport(
        runtime_s=runtime,
        energy_j=mac_j + sram_j + dram_j + simd_j + leak_j,
        mac_j=mac_j, sram_j=sram_j, dram_j=dram_j, simd_j=simd_j, leak_j=leak_j,
    )

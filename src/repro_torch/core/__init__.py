"""Plane 1 of the port: the ReDas accelerator — dataflows/shapes (Eq. 1),
the Eq. 3-5 analytical model, the interval-sampling mapper (§4), the
cycle-level functional simulator (PyTorch, on the card or the CPU), the
Table-3 workload traces and the energy/EDP/ADP model.  The reference's
`core/tpu_model.py` (a TPU v5e roofline) has no copy here: the port's
`engine.cost.HopperModel` plans for the H100 in its place."""

from .accelerators import REDAS, SPECS, TPU, AcceleratorSpec, make_specs
from .analytical_model import GEMM, LOOP_ORDERS, AnalyticalModel, MappingConfig
from .dataflow import Dataflow, LogicalShape, enumerate_logical_shapes
from .mapper import CandidateBatch, ReDasMapper
from .workloads import WORKLOADS, arch_gemms

__all__ = [
    "REDAS", "SPECS", "TPU", "AcceleratorSpec", "make_specs",
    "GEMM", "LOOP_ORDERS", "AnalyticalModel", "MappingConfig",
    "Dataflow", "LogicalShape", "enumerate_logical_shapes",
    "CandidateBatch", "ReDasMapper",
    "WORKLOADS", "arch_gemms",
]

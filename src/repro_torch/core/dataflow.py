"""Dataflows and logical-shape enumeration for the ReDas systolic array.

The port's own copy of `repro/core/dataflow.py`: the same numpy
operations in the same order, so every result is bit for bit the
reference's.

Implements the paper's Eq. (1): for a physical array of R_p x C_p PEs
(assumed square, R_p == C_p), the roundabout data paths chain four
sub-arrays end-to-end, producing logical shapes

    0 < R_l <= R_p / 2,   C_l = 4 * (C_p - R_l)        (wide shapes)
    0 < C_l <= R_p / 2,   R_l = 4 * (R_p - C_l)        (tall shapes)
    R_l = R_p, C_l = C_p                               (native square)

A R_p x R_p array therefore supports exactly R_p + 1 logical shapes
(R_p/2 wide + R_p/2 tall + 1 native).  The paper's example: a 6x6 array
reshapes to {1x20, 20x1, 2x16, 16x2, 3x12, 12x3, 6x6} -- 7 shapes.

Reshaping granularity: the paper evaluates ReDas with granularity 4x4
(consistent with SARA); `enumerate_logical_shapes(..., granularity=g)`
restricts R_l (resp. C_l) to multiples of g.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Iterator


class Dataflow(str, enum.Enum):
    """The three systolic dataflows (paper Sec. 2.2).

    Each dataflow pins one operand (stationary) into the PE registers and
    streams the other two through the array edges:
      WS: weight (K x N) stationary; inputs stream, outputs accumulate out.
      OS: output (M x N) stationary; inputs and weights stream, partials
          accumulate in-place (no edge accumulators needed).
      IS: input (M x K) stationary; weights stream, outputs accumulate out.
    """

    WS = "ws"
    OS = "os"
    IS = "is"

    @property
    def stationary(self) -> str:
        return {Dataflow.WS: "weight", Dataflow.OS: "output", Dataflow.IS: "input"}[self]


ALL_DATAFLOWS = (Dataflow.OS, Dataflow.WS, Dataflow.IS)


@dataclasses.dataclass(frozen=True, order=True)
class LogicalShape:
    """A logical (rows x cols) view of the physical array.

    `bypass` is True when the shape differs from the physical square, i.e.
    the roundabout data path is active and Eq. (4)'s extra corner-turn
    cycles apply.
    """

    rows: int
    cols: int

    @property
    def n_pe(self) -> int:
        return self.rows * self.cols

    @property
    def is_square(self) -> bool:
        return self.rows == self.cols

    def transposed(self) -> "LogicalShape":
        return LogicalShape(self.cols, self.rows)

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return f"{self.rows}x{self.cols}"


def _check_physical(r_p: int, c_p: int) -> None:
    if r_p != c_p:
        raise ValueError(f"paper assumes a square physical array, got {r_p}x{c_p}")
    if r_p <= 0 or r_p % 2:
        raise ValueError(f"physical array side must be positive and even, got {r_p}")


def iter_logical_shapes(
    r_p: int, c_p: int | None = None, granularity: int = 1
) -> Iterator[LogicalShape]:
    """Yield every logical shape of Eq. (1) for an r_p x r_p physical array.

    Wide shapes first (R_l ascending), then tall, then the native square.
    With granularity g > 1 only R_l (C_l) that are multiples of g are kept,
    matching the paper's evaluated 4x4 reshaping granularity (Sec. 5.1).
    """
    c_p = r_p if c_p is None else c_p
    _check_physical(r_p, c_p)
    half = r_p // 2
    for r_l in range(granularity, half + 1, granularity):
        yield LogicalShape(r_l, 4 * (c_p - r_l))
    for c_l in range(granularity, half + 1, granularity):
        yield LogicalShape(4 * (r_p - c_l), c_l)
    yield LogicalShape(r_p, c_p)


def enumerate_logical_shapes(
    r_p: int, c_p: int | None = None, granularity: int = 1
) -> tuple[LogicalShape, ...]:
    return tuple(iter_logical_shapes(r_p, c_p, granularity))


def n_logical_shapes(r_p: int, granularity: int = 1) -> int:
    """Closed-form count: 2 * floor((R_p/2)/g) + 1 (== R_p + 1 when g == 1)."""
    return 2 * ((r_p // 2) // granularity) + 1


def bypass_cycles(shape: LogicalShape) -> int:
    """Extra roundabout corner-turn cycles of Eq. (4).

    4 * min(R_l, C_l) when reshaped (data turns 90 degrees at each of the
    four corners, min-side cycles per corner); 0 for the native square.
    """
    if shape.is_square:
        return 0
    return 4 * min(shape.rows, shape.cols)


def subarray_decomposition(shape: LogicalShape, r_p: int) -> tuple[tuple[int, int], int]:
    """Return ((R_s, C_s), n_subarrays) realizing `shape` on an r_p x r_p array.

    A wide logical shape R_l x 4*C_s is built by chaining 4 sub-arrays of
    R_s=R_l rows x C_s columns each (Sec. 3.2, Fig. 6/8); tall shapes are the
    transpose.  The native square is a single "sub-array" of the full array.
    Raises if the shape is not realizable on this physical array.
    """
    if shape.rows == r_p and shape.cols == r_p:
        return (r_p, r_p), 1
    if shape.rows <= r_p // 2 and shape.cols == 4 * (r_p - shape.rows):
        return (shape.rows, r_p - shape.rows), 4
    if shape.cols <= r_p // 2 and shape.rows == 4 * (r_p - shape.cols):
        return (r_p - shape.cols, shape.cols), 4
    raise ValueError(f"{shape} is not an Eq.(1) logical shape of a {r_p}x{r_p} array")


def pe_usage(shape: LogicalShape, r_p: int) -> float:
    """Fraction of physical PEs participating in this logical shape.

    Reshaped configurations occupy 4 sub-arrays of R_s x C_s PEs; the
    remaining PEs only forward roundabout traffic or idle (Sec. 3.2 notes
    the paths "may not use all the PEs").
    """
    (r_s, c_s), n = subarray_decomposition(shape, r_p)
    return (r_s * c_s * n) / float(r_p * r_p)


def tile_dims_for(dataflow: Dataflow, shape: LogicalShape) -> dict[str, int]:
    """Which GEMM tile dims are pinned by the logical array (Sec. 4.1).

    The mapper sets two of (M_t, K_t, N_t) equal to the logical dims; the
    third is free (bounded by buffer capacity):
      OS: output tile M_t x N_t lives on the array -> M_t=rows, N_t=cols, K free.
      WS: weight tile K_t x N_t lives on the array -> K_t=rows, N_t=cols, M free.
      IS: input  tile M_t x K_t lives on the array -> M_t=rows, K_t=cols, N free.
    """
    if dataflow == Dataflow.OS:
        return {"M_t": shape.rows, "N_t": shape.cols, "free": "K_t"}
    if dataflow == Dataflow.WS:
        return {"K_t": shape.rows, "N_t": shape.cols, "free": "M_t"}
    return {"M_t": shape.rows, "K_t": shape.cols, "free": "N_t"}

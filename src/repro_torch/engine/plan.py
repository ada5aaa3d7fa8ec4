"""The decision surface: requests, decisions and the plan cache (the port
of `repro/engine/plan.py`).

  KernelRequest   — what the caller wants computed (op + problem dims).
  KernelDecision  — how to compute it (dataflow, CTA tile, backend,
                    modeled cost).
  ExecutionPlan   — the per-op decision table: the paper's "repeated GEMM
                    shapes reuse the previous choice" cache, with hit/miss
                    stats and byte-stable JSON save/load so a serving
                    process can warm-start from an earlier planning run.

The JSON format is the JAX package's, so a plan of `gemm` decisions
moves between the two; the decisions themselves are per device (a TPU
block is not on the Hopper kernel's tile menu).  No torch here: plans
are plain data.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Iterator

PLAN_FORMAT = "redas-execution-plan-v1"

#: ops the port plans and dispatches (the JAX package's `KNOWN_OPS`).
KNOWN_OPS = ("gemm", "gemm_w8", "gemm_sparse", "grouped_gemm", "attention",
             "paged_attention")


@dataclasses.dataclass(frozen=True)
class KernelRequest:
    """One kernel invocation the engine must decide a schedule for.

    `m, k, n` are the GEMM dims ((M, K) @ (K, N)); for `grouped_gemm`
    they are one expert's (C, D, F) and `groups` the expert count; for
    `attention` m is
    the query length, n the key length and k the head dim, and for
    `paged_attention` n is the page span the block table addresses.
    `groups` (batch x heads for attention) and `density` (N/M of a
    `gemm_sparse` request's storage) keep the JAX package's key and JSON
    schema (1 and 1.0 for a dense GEMM).  `name`
    is a human label only — it is excluded from the cache key so
    repeated shapes share one decision regardless of which layer asked.
    """

    op: str
    m: int
    k: int
    n: int
    groups: int = 1
    in_bytes: int = 2
    out_bytes: int = 2
    density: float = 1.0
    name: str = ""

    def __post_init__(self):
        if self.op not in KNOWN_OPS:
            raise ValueError(f"unknown op {self.op!r} (known: {KNOWN_OPS})")
        if min(self.m, self.k, self.n, self.groups) < 1:
            raise ValueError(f"degenerate request {self}")
        if not 0.0 < self.density <= 1.0:
            raise ValueError(f"density must be in (0, 1], got {self.density}")

    def key(self) -> tuple:
        """The decision-cache key (shape identity, name excluded)."""
        return (self.op, self.m, self.k, self.n, self.groups,
                self.in_bytes, self.out_bytes, self.density)


@dataclasses.dataclass(frozen=True)
class KernelDecision:
    """A chosen schedule for one `KernelRequest`.

    `dataflow` + (`bm`, `bk`, `bn`) are the per-op schedule (on Hopper
    the resident operand and the CTA tile), `backend` names the
    `KernelRegistry` entry that executes it, `seconds` is the cost
    model's estimate for one call, and `meta` carries model-specific
    extras as a sorted tuple of (key, value) pairs so decisions stay
    hashable and JSON-stable.
    """

    op: str
    dataflow: str
    bm: int
    bk: int
    bn: int
    backend: str = ""
    cost_model: str = ""
    seconds: float = 0.0
    meta: tuple[tuple[str, object], ...] = ()

    @property
    def meta_dict(self) -> dict:
        return dict(self.meta)

    def as_json_dict(self, request: KernelRequest) -> dict:
        return {
            "request": {
                "op": request.op, "m": request.m, "k": request.k,
                "n": request.n, "groups": request.groups,
                "in_bytes": request.in_bytes, "out_bytes": request.out_bytes,
                "density": request.density,
            },
            "dataflow": self.dataflow,
            "bm": self.bm, "bk": self.bk, "bn": self.bn,
            "backend": self.backend,
            "cost_model": self.cost_model,
            "seconds": self.seconds,
            "meta": {str(k): v for k, v in self.meta},
        }

    @classmethod
    def from_json_dict(cls, d: dict) -> tuple[KernelRequest, "KernelDecision"]:
        req = KernelRequest(**d["request"])
        dec = cls(
            op=req.op, dataflow=d["dataflow"],
            bm=d["bm"], bk=d["bk"], bn=d["bn"],
            backend=d["backend"], cost_model=d["cost_model"],
            seconds=d["seconds"],
            meta=tuple(sorted(d["meta"].items())),
        )
        return req, dec


@dataclasses.dataclass
class ExecutionPlan:
    """Per-op decisions + the unified decision cache (Sec. 4.3).

    One plan serves one (cost model, backend) posture: `lookup` counts
    hits/misses, `save`/`load` round-trip byte-identically (sorted keys,
    fixed indentation, trailing newline) so a plan artifact can be
    diffed and shipped to a serving job for warm-start.
    """

    cost_model: str = ""
    backend: str = ""
    decisions: dict[tuple, KernelDecision] = dataclasses.field(default_factory=dict)
    requests: dict[tuple, KernelRequest] = dataclasses.field(default_factory=dict)
    hits: int = 0
    misses: int = 0

    def __len__(self) -> int:
        return len(self.decisions)

    def __iter__(self) -> Iterator[tuple[KernelRequest, KernelDecision]]:
        for key in sorted(self.decisions):
            yield self.requests[key], self.decisions[key]

    # -- cache protocol ----------------------------------------------------

    def lookup(self, request: KernelRequest) -> KernelDecision | None:
        """Cache probe with hit/miss accounting."""
        dec = self.decisions.get(request.key())
        if dec is None:
            self.misses += 1
        else:
            self.hits += 1
        return dec

    def add(self, request: KernelRequest, decision: KernelDecision) -> None:
        key = request.key()
        self.decisions[key] = decision
        self.requests[key] = request

    @property
    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "decisions": len(self.decisions),
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": (self.hits / total) if total else 0.0,
        }

    # -- persistence -------------------------------------------------------

    def to_json(self) -> str:
        payload = {
            "format": PLAN_FORMAT,
            "cost_model": self.cost_model,
            "backend": self.backend,
            "stats": {"hits": self.hits, "misses": self.misses},
            "decisions": [self.decisions[k].as_json_dict(self.requests[k])
                          for k in sorted(self.decisions)],
        }
        return json.dumps(payload, indent=2, sort_keys=True) + "\n"

    def save(self, path) -> None:
        with open(path, "w") as fh:
            fh.write(self.to_json())

    @classmethod
    def from_json(cls, text: str) -> "ExecutionPlan":
        payload = json.loads(text)
        if payload.get("format") != PLAN_FORMAT:
            raise ValueError(
                f"not an execution plan (format={payload.get('format')!r})")
        plan = cls(cost_model=payload["cost_model"],
                   backend=payload["backend"],
                   hits=payload["stats"]["hits"],
                   misses=payload["stats"]["misses"])
        for d in payload["decisions"]:
            req, dec = KernelDecision.from_json_dict(d)
            plan.add(req, dec)
        return plan

    @classmethod
    def load(cls, path) -> "ExecutionPlan":
        with open(path) as fh:
            return cls.from_json(fh.read())

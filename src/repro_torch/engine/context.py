"""The Engine: decide (cost model + plan cache) then execute (registry),
the port of `repro/engine/context.py`.

Every `models.layers.dense` matmul (and, on the paged layout, every
decode attention; under sorted MoE dispatch, every expert matmul) inside
a `use_engine` context routes through the engine:

    with use_engine(backend="hopper") as eng:
        logits, _ = transformer.forward(params, cfg, tokens)
    eng.plan.stats

PyTorch runs eagerly, so the engine is consulted on every call (there
is no trace-time caveat as in the JAX package); a repeated shape costs
one dict hit.

On an int8 backend ("hopper-int8", "torch-ref-int8") every request keys
at in_bytes = 1, the width the int8 kernel moves, and at out_bytes = the
float compute width it rescales to; `quant_matmul` dispatches the
`gemm_w8` op for `quant.quantize_params` weights.  On a sparse backend
("hopper-sparse", "torch-ref-sparse") `sparse_matmul` dispatches the
`gemm_sparse` op for `sparse.prune_params` weights, keyed with the
storage's N and M and planned at its density N/M; sparse x int8 storage
(`prune_params(..., quantize=True)`) keys at in_bytes = 1, as the JAX
package keys it, and at out_bytes = the float compute width.
"""

from __future__ import annotations

import contextlib
import dataclasses

from .cost import HopperModel
from .plan import ExecutionPlan, KernelDecision, KernelRequest
from .registry import KernelRegistry, default_registry

_STACK: list["Engine"] = []

#: backends that execute through the int8 quantization plane: their
#: requests key at in_bytes = 1 whatever float dtype the tensors carry.
INT8_BACKENDS = ("hopper-int8", "torch-ref-int8")

#: float backend -> its int8 sibling (the `ServeConfig(quantize=True)`
#: upgrade); int8 names pass through.
_INT8_SIBLING = {
    "hopper": "hopper-int8",
    "torch-ref": "torch-ref-int8",
    "hopper-int8": "hopper-int8",
    "torch-ref-int8": "torch-ref-int8",
}


#: backends that execute through the N:M structured-sparsity plane: their
#: `gemm_sparse` requests carry the storage density in the decision key;
#: everything else dispatches as on the float plane.
SPARSE_BACKENDS = ("hopper-sparse", "torch-ref-sparse")

#: backend -> its sparse sibling (the `ServeConfig(sparsity=...)`
#: upgrade, applied after the int8 one); the int8 names upgrade too, as
#: in the JAX package, and sparse names pass through.
_SPARSE_SIBLING = {
    "hopper": "hopper-sparse",
    "torch-ref": "torch-ref-sparse",
    "hopper-int8": "hopper-sparse",
    "torch-ref-int8": "torch-ref-sparse",
    "hopper-sparse": "hopper-sparse",
    "torch-ref-sparse": "torch-ref-sparse",
}


def backend_in_bytes(backend: str | None, itemsize: int) -> int:
    """The in_bytes a request dispatched on `backend` is keyed with: the
    operand itemsize, except that int8 backends pin it to 1."""
    return 1 if backend in INT8_BACKENDS else itemsize


def int8_sibling(backend: str | None) -> str:
    """The int8 backend a `quantize=True` config executes on instead of
    `backend`; raises with the known names otherwise.  `None` resolves to
    "hopper-int8", which, like "hopper", takes the kernel on CUDA tensors
    and its plain version on CPU tensors."""
    if backend is None:
        return "hopper-int8"
    sibling = _INT8_SIBLING.get(backend)
    if sibling is None:
        raise ValueError(
            f"quantize=True cannot upgrade kernel_backend {backend!r} to an "
            f"int8 sibling (known: {sorted(_INT8_SIBLING)})")
    return sibling


def sparse_sibling(backend: str | None) -> str:
    """The sparse backend a `sparsity="N:M"` config executes on instead of
    `backend`; raises with the known names otherwise.  `None` resolves to
    "hopper-sparse", which, like "hopper", takes the kernel on CUDA
    tensors and its plain version on CPU tensors."""
    if backend is None:
        return "hopper-sparse"
    sibling = _SPARSE_SIBLING.get(backend)
    if sibling is None:
        raise ValueError(
            f"sparsity cannot upgrade kernel_backend {backend!r} to a sparse "
            f"sibling (known: {sorted(_SPARSE_SIBLING)})")
    return sibling


class Engine:
    """One (cost model, backend, plan, registry) posture.  `backend`
    defaults to "hopper": the kernel on CUDA tensors, its plain version
    on CPU tensors."""

    def __init__(self, cost_model=None, *, backend: str | None = None,
                 plan: ExecutionPlan | None = None,
                 registry: KernelRegistry | None = None):
        self.cost_model = cost_model if cost_model is not None else HopperModel()
        self.backend = backend or "hopper"
        self.registry = registry if registry is not None else default_registry()
        self.plan = plan if plan is not None else ExecutionPlan(
            cost_model=self.cost_model.name, backend=self.backend)
        # raw shape key -> (decision, kernel): the steady-state fast path
        self._memo: dict[tuple, tuple] = {}

    @property
    def int8(self) -> bool:
        """True when this engine executes on the quantized plane."""
        return self.backend in INT8_BACKENDS

    @property
    def sparse(self) -> bool:
        """True when this engine executes on the structured-sparsity plane
        (`sparse_matmul` is dispatchable)."""
        return self.backend in SPARSE_BACKENDS

    def _rebind(self, decision: KernelDecision) -> KernelDecision:
        """Execute a decision (possibly from a warm-start plan recorded for
        another backend) on this engine's backend."""
        if decision.backend == self.backend:
            return decision
        return dataclasses.replace(decision, backend=self.backend)

    def decide(self, request: KernelRequest) -> KernelDecision:
        """Plan-cache lookup, cost-model search on miss."""
        hit = self.plan.lookup(request)
        if hit is not None:
            rebound = self._rebind(hit)
            if rebound is not hit:
                self.plan.add(request, rebound)
            return rebound
        decision = self._rebind(self.cost_model.decide(request))
        self.plan.add(request, decision)
        return decision

    def _resolve(self, key: tuple, op: str, m: int, k: int, n: int,
                 groups: int, item_bytes: int, *, density: float = 1.0,
                 in_bytes: int | None = None) -> tuple:
        """Miss path: full request -> decide -> registry, then memoize.
        On an int8 backend the request keys at in_bytes = 1 and the output
        at the float compute width `item_bytes`; `density` keys a sparse
        request apart from its dense sibling; `in_bytes` overrides the
        backend's rule (sparse x int8 storage keys at 1 on a sparse
        backend, which is not an int8 one)."""
        if in_bytes is None:
            in_bytes = backend_in_bytes(self.backend, item_bytes)
        req = KernelRequest(op, m, k, n, groups=groups, in_bytes=in_bytes,
                            out_bytes=item_bytes, density=density)
        dec = self.decide(req)
        entry = self._memo[key] = (dec, self.registry.get(dec.backend, op))
        return entry

    def _lookup(self, key: tuple) -> tuple | None:
        """Memo probe; a hit counts as a plan hit, as in the JAX engine."""
        hit = self._memo.get(key)
        if hit is not None:
            self.plan.hits += 1
        return hit

    def matmul(self, a, b, *, out_dtype=None):
        """(M, K) @ (K, N) through the planned schedule for this shape."""
        key = ("gemm", a.shape, a.dtype, b.shape, b.dtype)
        hit = self._lookup(key)
        if hit is None:
            m, k = a.shape
            k2, n = b.shape
            if k != k2:
                raise ValueError(f"matmul dim mismatch {tuple(a.shape)} @ "
                                 f"{tuple(b.shape)}")
            hit = self._resolve(key, "gemm", m, k, n, 1, a.element_size())
        dec, fn = hit
        return fn(dec, a, b, out_dtype=out_dtype)

    def quant_matmul(self, a, w_q, w_scale, *, out_dtype=None):
        """(M, K) float @ pre-quantized (K, N) int8 weight storage
        (`quant.quantize_params`) through the planned `gemm_w8` kernel:
        the activations quantize per row, the stored weight never becomes
        float.  Only int8 backends register the op; callers guard on
        `Engine.int8`."""
        key = ("gemm_w8", a.shape, a.dtype, w_q.shape)
        hit = self._lookup(key)
        if hit is None:
            m, k = a.shape
            k2, n = w_q.shape
            if k != k2:
                raise ValueError(f"matmul dim mismatch {tuple(a.shape)} @ "
                                 f"{tuple(w_q.shape)}")
            hit = self._resolve(key, "gemm_w8", m, k, n, 1, a.element_size())
        dec, fn = hit
        return fn(dec, a, w_q, w_scale, out_dtype=out_dtype)

    def sparse_matmul(self, a, st, *, out_dtype=None):
        """(M, K) float @ N:M structured-sparse weight storage
        (`sparse.prune_params`) through the planned `gemm_sparse` kernel:
        the compressed values and indices never become a dense weight in
        device memory.  The request is planned at the storage's density
        N/M, so it never shares a decision with a dense GEMM of the same
        shape; sparse x int8 storage (int8 values and per-column scales)
        keys at in_bytes = 1 and carries the scale's presence in its memo
        key, so it never shares a decision with float sparse storage.
        Only sparse backends register the op; callers guard on
        `Engine.sparse`."""
        v, i, scale = st.values, st.indices, st.scale
        key = ("gemm_sparse", a.shape, a.dtype, v.shape, v.dtype,
               None if scale is None else scale.shape, st.n, st.m)
        hit = self._lookup(key)
        if hit is None:
            m, k = a.shape
            if k != st.k_dense:
                raise ValueError(f"sparse matmul dim mismatch "
                                 f"{tuple(a.shape)} @ {st!r}")
            hit = self._resolve(key, "gemm_sparse", m, k, v.shape[-1], 1,
                                a.element_size(), density=st.n / st.m,
                                in_bytes=1 if st.quantized else None)
        dec, fn = hit
        return fn(dec, a, v, i, scale, n_keep=st.n, m_group=st.m,
                  out_dtype=out_dtype)

    def grouped_matmul(self, x, w, *, out_dtype=None):
        """x (E, C, D) @ w (E, D, F) -> (E, C, F), per expert."""
        key = ("grouped_gemm", x.shape, x.dtype, w.shape, w.dtype)
        hit = self._lookup(key)
        if hit is None:
            e, c, d = x.shape
            e2, d2, f = w.shape
            if (e, d) != (e2, d2):
                raise ValueError(f"grouped dim mismatch {tuple(x.shape)} @ "
                                 f"{tuple(w.shape)}")
            hit = self._resolve(key, "grouped_gemm", c, d, f, e,
                                x.element_size())
        dec, fn = hit
        return fn(dec, x, w, out_dtype=out_dtype)

    def attention(self, q, k, v, *, causal: bool = True, window: int = 0):
        """q (B, H, Sq, D); k/v (B, H, Sk, D) (GQA heads pre-expanded)."""
        key = ("attention", q.shape, q.dtype, k.shape, k.dtype, causal, window)
        hit = self._lookup(key)
        if hit is None:
            b, h, sq, d = q.shape
            hit = self._resolve(key, "attention", sq, d, k.shape[2], b * h,
                                q.element_size())
        dec, fn = hit
        return fn(dec, q, k, v, causal=causal, window=window)

    def paged_attention(self, q, k_pages, v_pages, block_tables, kv_len, *,
                        k_scale=None, v_scale=None):
        """Paged decode attention: q (B, 1, H, D) over pools (P, page, KV,
        D) addressed through `block_tables` (B, n_bt); int8 pools pass
        their per-row scale pools alongside.  Keyed like the runtime shape
        it is: n = the page span the table can address (n_bt * page),
        groups = B * H; the pools' dtype is in the key, so int8 pools plan
        apart from float pools, and the request's width is q's (1 on an
        int8 backend), as in the JAX engine."""
        key = ("paged_attention", q.shape, q.dtype, k_pages.shape,
               k_pages.dtype, block_tables.shape)
        hit = self._lookup(key)
        if hit is None:
            b, sq, h, d = q.shape
            span = block_tables.shape[1] * k_pages.shape[1]
            hit = self._resolve(key, "paged_attention", sq, d, span, b * h,
                                q.element_size())
        dec, fn = hit
        return fn(dec, q, k_pages, v_pages, block_tables, kv_len,
                  k_scale=k_scale, v_scale=v_scale)


def active_engine() -> Engine | None:
    """The innermost `use_engine` engine, or None (plain `@` path)."""
    return _STACK[-1] if _STACK else None


@contextlib.contextmanager
def use_engine(engine: Engine | None = None, *, backend: str | None = None,
               cost_model=None, plan: ExecutionPlan | None = None):
    """Route every `models.layers.dense` matmul in scope through an
    engine.  Pass an existing `Engine` to share its plan across
    contexts, or kwargs to build a scoped one."""
    if engine is None:
        engine = Engine(cost_model, backend=backend, plan=plan)
    elif backend is not None or cost_model is not None or plan is not None:
        raise ValueError("pass either an engine or engine kwargs, not both")
    _STACK.append(engine)
    try:
        yield engine
    finally:
        _STACK.pop()

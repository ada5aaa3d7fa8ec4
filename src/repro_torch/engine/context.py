"""The Engine: decide (cost model + plan cache) then execute (registry),
the port of `repro/engine/context.py`.

Every `models.layers.dense` matmul (and, on the paged layout, every
decode attention; under sorted MoE dispatch, every expert matmul) inside
a `use_engine` context routes through the engine:

    with use_engine(backend="hopper") as eng:
        logits, _ = transformer.forward(params, cfg, tokens)
    eng.plan.stats

    plan = plan_arch(cfg, decode_batch=8, admit_widths=(16, 32))
    plan.save("plan.json")          # ServeConfig(plan_path=) warm start

    with use_engine(Engine(AnalyticalCostModel())):   # the paper's ASIC,
        ...                                           # on the simulator

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

from .cost import CostModel, HopperModel
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
    """One (cost model, backend, plan, registry) posture.  `backend=None`
    resolves to the cost model's `default_backend` if it has one (the
    ASIC plane's "simulator"), else "hopper": the kernel on CUDA tensors,
    its plain version on CPU tensors."""

    def __init__(self, cost_model: CostModel | None = None, *,
                 backend: str | None = None,
                 plan: ExecutionPlan | None = None,
                 registry: KernelRegistry | None = None):
        self.cost_model = cost_model if cost_model is not None else HopperModel()
        self.backend = (backend
                        or getattr(self.cost_model, "default_backend", None)
                        or "hopper")
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

    def _rebind(self, request: KernelRequest,
                decision: KernelDecision) -> KernelDecision:
        """Execute a decision (possibly from a warm-start plan recorded for
        another backend) on this engine's backend.  ASIC-plane schedules
        (tile dims on no kernel's menu) only execute on the simulator
        backend: fail with intent, whether the decision came from a
        warm-start plan or a fresh cost-model search."""
        if decision.backend == self.backend:
            return decision
        if "shape_rows" in dict(decision.meta) and self.backend != "simulator":
            raise ValueError(
                f"decision for {request.key()} was produced by an ASIC "
                f"cost model ({decision.cost_model!r}); its tile dims are "
                f"not on the Hopper kernels' menus — re-plan with a Hopper "
                f"cost model for backend {self.backend!r}")
        return dataclasses.replace(decision, backend=self.backend)

    def decide(self, request: KernelRequest) -> KernelDecision:
        """Plan-cache lookup, cost-model search on miss."""
        hit = self.plan.lookup(request)
        if hit is not None:
            rebound = self._rebind(request, hit)
            if rebound is not hit:
                # a warm-start plan recorded for another backend: keep the
                # schedule, execute on this engine's backend
                self.plan.add(request, rebound)
            return rebound
        decision = self._rebind(request, self.cost_model.decide(request))
        self.plan.add(request, decision)
        return decision

    def plan_gemms(self, gemms, *, in_bytes: int = 2,
                   out_bytes: int | None = None) -> "Engine":
        """Warm the plan from a GEMM trace (`core.analytical_model.GEMM`
        or (m, k, n) tuples); repeated shapes dedupe through the cache.
        `in_bytes` must match the serving dtype (2 = bf16, 4 = f32) or
        the runtime requests will miss the warm decisions."""
        out_bytes = out_bytes if out_bytes is not None else in_bytes
        for g in gemms:
            m, k, n = (g.M, g.K, g.N) if hasattr(g, "M") else g
            name = getattr(g, "name", "")
            self.decide(KernelRequest("gemm", m, k, n, in_bytes=in_bytes,
                                      out_bytes=out_bytes, name=name))
        return self

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
               cost_model: CostModel | None = None,
               plan: ExecutionPlan | None = None):
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


_DEFAULT: Engine | None = None


def default_engine() -> Engine:
    """Process-wide engine backing the module-level `matmul` when no
    `use_engine` context is active."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = Engine()
    return _DEFAULT


def matmul(a, b, *, out_dtype=None):
    """Module-level sugar: active engine if any, else the default one."""
    eng = active_engine() or default_engine()
    return eng.matmul(a, b, out_dtype=out_dtype)


# ---------------------------------------------------------------------------
# Ahead-of-time planning over a model's GEMM trace
# ---------------------------------------------------------------------------


def decode_requests(cfg, *, batch: int, dtype_bytes: int = 2,
                    seq: int = 1, quantized_weights: bool = False,
                    sparse_weights: bool = False, density: float = 0.5,
                    out_bytes: int | None = None, paged_pages: int = 0,
                    page_size: int = 0) -> tuple[KernelRequest, ...]:
    """The exact engine requests one `models.transformer.decode_step`
    issues at slot-pool size `batch` (M = batch: one token per slot).

    Unlike `core.workloads.arch_gemms` — the mapper's fused *search*
    view of a prefill pass — these mirror the runtime
    `models.layers.dense` / `models.moe` expert calls per projection, so
    a warm-started serving plan turns first-pass decode planning into
    pure cache lookups (the continuous-batching scheduler's decode shapes
    never change, so this one set covers every step it ever takes).  SSM
    in/out projections and the lm head are raw matmuls (not
    engine-routed) and do not appear.

    `seq > 1` instead describes one ragged ADMIT prefill at that padded
    width (M = batch * seq) — the scheduler's other fixed call shape.

    `quantized_weights=True` mirrors a `quant.quantize_params` server:
    the dense projections dispatch as `gemm_w8` (MoE expert stacks stay
    float grouped GEMMs — quantize_params skips them).
    `sparse_weights=True` mirrors a `sparse.prune_params` server the
    same way: dense projections dispatch as `gemm_sparse` at `density`
    (N/M of the pruning spec; grouped GEMMs stay dense — prune_params
    skips expert stacks too), and combined with `quantized_weights=True`
    the storage is sparse x int8, which the runtime keys at in_bytes=1.
    `out_bytes` (default: `dtype_bytes`) is the OUTPUT width — on an
    int8 posture pass dtype_bytes=1, out_bytes=<compute width>,
    matching how the runtime keys its requests (`Engine._resolve`)."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim_
    nh, nkv = cfg.n_heads, cfg.n_kv
    tokens = batch * seq
    out_b = out_bytes if out_bytes is not None else dtype_bytes
    dense_in, dense_density = dtype_bytes, 1.0
    if sparse_weights:
        dense_op, dense_density = "gemm_sparse", density
        if quantized_weights:
            dense_in = 1  # sparse x int8: values move at one byte
    elif quantized_weights:
        dense_op = "gemm_w8"
    else:
        dense_op = "gemm"
    reqs: list[KernelRequest] = []

    def gemm(m, k, n, name):
        reqs.append(KernelRequest(dense_op, m, k, n, in_bytes=dense_in,
                                  out_bytes=out_b, density=dense_density,
                                  name=name))

    def mlp_reqs(prefix):
        if cfg.moe is not None:
            moe = cfg.moe
            rows = batch * moe.capacity(seq)  # the expert stack (E, B x C, D)
            for m, k, n, nm in ((rows, d, f, "expert_up"),
                                (rows, f, d, "expert_down")):
                reqs.append(KernelRequest(
                    "grouped_gemm", m, k, n, groups=moe.n_experts,
                    in_bytes=dtype_bytes, out_bytes=out_b,
                    name=f"{prefix}/{nm}"))
        else:
            gemm(tokens, d, f, f"{prefix}/ffn_up")  # wi and wg share a shape
            gemm(tokens, f, d, f"{prefix}/ffn_down")

    for kind in sorted(set(cfg.layer_pattern)):
        if kind in ("attn", "local"):
            gemm(tokens, d, nh * hd, f"{kind}/wq")
            gemm(tokens, d, nkv * hd, f"{kind}/wk")  # wv is the same shape
            gemm(tokens, nh * hd, d, f"{kind}/wo")
            mlp_reqs(kind)
            if kind == "attn" and paged_pages and page_size and seq == 1:
                # paged decode gather-attention: n = the page span one
                # block-table row can address — exactly how the runtime
                # Engine.paged_attention keys its request
                reqs.append(KernelRequest(
                    "paged_attention", seq, hd, paged_pages * page_size,
                    groups=batch * nh, in_bytes=dtype_bytes,
                    out_bytes=out_b, name="attn/paged"))
        elif kind == "rglru":
            w = cfg.rglru_width or d
            gemm(tokens, d, w, "rglru/lin_x")  # lin_y is the same shape
            gemm(tokens, w, w, "rglru/gates")  # w_a and w_x
            gemm(tokens, w, d, "rglru/lin_out")
            mlp_reqs("rglru")
        # "ssm": no engine-routed matmuls in the decode path
    return tuple(reqs)


def plan_arch(cfg, *, seq_len: int | None = None, batch: int = 1,
              cost_model: CostModel | None = None,
              backend: str | None = None,
              dtype_bytes: int = 2,
              decode_batch: int | None = None,
              admit_widths: tuple[int, ...] = (),
              quantized_weights: bool = False,
              sparse_weights: bool = False, sparse_density: float = 0.5,
              paged_pages: int = 0, page_size: int = 0,
              verify_k: int = 0, prefill_chunk: int = 0) -> ExecutionPlan:
    """Plan every GEMM of one `models.config.ArchConfig` prefill pass via
    the `core.workloads.arch_gemms` lowering and return the warm
    `ExecutionPlan` (save it for serve warm-start: `ServeConfig(
    plan_path=)`, the launcher's `--plan`).  `dtype_bytes` is the serving
    compute dtype width (2 = bf16 default, 4 = f32); on an int8 `backend`
    the requests' INPUT width is forced to 1 (runtime requests there key
    at the quantized width, whatever float dtype the tensors carry) while
    outputs keep the compute width — the int8 kernels rescale to float
    results.
    `decode_batch` additionally plans the fixed decode-step shapes for
    a slot pool of that size (see `decode_requests`) so a continuous-
    batching server's decode trace re-plans nothing; `admit_widths`
    does the same for its ragged-prefill admit widths (the scheduler's
    `prefill_bucket` multiples).  `quantized_weights` plans the decode/
    admit dense projections as `gemm_w8` (a `quant.quantize_params`
    server dispatches those instead of `gemm`); `sparse_weights` plans
    them as `gemm_sparse` at `sparse_density` (a `sparse.prune_params`
    server — both flags together describe sparse x int8 storage, keyed
    at in_bytes=1 like the runtime does).  `paged_pages` /
    `page_size` (a `cache_layout="paged"` server: slot_pages and the
    page size) additionally plan the paged decode gather-attention
    shape, so the paged scheduler's steady state also re-plans
    nothing.  `verify_k` (a `speculate_k=k` server) adds the k+1-wide
    speculative verify width — the only extra decode shape the
    speculative tick introduces (the draft's propose steps are the
    width-1 shapes, its prefill the admit widths; the paged verify
    bypasses the engine's paged_attention op entirely).  `prefill_chunk`
    (a `ServeConfig.prefill_chunk` server) adds the chunk width — every
    chunked-ingestion call is exactly that wide, so it is the ONE extra
    shape chunking introduces; the scheduler aligns the chunk to
    `prefill_bucket`, so when `admit_widths` covers the bucket multiples
    the chunk width is already planned and this kwarg merely makes the
    posture explicit.  The plan records the resolved backend."""
    from ..core.workloads import ARCH_TRACE_SEQ, arch_gemms

    in_bytes = backend_in_bytes(backend, dtype_bytes)
    eng = Engine(cost_model, backend=backend)
    eng.plan.backend = eng.backend
    eng.plan_gemms(arch_gemms(cfg, seq_len=seq_len or ARCH_TRACE_SEQ,
                              batch=batch), in_bytes=in_bytes,
                   out_bytes=dtype_bytes)
    if decode_batch:
        widths = (1,) + tuple(admit_widths)
        if prefill_chunk and prefill_chunk not in widths:
            widths = widths + (prefill_chunk,)
        if verify_k:
            widths = widths + (verify_k + 1,)
        for width in widths:
            for req in decode_requests(cfg, batch=decode_batch,
                                       dtype_bytes=in_bytes, seq=width,
                                       quantized_weights=quantized_weights,
                                       sparse_weights=sparse_weights,
                                       density=sparse_density,
                                       out_bytes=dtype_bytes,
                                       paged_pages=paged_pages,
                                       page_size=page_size):
                eng.decide(req)
    return eng.plan

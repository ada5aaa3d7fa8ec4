"""Serving: batched prefill + greedy or sampled decode over the KV cache
(the port of `repro/serve_lib/serve.py`).

`generate` serves one batch end to end over the contiguous cache; the
paged layout (`cache_layout="paged"`) needs the block-table plane that
the continuous-batching `scheduler.Scheduler` owns.  Kernel dispatch goes through the
port's engine when `ServeConfig.kernel_backend` is set ("hopper" for the
hand-written kernels, "torch-ref" for their plain versions); `None`
means plain `@`, as the JAX package leaves the matmuls to XLA.
`ServeConfig(quantize=True)` upgrades the backend to its int8 sibling
("hopper-int8", "torch-ref-int8") and expects `quant.quantize_params`
weights: every dense matmul then runs int8 x int8 -> int32.
`cache_dtype="int8"` stores the KV cache through the per-row int8 codec
(rows and their f32 scales; DESIGN.md §7) on either layout.  The two are
orthogonal, and the launcher's `--quantize` sets both.
`ServeConfig(sparsity="N:M")` upgrades the backend to its sparse sibling
("hopper-sparse", "torch-ref-sparse") and expects `sparse.prune_params`
weights: every pruned matmul then runs on the N:M sparse GEMM.  With
`quantize=True` too (sparse x int8, `prune_params(..., quantize=True)`
weights: int8 values and per-column scales) the backend upgrades to the
int8 sibling and then to the sparse one, as in the JAX package, and the
pruned matmuls run on that GEMM's int8-value variant.
`warm_start_engine` loads a saved `ExecutionPlan` so the first requests
re-plan nothing.

Entry points run on the card unless the caller asks for the CPU:
`ServeConfig.device` defaults to "cuda", and without a CUDA device that
raises rather than falling back.
"""

from __future__ import annotations

import contextlib
import dataclasses
import warnings

import torch

from ..dist import sharding as shd
from ..dist.reshard import reshard
from ..engine import (BACKENDS, Engine, ExecutionPlan, backend_in_bytes,
                      int8_sibling, sparse_sibling, use_engine)
from ..models import transformer as T
from ..models.config import ArchConfig
from ..sparse.nm import parse_sparsity

#: cache dtypes `models.transformer.init_cache` can represent.  int8
#: selects the quantized KV codec (rows + per-row scales, DESIGN.md §7).
SUPPORTED_CACHE_DTYPES = ("float32", "bfloat16", "float16", "int8")


def _dtype(value) -> torch.dtype:
    if isinstance(value, torch.dtype):
        return value
    dt = getattr(torch, str(value), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"{value!r} is not a torch dtype")
    return dt


def validate_cache_dtype(cache_dtype, cfg: ArchConfig | None = None
                         ) -> torch.dtype:
    """The cache-dtype validator (`ServeConfig` and `init_cache` both
    route through it): normalises to a torch dtype, rejects dtypes the
    cache cannot represent, and, given the arch, rejects int8 where it
    would quantize nothing (int8 SSM / RG-LRU state is unsupported)."""
    try:
        dt = _dtype(cache_dtype)
    except ValueError as e:
        raise ValueError(f"cache_dtype {cache_dtype!r} is not a dtype: {e}"
                         ) from None
    name = str(dt).removeprefix("torch.")
    if name not in SUPPORTED_CACHE_DTYPES:
        raise ValueError(
            f"cache_dtype {name!r} is not a supported cache dtype "
            f"(supported: {', '.join(SUPPORTED_CACHE_DTYPES)}; 'int8' "
            f"selects the quantized KV codec — DESIGN.md §7)")
    if cfg is not None and dt == torch.int8:
        if not set(cfg.layer_pattern) & {"attn", "local"}:
            raise ValueError(
                f"cache_dtype='int8' quantizes attention/sliding-window "
                f"KV rows only, but this arch's layer pattern "
                f"{cfg.layer_pattern} has no such layers — int8 "
                f"SSM/RG-LRU state is unsupported (recurrent state is "
                f"read-modify-write every step and stays bf16); use "
                f"cache_dtype='bfloat16' for this arch")
    return dt


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_seq: int
    batch: int
    compute_dtype: object = torch.bfloat16
    cache_dtype: object = torch.bfloat16
    # engine backend for every model matmul (None -> plain `@`).
    kernel_backend: str | None = None
    # optional ExecutionPlan JSON to warm-start the decision cache from.
    plan_path: str | None = None
    # int8 matmul plane: route every engine matmul through an int8 backend
    # (upgrading `kernel_backend` to its int8 sibling) and expect
    # `quant.quantize_params` weights.  Orthogonal to cache_dtype="int8"
    # (the KV codec): each serves without the other, and the launcher's
    # --quantize sets both.
    quantize: bool = False
    # structured-sparsity plane: "N:M" (e.g. "2:4") upgrades
    # `kernel_backend` to its sparse sibling and expects
    # `sparse.prune_params` weights.  Composes with quantize=True (sparse
    # x int8: `prune_params(..., quantize=True)` storage, which the sparse
    # backends dispatch; the KV codec stays cache_dtype's).
    sparsity: str | None = None
    # where the cache lives and the model runs ("cuda" unless the caller
    # asks for the CPU).
    device: str = "cuda"
    # KV layout: "paged" moves the KV into a pool of `n_pages` pages of
    # `page_size` rows behind per-slot block tables (Scheduler only;
    # enables cross-request prefix sharing).  "contiguous" is the per-slot
    # layout and the parity oracle.
    cache_layout: str = "contiguous"
    page_size: int = 16
    # pool size in pages; None -> batch * slot_pages + 2 * slot_pages
    n_pages: int | None = None
    # speculative decoding (Scheduler only): k > 0 makes every tick
    # propose k draft tokens and verify them in one (k + 1)-wide pass;
    # greedy only, and the tokens are those of plain greedy decode.
    speculate_k: int = 0
    # the draft: None / "self" shares the target's params, "self-int8"
    # drafts with their `quantize_params` copy; `Scheduler(draft_params=,
    # draft_cfg=)` passes another model.
    draft: str | None = None
    # chunked prefill (Scheduler only): a prompt whose un-resident part is
    # longer than this streams into its slot one chunk of this width a
    # tick, beside the pool's decode; None admits every prompt in one
    # prefill.  On the paged layout a multiple of page_size.
    prefill_chunk: int | None = None

    def __post_init__(self):
        compute = _dtype(self.compute_dtype)
        if not compute.is_floating_point:
            raise ValueError(f"compute_dtype must be floating ({compute} given)")
        cache = validate_cache_dtype(self.cache_dtype)
        if self.quantize:
            object.__setattr__(self, "kernel_backend",
                               int8_sibling(self.kernel_backend))
        if self.sparsity is not None:
            parse_sparsity(self.sparsity)  # validate "N:M" early
            # after the int8 upgrade, as in the JAX package: the int8
            # backend names upgrade to the sparse ones too (sparse x int8
            # stores int8 values inside the SparseTensor)
            object.__setattr__(self, "kernel_backend",
                               sparse_sibling(self.kernel_backend))
        if self.kernel_backend not in (None, *BACKENDS):
            raise ValueError(f"kernel_backend {self.kernel_backend!r} is not "
                             f"one of {BACKENDS} (or None)")
        object.__setattr__(self, "compute_dtype", compute)
        object.__setattr__(self, "cache_dtype", cache)
        object.__setattr__(self, "device", str(torch.device(self.device)))
        if self.cache_layout not in ("contiguous", "paged"):
            raise ValueError(f"cache_layout {self.cache_layout!r} is not one "
                             f"of ('contiguous', 'paged')")
        if self.cache_layout == "paged":
            if self.page_size < 1:
                raise ValueError(f"page_size must be >= 1: {self.page_size}")
            if self.n_pages is not None and self.n_pages < self.slot_pages:
                raise ValueError(
                    f"n_pages={self.n_pages} cannot hold even one full slot "
                    f"({self.slot_pages} pages for max_seq={self.max_seq} at "
                    f"page_size={self.page_size})")
        if self.prefill_chunk is not None:
            if self.prefill_chunk < 1:
                raise ValueError(
                    f"prefill_chunk must be >= 1: {self.prefill_chunk}")
            if self.prefill_chunk > self.max_seq:
                raise ValueError(
                    f"prefill_chunk {self.prefill_chunk} exceeds max_seq "
                    f"{self.max_seq} — a chunk wider than the cache can "
                    f"never fill")
            if (self.cache_layout == "paged"
                    and self.prefill_chunk % self.page_size):
                raise ValueError(
                    f"prefill_chunk {self.prefill_chunk} is not a multiple "
                    f"of page_size {self.page_size}: paged chunk "
                    f"continuation gathers whole resident pages, so every "
                    f"chunk boundary must be a page boundary")
        if self.speculate_k < 0:
            raise ValueError(f"speculate_k must be >= 0: {self.speculate_k}")
        if self.draft is not None:
            if self.speculate_k == 0:
                raise ValueError("draft= needs speculate_k > 0")
            if self.draft not in ("self", "self-int8"):
                raise ValueError(
                    f"draft {self.draft!r} is not one of ('self', "
                    f"'self-int8'); pass an explicit small arch via "
                    f"Scheduler(draft_params=, draft_cfg=)")

    @property
    def slot_pages(self) -> int:
        """Block-table width: pages one slot needs for max_seq rows."""
        return -(-self.max_seq // self.page_size)

    @property
    def resolved_n_pages(self) -> int:
        """Pool size: explicit `n_pages`, or enough for every slot's worst
        case plus two slots' worth of headroom for retained prefix
        pages."""
        if self.n_pages is not None:
            return self.n_pages
        return self.batch * self.slot_pages + 2 * self.slot_pages


def resolve_device(scfg: ServeConfig) -> torch.device:
    """The serving device; raises when it is a CUDA device and there is
    none (no silent fallback to the CPU)."""
    dev = torch.device(scfg.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"ServeConfig.device={scfg.device!r} but no CUDA device is "
            f"available; pass device='cpu' to serve on the CPU")
    return dev


# One engine per ServeConfig (frozen, hashable, dtypes normalised):
# repeated generate() calls and Schedulers built without `engine=` share
# one decision memo instead of planning every shape again.
_ENGINES: dict[ServeConfig, Engine] = {}


def warm_start_engine(scfg: ServeConfig) -> Engine | None:
    """The serving engine, built once per `ServeConfig`: `kernel_backend`
    selects the registry backend, `plan_path` (an `ExecutionPlan.save`
    artifact) pre-fills the decision cache so first-call planning drops
    to lookups."""
    if scfg.kernel_backend is None:
        return None
    cached = _ENGINES.get(scfg)
    if cached is not None:
        return cached
    plan = None
    if scfg.plan_path:
        plan = ExecutionPlan.load(scfg.plan_path)
        # on an int8 backend every request keys at width 1 whatever the
        # compute dtype (engine.backend_in_bytes)
        want = backend_in_bytes(scfg.kernel_backend,
                                scfg.compute_dtype.itemsize)
        if len(plan) and not any(req.in_bytes == want for req, _ in plan):
            warnings.warn(
                f"warm-start plan {scfg.plan_path!r} holds no decisions for "
                f"in_bytes={want} (compute_dtype={scfg.compute_dtype}, "
                f"backend={scfg.kernel_backend!r}); every lookup will miss "
                f"— re-plan with plan_arch(dtype_bytes={want})",
                UserWarning, stacklevel=2)
    eng = _ENGINES[scfg] = Engine(backend=scfg.kernel_backend, plan=plan)
    return eng


def init_cache(cfg: ArchConfig, scfg: ServeConfig) -> dict:
    # the arch-aware half of the validator: ServeConfig cannot see the
    # layer pattern
    validate_cache_dtype(scfg.cache_dtype, cfg)
    paged = scfg.cache_layout == "paged"
    spec = T.CacheSpec(scfg.max_seq, scfg.batch,
                       page_size=scfg.page_size if paged else None,
                       n_pages=scfg.resolved_n_pages if paged else None)
    return T.init_cache(cfg, spec, dtype=scfg.cache_dtype,
                        device=resolve_device(scfg))


def serving_mesh(what: str):
    """The active mesh, if any, for `what` to serve on: a mesh of more
    than one rank is refused, since sharded serving needs tensor-parallel
    compute, which the port does not have yet (ROADMAP queue 1, item
    9c)."""
    mesh = shd.active_mesh()
    if mesh is not None and mesh.size() > 1:
        raise NotImplementedError(
            f"{what} on a mesh of {mesh.size()} ranks "
            f"{dict(shd.mesh_sizes(mesh))}: sharded serving needs "
            f"tensor-parallel compute on the 'model' axis, not ported yet "
            f"(ROADMAP queue 1, item 9c); serve on a one-rank mesh")
    return mesh


def sample(logits: torch.Tensor, temperature: float,
           generator: torch.Generator | None = None) -> torch.Tensor:
    """(..., V) logits -> (...,) int64 tokens: the argmax at temperature 0,
    else a categorical draw from softmax(logits / temperature) with
    `generator`, which lives on the logits' device.  torch has no JAX
    PRNG: a sampled token follows the same distribution as the JAX
    package's, not its bits."""
    if temperature <= 0.0:
        return logits.argmax(dim=-1)
    probs = torch.softmax(logits.double() / temperature, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    return torch.multinomial(flat, 1, generator=generator).reshape(
        probs.shape[:-1])


def generate(params, cfg: ArchConfig, scfg: ServeConfig, prompt,
             n_tokens: int, *, temperature: float = 0.0,
             key: torch.Generator | None = None, embeds=None,
             engine: Engine | None = None) -> torch.Tensor:
    """prompt (B, S_prompt) -> (B, n_tokens) greedy or sampled tokens.

    The first token comes from the prefill logits (sampled at the same
    temperature as the rest), so `n_tokens` outputs cost `n_tokens - 1`
    decode steps.  `temperature > 0` samples each token from
    softmax(logits / temperature) with `key`, a `torch.Generator` on the
    params' device.  `embeds` go to the prefill as `transformer.prefill`
    takes them (a VLM's (B, P, D) prefix; the cache then holds P +
    S_prompt + n_tokens - 1 rows).  An encoder has no decode step: it
    serves one token, from its last frame.  Runs where `params` live,
    which must be `scfg.device`.  `engine` overrides the
    `ServeConfig`-derived one (pass a shared Engine to keep one decision
    cache across calls).  `speculate_k` and `prefill_chunk` are the
    Scheduler's: the static batch ignores them, as in the JAX package."""
    if n_tokens < 1:
        raise ValueError(f"n_tokens must be >= 1, got {n_tokens}")
    if cfg.kind == "encoder" and n_tokens > 1:
        raise ValueError("encoder-only arch: no decode step")
    if scfg.cache_layout == "paged":
        raise NotImplementedError(
            "generate() serves the contiguous layout only; the paged layout "
            "needs the block-table plane the continuous-batching Scheduler "
            "owns (serve_lib.scheduler.Scheduler)")
    if temperature > 0.0 and key is None:
        raise ValueError(
            "generate(temperature>0) samples and needs a PRNG key — pass "
            "key=torch.Generator(device).manual_seed(...) (or "
            "temperature=0.0 for greedy)")
    dev = resolve_device(scfg)
    where = params["final_norm"].device
    if where.type != dev.type:
        raise ValueError(f"params live on {where} but ServeConfig.device is "
                         f"{scfg.device!r}")
    prompt = torch.as_tensor(prompt, device=where)
    if prompt.dim() != 2 or prompt.shape[0] != scfg.batch:
        raise ValueError(f"prompt {tuple(prompt.shape)} is not "
                         f"(batch={scfg.batch}, S)")
    mesh = serving_mesh("generate")
    if mesh is not None:
        # place params (the auto rule table) and cache (the cache rules),
        # as the reference does; on a one-rank mesh every placement is
        # Replicate() and the local tensors are the whole ones
        if mesh.device_type != where.type:
            raise ValueError(f"params live on {where} but the active mesh "
                             f"is on {mesh.device_type!r}")
        params = shd.local_tree(reshard(params,
                                        shd.params_shardings(params, mesh)))
    eng = engine if engine is not None else warm_start_engine(scfg)
    scope = use_engine(eng) if eng is not None else contextlib.nullcontext()
    with scope, torch.inference_mode():
        cache = init_cache(cfg, scfg)
        if mesh is not None:
            cache = shd.local_tree(reshard(cache,
                                           shd.cache_shardings(cache, mesh)))
        logits, cache = T.prefill(params, cfg, prompt, cache, embeds=embeds,
                                  compute_dtype=scfg.compute_dtype)
        pick = lambda lg: sample(lg[:, -1], temperature, key)[:, None].to(
            torch.int32)
        tok = pick(logits)
        outs = [tok]
        for _ in range(n_tokens - 1):
            logits, cache = T.decode_step(params, cfg, cache, tok,
                                          compute_dtype=scfg.compute_dtype)
            tok = pick(logits)
            outs.append(tok)
        return torch.cat(outs, dim=1)

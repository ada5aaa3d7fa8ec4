#!/usr/bin/env python3
"""Drive the PyTorch/Hopper port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (any failed check exits non-zero; nothing falls back):
  1. card and set-up: the card's name and power limit, the torch and CUDA
     versions, the build of every kernel from the sources in this checkout
     (one nvcc per source, all started together; seconds, registers and
     spills from `-Xptxas -v`);
  2. GEMM against plain: the ReDas GEMM in each dataflow at every GEMM
     shape of the static serve (bf16) and at two shapes in f32, held to its
     plain version, with the kernel's, the plain version's and
     torch.matmul's times beside the card's bound; OS on both of its
     routes (the wgmma kernel at the bf16 shapes, with the host time of a
     call at decode M; the sync kernel at f32, at the ragged shape, and,
     through operands at a misaligned base, at the bf16 shapes whose
     decision is OS), each call's route read from the counters;
  3. attention kernels against plain: paged attention at the paged
     serve's decode shapes (8 slots, pages of 16, a 51-page table with
     holes, kv_len 0, 1, a page edge and ragged lengths; qwen2-1.5b's 12
     heads over 2 KV heads at head dim 128, and granite's 16 over 8 at 64)
     at the wrapper's cluster size and at C = 1, 2, 4, 8 (each held to the
     plain version and timed; the pick within PAGED_PICK_LIMIT of the
     fastest C in bf16; the cluster occupancy and the host's us a call)
     and flash attention on both of its routes at head dims 16, 20, 64,
     80, 128, 240 and 256, bf16 and f32, causal, window (rows without a
     live key), non-causal and ragged, Sq != Sk (each call held to the
     plain version, launched once on the route `flash_route` names, and
     repeated bit for bit), and on a misaligned base; times of kernel,
     plain version and SDPA beside the bound at (4, 12, 512, 128) and
     (2, 16, 4096, 128) causal on the wgmma route, and at (4, 12, 512,
     128) in f32 and at a misaligned base on the sync route;
     `Engine.attention` driven through the engine once;
  4. the static serve (the first slice's path): `repro_torch.launch.serve`
     serving full-width qwen2-1.5b (4 requests x 512 prompt + 16 new
     tokens, bf16, weights from a seed) on the `hopper` backend; the GEMM
     kernel must launch 7 x 28 x 16 = 3136 times, every OS call of the
     plan on the wgmma kernel.  The same entry point serving 1 token gives
     the prefill time, and device traces of the served run's `generate`
     the idle share (the prefill's trace shows `os_wgmma_kernel` and no
     `os_kernel`);
  5. the paged serve (this slice's path): the same entry point in trace
     mode, 24 requests over 8 slots through the continuous-batching
     Scheduler on the paged layout; paged-kernel launches must equal
     28 x decode ticks and GEMM launches 7 x 28 x (decode ticks + prefill
     calls), every OS call on the wgmma kernel.  A second pass through the
     same engine must plan nothing new, and a device trace of 10 decode
     ticks gives the idle share and the paged kernel's device ms;
  6. prefix sharing: 12 requests with a common 256-token prefix through
     the Scheduler, paged against contiguous;
  7. parity on the card: full-width prefill logits and one paged decode
     tick's logits of `hopper` against `torch-ref`; the smoke
     configuration in f32 giving the same tokens on the card as the plain
     versions on the CPU, static and through the Scheduler (paged and
     contiguous, with a shared prefix);
  8. the grouped kernel against plain: granite's expert GEMMs at 8 slots
     (decode (32, 32, 1024) @ (32, 1024, 512) and its wo mirror, the
     prefill of the widest bucket at C = 8 x 240, a ragged C = 8 x 20), in
     bf16 on the wgmma route (the engine's tile and every tile of the
     wgmma menu, a repeat bit for bit, the pick within GEMM_PICK_LIMIT of
     the fastest tile; the sync kernel on the same operands through its C
     entry and through the wrapper on a copy at a misaligned base; the
     host's us per call of both routes at the decode shapes) and in f32
     (the sync route); times of kernel, plain version and torch.bmm beside
     the bound;
  9. granite-moe-1b-a400m, sorted dispatch (`impl="sort"`, chosen in the
     configuration as in the JAX package), full width, through the
     Scheduler on the paged layout with POSTURE_TRACE (since PR 34;
     the paged serve's 110-tick trace before); grouped
     launches must equal 3 x 24 x (decode ticks + prefill calls), every one
     on the wgmma kernel, GEMM 4 x 24 x (ticks + calls) with every OS call
     on the wgmma kernel, paged 24 x ticks; a second pass plans nothing
     new; a device trace of 10 decode ticks (at least 0.99 of their
     grouped calls shown as `grouped_wgmma_kernel`, none as
     `grouped_os_kernel`; the ticks' device split by kernel, the paged
     kernel's ms printed);
 10. granite, default einsum dispatch, through the launcher's static mode
     (8 x (256 + 16)): the grouped kernel must launch 0 times and the GEMM
     4 x 24 x 16 times, every OS call on the wgmma kernel;
 11. granite parity: one full-width paged decode tick's logits, hopper
     against torch-ref, with the count of (token, layer) top-k sets that
     differ; the SMOKE configuration in f32 (cf 8.0 and the default cf,
     both dispatches, paged and contiguous) giving the same tokens on the
     card as the plain versions on the CPU;
 12. the int8 kernel against plain on both of its paths: qwen's dense
     shapes at M = 4, 8 (the decode path) and 2048 (tiled), 16, 17 and a
     ragged (5, 1000, 200), the int32 result bit for bit at every split of
     the decode path (M <= 16) and every tile of the tiled menu, each
     launched twice; at qwen's shapes the engine's decision timed beside
     every split (decode) or tile (tiled) of its path (the pick within
     GEMM_PICK_LIMIT of the fastest), the plain version, torch._int_mm
     (decode M padded to 32, as it takes M > 16) and the bound, and the
     host's us a decode call;
 13. qwen2-1.5b under quantize=True (int8 weights, float KV): the static
     serve through `generate` (4 x (512 + 16), "hopper-int8"; the int8
     kernel must launch 7 x 28 x 16 = 3136 times, 2940 on the decode path
     and 196 tiled, and the float GEMM 0 times; weight bytes against the
     bf16 tree; prefill logits bitwise equal to "torch-ref-int8"), then
     the paged serve's trace through the Scheduler (int8 launches 7 x 28 x
     (ticks + prefill calls), 7 x 28 x ticks decode and 7 x 28 x calls
     tiled, paged 28 x ticks, 0 new plan misses on a second pass, a device
     trace of 10 decode ticks with the int8 kernel's device ms, one tick's
     logits against "torch-ref-int8" within rel-L2 0.035), then SMOKE f32
     card tokens against the CPU's (static, Scheduler paged and
     contiguous);
 14. the int8-pool paged kernel against plain: phase 3's paged shapes
     over int8 pools (random int8 rows, per-row scales from U(1e-3,
     2e-2), the same tables and kv_len), bf16 and f32 q, at the wrapper's
     cluster size and at C = 1, 2, 4, 8 as in phase 3; times of kernel,
     plain version and a gather + dequantize + SDPA yardstick beside the
     bound (the live int8 rows and their scales);
 15. qwen2-1.5b under the launcher's --quantize (int8 weights, int8 KV,
     "hopper-int8"): the static serve (4 x (512 + 16), contiguous int8
     KV; the int8 kernel must launch 3136 times, 2940 decode and 196
     tiled, the float GEMM and the paged kernel 0 times), then the paged
     serve's trace through the Scheduler on int8 pools (paged launches 28
     x ticks, int8 7 x 28 x (ticks + prefill calls), by path as in phase
     13, float GEMM 0, 0 new plan misses on a second pass, a device trace
     of 10 decode ticks with the int8 kernel's device ms (7 x 28 x 10
     decode launches, none tiled), one tick's logits against
     "torch-ref-int8" within rel-L2 0.035, the KV pool's bytes against a
     bf16 pool's);
 16. SMOKE f32 under the full posture (and under cache_dtype="int8" with
     float weights, paged): card tokens against the CPU's, static and
     through the Scheduler, paged and contiguous, with a shared prefix;
 17. the sparse kernel against plain on both of its paths: qwen's dense
     shapes at 2:4 in bf16 (M = 4 and 8 on the split-K decode path, 2048
     on the tiled path, each at the engine's decision; times of kernel,
     plain version and torch.matmul over the weight densified ahead of
     time beside the bound, and the decode shapes' reduction alone), two
     f32 shapes, M = 1, 16 and 17 (which plans the tiled path), 1:2, 1:4,
     4:8 and 3:7 at 8 x 1536 x 1536, a ragged (5, 1003, 200) also with an
     f32 output, and an int8 index array with offsets out of range and
     repeated; at M <= 16 also split 1 and the largest split, the untimed
     cases also at every tile of the tiled menu; every configuration
     launched twice, the outputs bit for bit equal;
 18. qwen2-1.5b under the launcher's --sparsity 2:4 (float N:M weights,
     "hopper-sparse"): the static serve (4 x (512 + 16); the sparse kernel
     must launch 7 x 28 x 16 = 3136 times, 2940 of them on the decode
     path with a reduction each, and every other kernel 0 times; pruned
     weight bytes against bf16; prefill logits against
     "torch-ref-sparse" within rel-L2 and max 0.035), then the paged
     serve's trace through the Scheduler (sparse launches 7 x 28 x (ticks
     + prefill calls), by path 7 x 28 x ticks decode and 7 x 28 x calls
     tiled, paged 28 x ticks, 0 new plan misses on a second pass, a
     device trace of 10 decode ticks with the sparse kernels' device ms
     a tick, one tick's logits against "torch-ref-sparse" within rel-L2
     0.035);
 19. SMOKE f32 under sparsity="2:4": card tokens against the CPU's,
     static and through the Scheduler, paged and contiguous, with a shared
     prefix;
 20. phase 17 for the sparse kernel's int8-value variant (sparse x int8
     storage: int8 values and a per-column f32 scale): qwen's dense shapes
     at 2:4 with bf16 activations (M = 4 and 8 on the decode path at the
     engine's decision, split 1 and the largest split; 2048 on the tiled
     path at the decision and every menu tile; timed as in phase 17, the
     library yardstick over the weight densified and scaled ahead of
     time, the decode shapes' scaled reduction alone, bit for bit its
     plain version), one f32-activation shape, 1:2, 4:8 and 3:7 at 8 x
     1536 x 1536, a ragged (5, 1003, 200) with an f32 output, and a
     weight with an all-zero column (scale 1.0) and values of -127 and
     127; every configuration launched twice, the outputs bit for bit
     equal;
 21-23. phases 18-19 under the launcher's --sparsity 2:4 --quantize
     (sparse x int8 weights, int8 KV, "hopper-sparse"): the static serve
     (the int8-value variant 3136 launches, 2940 on the decode path with
     a reduction each and 196 tiled, the float variant and every other
     kernel 0; weight bytes against the float 2:4 posture's), the paged
     serve on int8 pools (the int8-value variant 7 x 28 x (ticks +
     prefill calls), the int8-pool paged kernel 28 x ticks; the KV pool's
     bytes), and SMOKE f32 parity under a float and under an int8 KV
     cache.  Every phase reads both variants' counts
     (`sparse_gemm.launches`, `int8_launches`): each serve must launch
     the other variant 0 times;
 24. qwen3-14b and gemma3-12b at full width (bf16, weights from a seed),
     each: the GEMM decisions at its layer shapes and M = 4, 8 and 2048
     (each dataflow at the model's best configuration for it, held to the
     plain version; the decision within GEMM_PICK_LIMIT of the fastest
     dataflow); the static serve through `launch.serve` (4 x (512 + 16),
     gemma3 4 x (1536 + 16), whose prompts wrap its 1024-row rings: the
     GEMM kernel 7 x layers x 16 times, every OS call on wgmma, no other
     kernel), its prefill logits against `torch-ref`; the paged serve
     through the same entry point (since PR 34, cut to make room for
     phases 33-37: qwen3 POSTURE_TRACE, 31 ticks (phase 5's 110 before);
     gemma3 1536x32*4,768x24*4,256x8*4 (1536x64*4,768x32*4,256x16*8
     before), whose ragged prompts take the ring placement): the paged kernel once an "attn" layer a tick (gemma3's 8
     global layers), the GEMM 7 x layers x (ticks + prefill calls),
     prefix sharing on pure "attn" archs only, the cache's pool and ring
     bytes and the peak memory, a second pass planning nothing new, 10
     traced ticks (idle share, device ms by kernel) and one tick's logits
     against `torch-ref`.  Phase 3 holds the paged kernel at their decode
     shapes too (qwen3's G = 5, gemma3's D = 240);
 25. mistral-large-123b at its published widths with 4 of its 88 layers:
     each GEMM decision beside the fastest dataflow (not gated), and a
     static serve through `generate` (4 x (512 + 16); 7 x 4 x 16 GEMM
     launches);
 26. the new archs' SMOKE configurations in f32 (qwen3-14b,
     mistral-large-123b, gemma3-12b, also under --quantize, mixtral-8x7b
     under both MoE dispatches): card tokens against the CPU's plain run,
     static and through the Scheduler, paged and contiguous (a paged
     ServeConfig builds the paged plane only on an arch with "attn"
     layers: mixtral runs its contiguous path);
 27. granite-moe-1b-a400m under --quantize: the launcher's static serve
     (einsum dispatch; int8 launches by path), then a short paged trace
     through the Scheduler with the sorted dispatch (its int8 grouped op
     loops the int8 GEMM over the 32 float expert stacks) and with
     einsum, each with its ms a tick and int8 launches by path;
 33. qwen2-1.5b at full width, speculative (`--speculate 4 --draft self`,
     paged, POSTURE_TRACE) through the Scheduler, tick by tick: the
     paged plane's invariants after every tick, each tick's tokens the
     head of its verify pass's argmax, GEMM launches exactly 7 x 28 x
     (target prefill calls + draft prefill calls + spec ticks x (k + 2)),
     every OS call on wgmma, the paged kernel 0 times (the (k + 1)-wide
     verify takes the plain gather; the draft's cache is contiguous), a
     second pass planning nothing new; one verify pass's (8, 5, V)
     logits against `torch-ref`; the acceptance share, tokens/s and ms a
     tick beside the non-speculative serve's on the same trace; the same
     trace with `--draft self-int8` (its weights dequantized every call
     under the float engine, as the reference does), timed;
 34. qwen2-1.5b under `--quantize --speculate 4` (SPEC_QUANT_TRACE): the
     int8 kernel's launches by path (the draft's proposals at M = 8 on
     the decode path, the verify, the replay and the prefills tiled), no
     other kernel, one verify pass's logits against `torch-ref-int8`;
 35. qwen2-1.5b at full width, chunked (`--prefill-chunk 256`, paged,
     CHUNK_TRACE): a 2048-token prompt's last chunk's logits against its
     one-call prefill's, the serve's prefill calls, widths and tokens, its
     decode tokens emitted on ticks where a slot was ingesting, GEMM 7 x
     28 x (ticks + calls), paged 28 x ticks, a second pass planning
     nothing new; then the trace through `serve_async`, its completions
     equal to `run()`'s;
 36. recurrentgemma-2b at full width (contiguous, window 2048):
     `--prefill-chunk 512` (2560-token prompts: the rings wrap across the
     chunks) and `--speculate 4` (the ring undo and the recurrent stash),
     each with exact launch counts (a speculative pass steps the RG-LRU
     recurrence token by token at M = 8, as the JAX package does) and
     logits held by PR 33's rule against the f32 model;
 37. SMOKE in f32: speculation (self, disagreeing and self-int8 drafts)
     and chunking on the four cache kinds, granite sorted speculation,
     qwen chunked paged and under an int8 cache, gemma3 chunked paged,
     chunking with speculation: the card's tokens equal the CPU's per
     uid, and the card's speculative or chunked tokens its plain serve's;
     `generate(temperature=0.7, key=)` repeats its tokens for the seed;
 38. the accelerator plane (the paper's own contribution): the mapper's
     pick for the quickstart request (TinyYOLO-V2 conv2, 43264 x 144 @
     144 x 32) on ReDas and on the fixed TPU-like array, with the modeled
     speedup and PE utilization; `map_model` over the paper's eight
     workloads on both, the modeled speedup and EDP ratio of each and
     their geometric means beside the paper's 4.6x and 8.3x, and the
     host seconds of the mapping (all of these the analytical model's
     modeled cycles for the paper's 128 x 128 array, not times of the
     card); the cycle-level simulator at OS, WS and IS and batched on
     CUDA tensors, within 1e-6 of the same calls on CPU tensors with
     equal cycles; `Engine(AnalyticalCostModel()).matmul` of the whole
     conv2 GEMM on the card (the "simulator" backend) within rtol/atol
     1e-4 of float64, its wall ms, device-busy ms and modeled cycles;
     qwen2-1.5b SMOKE's f32 forward with every engine GEMM on the
     simulator, its logits within rtol/atol 1e-4 of `torch-ref`'s;
 39. warm start at full width: qwen2-1.5b in bf16 and under --quantize,
     `plan_arch` for the paged Scheduler posture of WARM_TRACE (8 slots,
     pages of 16, every admit width of the 16-row bucket) with its host
     seconds, saved and loaded through `ServeConfig(plan_path=)`: the
     warm serve adds no plan miss and gives the cold serve's tokens per
     uid; the first tick's host ms of serves in turns cold, warm, cold,
     warm (the first also pays first-use costs); an AnalyticalCostModel
     plan loaded into a hopper engine refused with the ASIC message;
 40. the kernels' VJPs (each engine op's `torch.autograd.Function`) on
     the kernel backends against autograd of the plain versions on the
     same CUDA operands, rel-L2 per row within 1e-2 (bf16) and 1e-4
     (f32): row 1's at qwen2-1.5b's four layer shapes at M = 2048 (bf16;
     two of them in f32), row 5's at granite's (32, 640, 1024) @ (32,
     1024, 512), the int8 (and w8) and both sparse GEMMs' at qwen's
     (2048, 1536) @ (1536, 8960), the pruned positions of dV exactly 0;
     the backward's launches by route; the flash scan's Function against
     autograd of its plain loop in f32 within 1e-5, both runs' peak
     memory;
 41. training qwen2-1.5b at full width and depth through
     `repro_torch.launch.train` (8 x 512 tokens a step in 2 microbatches,
     bf16, `hopper`), 8 steps: every step's ce and grad_norm finite;
     every engine GEMM (forward, recompute, and the two backward GEMMs of
     each) on the hand-written kernels by the route counters (2 x 2 x 196
     engine calls a step, as many launches again in the backward, all OS
     on wgmma); ms a step, tokens/s, peak memory; a traced step's idle
     share and device ms by kernel; one microbatch's gradients on
     `hopper` no farther from the f32 model's than F32_ANCHOR_LIMIT x the
     plain bf16 ones; then the launcher's checkpoint restart at
     RESTART_LAYERS of the 28 layers (a full-depth checkpoint is 28.4 GB,
     and the restart writes three): 6
     steps with a checkpoint every 3, `--resume auto` to 8 from step 6,
     its steps 6-7 within 1e-5 of an uninterrupted run's;
 42. one step each of granite-moe-1b-a400m sorted (its experts on row
     5's Function), qwen2-1.5b under `quantize=True` (int8 forward on row
     6, float backward on row 1) and under `sparsity="2:4"` (dense
     weights on the sparse namespace), launches by route, each with the
     gradients' f32 anchor rule;
 43. SMOKE in f32: one step of every arch on `hopper`, card against CPU
     within rtol/atol 2e-4; qwen2 SMOKE's loss falling by more than 0.3
     over 20 steps at lr 1e-2 on the card;
 44. the kernels line, then the result line.

Every detail also goes to runs/chip_smoke.json.  Exits non-zero
without a CUDA device, and outside a checkout of the repository.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import functools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import ARCH_NAMES, get_config  # noqa: E402
from repro_torch.core import (SPECS, WORKLOADS, ReDasMapper,  # noqa: E402
                              simulator)
from repro_torch.core.dataflow import Dataflow, LogicalShape  # noqa: E402
from repro_torch.core.energy import model_energy  # noqa: E402
from repro_torch.engine import (AnalyticalCostModel, Engine,  # noqa: E402
                                ExecutionPlan, KernelRequest, plan_arch,
                                use_engine)
from repro_torch.engine.backends import (  # noqa: E402
    gemm_args, hopper_gemm, hopper_grouped_gemm, int8_args, ref_gemm,
    ref_grouped_gemm, sparse_args)
from repro_torch.engine.cost import (HBM_BW, PEAK_FLOPS_BF16,  # noqa: E402
                                     PEAK_FLOPS_F32, PEAK_OPS_INT8,
                                     HopperModel, choose_tile, decide_gemm,
                                     gemm_cost)
from repro_torch.kernels import (_build, flash_attention,  # noqa: E402
                                  grouped_gemm, paged_attention, quant_gemm,
                                  redas_gemm, sparse_gemm)
from repro_torch.data.pipeline import DataConfig, make_source  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import AdamWConfig, linear_warmup_cosine  # noqa: E402
from repro_torch.quant import quantize, quantize_params, tree_bytes  # noqa: E402
from repro_torch.serve_lib import serve as serve_lib  # noqa: E402
from repro_torch.serve_lib.paged import PagedKV  # noqa: E402
from repro_torch.serve_lib.scheduler import Request, Scheduler  # noqa: E402
from repro_torch.sparse import (SparseTensor, prune_params,  # noqa: E402
                                sparsify)
from repro_torch.train_lib import train as train_lib  # noqa: E402
from repro_torch.tree import flatten_with_path, tree_unflatten  # noqa: E402

ARCH = "qwen2-1.5b"
BATCH, PROMPT, GEN, SEED = 4, 512, 16, 0
#: engine GEMMs of one qwen2-1.5b layer: (K, N) -> calls per layer
LAYER_GEMMS = {(1536, 1536): 2, (1536, 256): 2, (1536, 8960): 2, (8960, 1536): 1}
#: granite-moe-1b-a400m's engine GEMMs of one layer (q, k, v, o; the
#: experts are grouped or einsum matmuls)
GRANITE_LAYER_GEMMS = {(1024, 1024): 2, (1024, 512): 2}
L2_BYTES = 50 * 2**20
BF16_ROW_TOL, F32_ROW_TOL = 1e-2, 1e-4
#: the most the model's GEMM decision may take against the fastest of the
#: three dataflows (each at the model's best configuration for it)
GEMM_PICK_LIMIT = 1.25
#: the bf16 GEMM's M on the main paths: the static decode (4) and prefill
#: (2048), the paged decode (8) and prefill (8 slots x widths 64, 256 and
#: 768), the speculative verify (8 slots x 5); 40, 512 and 6144 are
#: outside the cost model's fit
GEMM_MAIN_M = (4, 8, 40, 512, 2048, 6144)
LOGIT_LIMITS = {"rel_l2": 0.035, "rel_max": 0.035}
#: where two bf16 runs of a model differ by more than LOGIT_LIMITS on
#: their own (recurrentgemma-2b: through 26 layers the plain bf16 `@`
#: and the plain versions differ by 4.3e-2 rel-L2, growing with depth
#: from 1.1e-2 at 3 layers; PERF.md, PR 33), the kernels' prefill logits
#: are held against the f32 model (f32 weights and compute, the plain
#: versions): no farther from it than this times the plain versions' bf16
#: logits are
F32_ANCHOR_LIMIT = 1.15
KERNELS = ("redas_gemm", "paged_attention", "flash_attention", "grouped_gemm",
           "quant_gemm", "sparse_gemm")
#: the paged serve: 24 requests over 8 slots (prompt x new tokens * count)
SLOTS, PAGE, BUCKET = 8, 16, 16
TRACE = "768x32*4,512x64*4,256x16*8,64x48*8"
#: the qwen2 posture serves' paged trace (int8 weights, --quantize,
#: --sparsity, sparse x int8: phases 13, 15, 18-23; since PR 34 also
#: qwen3-14b's and granite's paged serves and mamba2-780m's Scheduler
#: trace), cut from TRACE's 24
#: requests and 110 ticks to 12 requests and 31 ticks to make room in the
#: run's time: the same max_seq (the same pools), 8 slots admitted at
#: once whose 512x24 requests outlive the 21 probe ticks of
#: `_replay_and_trace`, then 4 admitted into the freed slots
POSTURE_TRACE = "768x32*4,512x24*4,256x8*4"
SERVE_ARGS = ["--arch", ARCH, "--kernel-backend", "hopper", "--batch",
              str(SLOTS), "--cache-layout", "paged", "--page-size", str(PAGE),
              "--prefill-bucket", str(BUCKET), "--seed", str(SEED),
              "--trace", POSTURE_TRACE]
#: the paged kernel's main-path shape: the serve's decode tick (max_seq
#: 801 -> 51 pages a slot, 510 in the pool) at these kv_len
PAGED_LENS = (800, 0, 1, 16, 17, 400, 783, 255)
SLOT_PAGES = -(-(768 + 32 + 1) // PAGE)
POOL_PAGES = SLOTS * SLOT_PAGES + 2 * SLOT_PAGES
FLASH_SHAPE = (4, 12, 512, 128)
#: the operations-bound flash shape (timed beside FLASH_SHAPE, causal)
FLASH_OPS_SHAPE = (2, 16, 4096, 128)
#: the head dims phase 3 holds both flash routes at: the SMOKE configs'
#: 16, hubert's 80, gemma3's 240, recurrentgemma's 256, and 20, which
#: only the sync route takes
FLASH_HEAD_DIMS = (16, 20, 64, 80, 128, 240, 256)
#: (Sq, Sk, causal, window) of those checks: causal, window (its rows
#: past Sk + window - 2 see no key and average v), non-causal, a ragged
#: length, with Sq != Sk
FLASH_CASES = ((384, 448, True, 0), (448, 384, True, 128),
               (384, 320, False, 0), (500, 500, True, 0),
               (300, 200, True, 40), (300, 260, False, 64))
#: granite-moe-1b-a400m: the sorted serve (trace mode, paged) and the
#: einsum serve (static: prompt 256, since the einsum dispatch holds a
#: (B, S, E, C) one-hot per layer)
GRANITE = "granite-moe-1b-a400m"
QWEN3, GEMMA3 = "qwen3-14b", "gemma3-12b"
MISTRAL, MIXTRAL = "mistral-large-123b", "mixtral-8x7b"
EINSUM_PROMPT, EINSUM_GEN = 256, 16
#: the grouped kernel's main-path shapes (E, C, D, F) at 8 slots: decode
#: (C = 8 x 4) for wi/wg and wo, the widest prefill bucket (C = 8 x 240 at
#: 768 tokens), a ragged one (C = 8 x 20 at 64 tokens)
GROUPED_SHAPES = ((32, 32, 1024, 512), (32, 32, 512, 1024),
                  (32, 1920, 1024, 512), (32, 1920, 512, 1024),
                  (32, 160, 1024, 512))
#: the int8 kernel's shapes: qwen's dense (K, N) at the static decode
#: (M = 4), the paged decode (M = 8) and the prefill (M = 2048), the
#: decode path's largest bucket (16) and the tiled path's least M (17),
#: and a ragged case
INT8_SHAPES = ([(m, k, n) for m in (BATCH, SLOTS, BATCH * PROMPT)
                for k, n in LAYER_GEMMS]
               + [(16, 1536, 1536), (17, 1536, 1536), (5, 1000, 200)])
#: granite-moe-1b-a400m's int8 shapes under --quantize (phase 27), held
#: bit for bit but not timed: q/o and k/v at the decode (M = 8 slots) and
#: a 256-token prefill of 8 slots (M = 2048), and the int8 grouped op's
#: per-expert (C, D, F) and (C, F, D) calls of the sorted dispatch at
#: decode (C = 8 slots x capacity 4) and at that prefill (8 x 80)
GRANITE_INT8_SHAPES = [(m, k, n) for m in (SLOTS, SLOTS * 256)
                       for k, n in GRANITE_LAYER_GEMMS] + [
                           (c, k, n) for c in (SLOTS * 4, SLOTS * 80)
                           for k, n in ((1024, 512), (512, 1024))]
REPORT = {}


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


# --------------------------------------------------------------------------
# timing
# --------------------------------------------------------------------------


def device_ms(fn, sets, side: torch.cuda.Stream) -> float:
    """Device time of one call of `fn`, by CUDA events around replays of a
    CUDA graph of calls that cycle through `sets` (inputs past the L2, and
    no host gaps between launches).  `side` is the stream for the warm-up
    before capture; one stream serves every call, so cuBLAS keeps one
    workspace for it."""
    reps = max(8, len(sets))
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in sets[:2]:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        keep = [fn(*sets[i % len(sets)]) for i in range(reps)]
    graph.replay()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    graph.replay()
    e1.record()
    torch.cuda.synchronize()
    per_replay = e0.elapsed_time(e1)
    n = max(3, min(200, math.ceil(100.0 / max(per_replay, 1e-3))))
    e0.record()
    for _ in range(n):
        graph.replay()
    e1.record()
    torch.cuda.synchronize()
    del keep, graph
    return e0.elapsed_time(e1) / (n * reps)


def host_ms(fn, calls: int = 200) -> float:
    """Wall time (ms) of one of `calls` back-to-back calls of `fn`, the
    card synchronised before and after: at decode shapes the host's cost
    of a call (its checks, allocations and launches), which the card's
    time hides only when it is longer."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def host_enqueue_us(fn, calls: int = 200, repeats: int = 5) -> float:
    """The host's us per call of `fn` alone: the wall time of `calls`
    calls enqueued back to back, the card drained before and after but
    not waited for in between (fewer launches than the launch queue
    holds, so a slower card does not stall the host), the median of
    `repeats`."""
    fn()
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) * 1e6 / calls)
        torch.cuda.synchronize()
    return statistics.median(times)


def bound(m: int, k: int, n: int, itemsize: int) -> tuple[float, str]:
    """Least time (ms) the card could take, and what sets it: each input
    read once and the output written once at the HBM rate, against the
    FLOPs at the data-sheet peak for the operand type."""
    peak = PEAK_FLOPS_BF16 if itemsize == 2 else PEAK_FLOPS_F32
    ops_ms = 2.0 * m * k * n / peak * 1e3
    bytes_ms = (m * k + k * n + m * n) * itemsize / HBM_BW * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def row_rel_l2(got: torch.Tensor, ref: torch.Tensor) -> float:
    got, ref = got.float(), ref.float()
    return ((got - ref).norm(dim=-1) / ref.norm(dim=-1).clamp_min(1e-30)).max().item()


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def phase_setup() -> None:
    print(card_line())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    # one blocking nvcc per source, all started together
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        libs = dict(zip(KERNELS, pool.map(_build.build, KERNELS), strict=True))
    seconds = time.perf_counter() - t0
    REPORT["setup"] = {"card": card_line(), "torch": torch.__version__,
                       "cuda": torch.version.cuda, "build_s": seconds}
    print(f"build: {seconds:.1f} s for {len(KERNELS)} sources in parallel")
    for name in KERNELS:
        log = _build.log_path(name).read_text()
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        stores = sum(int(s) for s in re.findall(r"(\d+) bytes spill stores", log))
        loads = sum(int(s) for s in re.findall(r"(\d+) bytes spill loads", log))
        check(len(regs) > 0, f"no kernel of {name} in the ptxas report")
        print(f"  {libs[name].name}: ptxas {len(regs)} kernels, registers "
              f"{min(regs)}..{max(regs)}, spill stores {stores} bytes and "
              f"loads {loads} bytes in all")
        REPORT["setup"][name] = {"kernels": len(regs),
                                 "registers": [min(regs), max(regs)],
                                 "spill_store_bytes": stores,
                                 "spill_load_bytes": loads}


#: the ReDas GEMM's kernels (csrc/redas_gemm.cu), as the profiler names
#: them: OS on its wgmma and sync routes, WS/IS and their reduction
WGMMA_KERNEL = "::os_wgmma_kernel<"
GEMM_KERNELS = (WGMMA_KERNEL, "::os_kernel<", "::stream_kernel<",
                "::stream_reduce_kernel<")


#: the streaming reduction's kernel, as the profiler names it
REDUCE_KERNEL = "::stream_reduce_kernel<"


def check_reductions(label: str, eng, per_layer: dict, layers: int,
                     passes: dict) -> int:
    """The streaming reductions launched since the last reset equal what
    the serve's plan implies: for each GEMM decision with more than one K
    slab, the layer's calls of its (K, N) x the layers x the forward
    passes at its M (`passes`, M -> passes)."""
    want = 0
    for req, dec in eng.plan:
        if req.op != "gemm":
            continue
        check(req.m in passes and (req.k, req.n) in per_layer,
              f"{label}: a GEMM decision at {req.m} x {req.k} x {req.n} "
              f"outside the serve's shapes")
        if dec.meta_dict.get("slabs", 1) > 1:
            want += per_layer[req.k, req.n] * layers * passes[req.m]
    got = redas_gemm.reduce_launches
    print(f"{label}: {got} streaming reductions; its plan's multi-slab "
          f"decisions make {want} calls")
    check(got == want, f"{label}: {got} reductions, but the plan's "
          f"multi-slab decisions make {want} calls")
    return got


def check_os_routes(label: str, eng, per_layer: dict, layers: int,
                    passes: dict) -> int:
    """The OS GEMMs launched since the last reset equal the calls the
    serve's plan makes at its OS decisions (the layer's calls of the
    decision's (K, N) x the layers x the forward passes at its M), and
    every one of them ran on the wgmma kernel (`os_wgmma_launches`)."""
    want = sum(per_layer[req.k, req.n] * layers * passes[req.m]
               for req, dec in eng.plan
               if req.op == "gemm" and dec.dataflow == "os")
    got, wgmma = redas_gemm.launches["os"], redas_gemm.os_wgmma_launches
    print(f"{label}: {got} OS GEMMs, {wgmma} of them on the wgmma kernel; "
          f"its plan's OS decisions make {want} calls")
    check(got == wgmma == want, f"{label}: {got} OS GEMMs, {wgmma} on the "
          f"wgmma kernel, but the plan's OS decisions make {want} calls")
    return wgmma


def traced_within(seen: int, counted: int) -> bool:
    """A kernel's launches in a profiler trace against the wrapper's exact
    count over the traced run: shown at least once when counted, never
    more often than counted.  The profiler may drop records under load
    (708 of granite's 720 grouped launches in one PR 35 run), so the count
    that is checked against what the plan implies is the wrapper's, and
    the trace shows which kernels ran."""
    return seen <= counted and (seen >= 1 if counted else seen == 0)


def check_traced_reductions(label: str, prof: dict, want: int) -> None:
    """The wrapper's reduction count over a traced run equals `want`, and
    the profiler shows the reduction kernel within it
    (`traced_within`)."""
    seen, counted = (prof["matched"][REDUCE_KERNEL]["count"],
                     prof["reduce_launches"])
    print(f"{label}: the trace holds {seen} reduction launches, the wrapper "
          f"counted {counted}, the plan implies {want}")
    check(counted == want and traced_within(seen, counted),
          f"{label}: traced {seen} reductions, counted {counted}, want "
          f"{want}")


#: the grouped GEMM's kernels (csrc/grouped_gemm.cu) and the paged decode
#: kernel, as the profiler names them
GROUPED_WGMMA_KERNEL = "::grouped_wgmma_kernel<"
GROUPED_KERNELS = (GROUPED_WGMMA_KERNEL, "::grouped_os_kernel<")
PAGED_KERNEL = "::paged_decode_kernel<"


def check_traced_grouped(prof: dict, want: int) -> None:
    """A traced run of granite's sorted decode ticks: the wrapper counted
    `want` grouped calls, all on the wgmma route; the profiler shows
    `grouped_wgmma_kernel` within that count (`traced_within`) and no
    `grouped_os_kernel`.  Prints the ticks' device split."""
    matched = prof["matched"]
    seen = matched[GROUPED_WGMMA_KERNEL]["count"]
    sync = matched[GROUPED_KERNELS[1]]["count"]
    counted, wgmma = prof["grouped_launches"], prof["grouped_wgmma_launches"]
    gemm = sum(matched[key]["ms"] for key in GEMM_KERNELS)
    grouped = sum(matched[key]["ms"] for key in GROUPED_KERNELS)
    paged = matched[PAGED_KERNEL]["ms"]
    prof["split_ms"] = {"grouped": grouped, "redas_gemm": gemm,
                        "paged_attention": paged,
                        "other": prof["device_busy_ms"] - grouped - gemm
                        - paged}
    print(f"  granite's traced ticks: {counted} grouped calls counted, "
          f"{wgmma} on wgmma, the plan implies {want}; the trace holds {seen} "
          f"grouped_wgmma_kernel and {sync} grouped_os_kernel launches; "
          f"device split " + ", ".join(f"{k} {v:.3f} ms"
                                       for k, v in prof["split_ms"].items()))
    check(counted == wgmma == want and sync == 0
          and traced_within(seen, counted),
          f"granite's traced ticks: counted {counted} ({wgmma} wgmma), want "
          f"{want}; traced {seen} wgmma and {sync} sync grouped launches")


def paged_trace_line(prof: dict, label: str, cfg) -> dict:
    """The paged kernel's device ms in a trace of 10 decode ticks: the
    wrapper counted one launch a paged layer a tick, and the trace shows
    the kernel within that count (`traced_within`)."""
    seen = prof["matched"][PAGED_KERNEL]
    counted = prof["paged_launches"]
    print(f"  the paged kernel in {label} 10 traced ticks: {seen['ms']:.3f} "
          f"ms of device time in {seen['count']} traced launches of "
          f"{counted} counted, {seen['ms'] / 10:.3f} ms a tick")
    want = 10 * paged_layers(cfg)
    check(counted == want and traced_within(seen["count"], counted),
          f"{label} traced ticks: {counted} paged launches counted, "
          f"{seen['count']} traced, want {want}")
    return dict(seen)


def gemm_trace_line(prof: dict, per: int, unit: str) -> dict:
    """The ReDas GEMM kernels' device ms in a trace, by kernel, and per
    `unit` (the trace covers `per` of them)."""
    matched = prof["matched"]
    total = sum(matched[key]["ms"] for key in GEMM_KERNELS)
    print(f"  the ReDas GEMM kernels in the trace: {total:.3f} ms of device "
          f"time, {total / per:.3f} ms a {unit} ("
          + ", ".join(f"{key.strip(':<')} {matched[key]['ms']:.3f} ms in "
                      f"{matched[key]['count']} launches"
                      for key in GEMM_KERNELS) + ")")
    return {"ms": total, f"ms_per_{unit}": total / per,
            **{key.strip(":<"): matched[key] for key in GEMM_KERNELS}}


def reset_counts() -> None:
    redas_gemm.reset_launches()
    paged_attention.reset_launches()
    flash_attention.reset_launches()
    grouped_gemm.reset_launches()
    quant_gemm.reset_launches()
    sparse_gemm.reset_launches()


def read_counts() -> dict:
    return {"redas_gemm": sum(redas_gemm.launches.values()),
            "paged_attention": paged_attention.launches,
            "flash_attention": flash_attention.launches,
            "grouped_gemm": grouped_gemm.launches,
            "quant_gemm": quant_gemm.launches,
            "sparse_gemm": sparse_gemm.launches,
            "sparse_gemm_int8": sparse_gemm.int8_launches}


def _operand_sets(m, k, n, dtype, gen):
    per = (m * k + k * n) * torch.tensor([], dtype=dtype).element_size()
    count = max(2, min(64, math.ceil(2 * L2_BYTES / per)))
    return [(torch.randn(m, k, generator=gen, device="cuda").to(dtype),
             (torch.randn(k, n, generator=gen, device="cuda")
              / math.sqrt(k)).to(dtype)) for _ in range(count)]


def _stream_extremes(m: int, k: int, n: int, size: int, df: str) -> list:
    """WS/IS at one slab (the shallowest streaming tile that holds K and
    fits, where one does) and at the most slabs (bk = 64)."""
    fits = [t for t in redas_gemm.STREAM_TILES
            if redas_gemm.stream_stages(df, *t, size)]
    one = min((t for t in fits if t[1] >= k), key=lambda t: (t[1], t),
              default=None)
    return [{"dataflow": df, "bm": t[0], "bk": t[1], "bn": t[2]}
            for t in ([one] if one else []) + [(16, 64, 64)]]


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """A copy of `t` whose base is 2 bytes past a 16-byte boundary: TMA
    cannot take it, so OS runs it on the sync kernel."""
    flat = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    skip = next(i for i in range(1, 8)
                if (flat.data_ptr() + i * t.element_size()) % 16)
    out = flat[skip:skip + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def phase_kernels() -> list[dict]:
    """The ReDas GEMM against its plain version: qwen's four (K, N) at
    every M of GEMM_MAIN_M in bf16 (the static and paged decode, the
    static prefill and the paged prefill's other widths), two f32 shapes,
    and untimed M = 1, 16, 17 at K = 8960 and a ragged (5, 1003, 200).
    Each dataflow runs at the model's best configuration for it
    (`decide_gemm` on that dataflow alone), the model's seconds beside the
    measured ms; at M <= 16 WS and IS also at one slab and at the most
    slabs.  OS runs on the route its operands take (the wgmma kernel at
    the bf16 shapes, the sync kernel at f32 and (5, 1003, 200), each
    call's route read from `os_wgmma_launches`); at the timed bf16 shapes
    whose decision is OS it also runs on the sync kernel, at its model's
    best tile, on the same operands copied to a misaligned base.  Every
    configuration is launched twice, the outputs bit for bit equal.  At
    each bf16 main-path shape the model's decision must time within
    GEMM_PICK_LIMIT of the fastest dataflow; at each timed decode shape
    whose decision has more than one slab the reduction is timed alone;
    at M <= 16 the host's time of an OS call (two tensor maps encoded)
    beside torch.matmul's."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    side = torch.cuda.Stream()
    model = HopperModel()
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(m, k, n, bf16, True) for m in GEMM_MAIN_M for k, n in LAYER_GEMMS]
    cases += [(BATCH, 1536, 8960, f32, True),
              (BATCH * PROMPT, 1536, 1536, f32, True)]
    cases += [(m, 8960, 1536, bf16, False) for m in (1, 16, 17)]
    cases += [(5, 1003, 200, bf16, False), (5, 1003, 200, f32, False)]
    rows, failures, picks = [], [], []
    for m, k, n, dtype, timed in cases:
        sets = (_operand_sets(m, k, n, dtype, gen) if timed else
                [(torch.randn(m, k, generator=gen, device="cuda").to(dtype),
                  (torch.randn(k, n, generator=gen, device="cuda")
                   / math.sqrt(k)).to(dtype))])
        a, b = sets[0]
        size = a.element_size()
        ref = redas_gemm.gemm_reference(a, b)
        tol = BF16_ROW_TOL if dtype == bf16 else F32_ROW_TOL
        request = KernelRequest("gemm", m, k, n, in_bytes=size,
                                out_bytes=size)
        main = model.decide(request)
        shape = {"m": m, "k": k, "n": n, "dtype": str(dtype)[6:]}
        if timed:
            shape["plain_ms"] = device_ms(redas_gemm.gemm_reference, sets,
                                          side)
            shape["library_ms"] = device_ms(torch.matmul, sets, side)
        shape["bound_ms"], shape["bound_by"] = bound(m, k, n, size)
        best = {}
        route = redas_gemm.shape_route(size, k, n)
        for df in redas_gemm.DATAFLOWS:
            dec = decide_gemm(request, model.name, dataflows=(df,))
            configs = [(dec, gemm_args(dec), route if df == "os" else None)]
            if df != "os" and m <= 16:
                configs += [(None, c, None)
                            for c in _stream_extremes(m, k, n, size, df)
                            if (c["bm"], c["bk"], c["bn"])
                            != (dec.bm, dec.bk, dec.bn)]
            if (df == "os" and route == "wgmma" and timed
                    and main.dataflow == "os"):
                sync = decide_gemm(request, model.name, dataflows=("os",),
                                   route="sync")
                configs.append((None, gemm_args(sync), "sync"))
            for planned, conf, os_route in configs:
                tile = (conf["bm"], conf["bk"], conf["bn"])
                # the sync kernel at a wgmma shape: A at a misaligned base
                misaligned = os_route == "sync" and route == "wgmma"
                xa = _misaligned(a) if misaligned else a
                before = redas_gemm.os_wgmma_launches
                out = redas_gemm.gemm(xa, b, **conf)
                again = redas_gemm.gemm(xa, b, **conf)
                torch.cuda.synchronize()
                ran = redas_gemm.os_wgmma_launches - before
                check(ran == (2 if os_route == "wgmma" else 0),
                      f"{m}x{k}x{n} {df} route {os_route}: {ran} of 2 calls "
                      f"on the wgmma kernel")
                check(out.dtype == dtype and out.shape == (m, n),
                      f"gemm output {out.dtype} {tuple(out.shape)}")
                rel = row_rel_l2(out, ref)
                err = (out.float() - ref.float()).abs().max().item()
                same = torch.equal(out, again)
                slabs = (1 if df == "os"
                         else redas_gemm.slab_count(k, tile[1]))
                cost = gemm_cost(m, k, n, df, tile, size, size, os_route)
                row = {**shape, "dataflow": df, "tile": list(tile),
                       "slabs": slabs, "groups": cost["groups"],
                       "role": "planned" if planned else
                       ("sync route" if misaligned else
                        "one slab" if slabs == 1 else "most slabs"),
                       "decision": planned is not None
                       and (df, *tile) == (main.dataflow, main.bm, main.bk,
                                           main.bn),
                       "model_ms": cost["seconds"] * 1e3,
                       "max_abs_err": err, "row_rel_l2": rel, "tol": tol,
                       "repeat_bit_identical": same}
                if os_route:
                    row["route"] = os_route
                row["main_path"] = row["decision"] and dtype == bf16 and timed
                if timed:
                    sets_x = ([(_misaligned(x), y) for x, y in sets]
                              if misaligned else sets)
                    row["ms"] = device_ms(
                        lambda x, y, conf=conf: redas_gemm.gemm(x, y, **conf),
                        sets_x, side)
                    del sets_x
                    if planned:
                        best[df] = row
                    if row["main_path"] or (os_route == "wgmma"
                                            and m <= 16):
                        row["host_ms"] = host_ms(
                            lambda conf=conf: redas_gemm.gemm(a, b, **conf))
                        row["library_host_ms"] = host_ms(
                            lambda: torch.matmul(a, b))
                    if row["main_path"] and slabs > 1:
                        row.update(_time_reduce(
                            slabs, m, n, dtype, gen, side,
                            redas_gemm.stream_reduce,
                            redas_gemm.stream_reduce_reference))
                rows.append(row)
                ok = math.isfinite(rel) and rel <= tol and same
                times = (f"; kernel {row['ms']:.4f} ms (model "
                         f"{row['model_ms']:.4f}), plain "
                         f"{row['plain_ms']:.4f}, torch.matmul "
                         f"{row['library_ms']:.4f}, bound "
                         f"{row['bound_ms']:.4f} ms ({row['bound_by']})"
                         if timed else "")
                if "host_ms" in row:
                    times += (f"; host {row['host_ms'] * 1e3:.1f} us a call "
                              f"(torch.matmul "
                              f"{row['library_host_ms'] * 1e3:.1f})")
                if "reduce_ms" in row:
                    times += (f"; its reduction of {slabs} slabs "
                              f"{row['reduce_ms']:.4f} ms (plain "
                              f"{row['reduce_plain_ms']:.4f}, torch.sum "
                              f"{row['reduce_library_ms']:.4f}, bound "
                              f"{row['reduce_bound_ms']:.4f})")
                print(f"gemm {row['dtype']} {m}x{k}x{n} {df}"
                      f"{' ' + os_route if os_route else ''} tile {tile} "
                      f"slabs {slabs} groups {row['groups']} ({row['role']}"
                      f"{', the decision' if row['decision'] else ''}): row "
                      f"rel-L2 {rel:.2e} (tol {tol:g}), max|diff| {err:.3e}, "
                      f"repeat {'bit-identical' if same else 'DIFFERS'}"
                      f"{times}{'' if ok else '  FAILED'}")
                if not ok:
                    failures.append(f"{df} {tile} {m}x{k}x{n} "
                                    f"{row['dtype']}: {rel:.2e}, repeat "
                                    f"equal {same}")
        if timed and dtype == bf16:
            fastest = min(r["ms"] for r in best.values())
            pick = best[main.dataflow]["ms"]
            picks.append({**{key: shape[key] for key in ("m", "k", "n")},
                          "decision": main.dataflow, "ms": pick,
                          "fastest_ms": fastest, "ratio": pick / fastest,
                          "by_dataflow": {df: r["ms"]
                                          for df, r in best.items()}})
            print(f"  decision {main.dataflow} ({main.bm}, {main.bk}, "
                  f"{main.bn}) {pick:.4f} ms against the fastest dataflow "
                  f"{fastest:.4f} ms: {pick / fastest:.2f}x (limit "
                  f"{GEMM_PICK_LIMIT}x)")
        del sets
    REPORT["gemm"] = rows
    REPORT["gemm_picks"] = picks
    check(not failures, f"kernel disagrees with its plain version: {failures}")
    slow = [p for p in picks if p["ratio"] > GEMM_PICK_LIMIT]
    check(not slow, f"the model's decision is slower than "
          f"{GEMM_PICK_LIMIT}x the fastest dataflow: {slow}")
    return rows


#: the calibration sweep's shapes: qwen's four (K, N) at decode (M = 4, 8),
#: at M = 64, 256 and 768, at the static prefill (2048) and at the paged
#: serve's other prefill GEMMs (8 slots x widths 64 and 768: M = 512 and
#: 6144); granite's attention GEMMs (K, N) at M = 8 and 2048; two f32
#: shapes
SWEEP_SHAPES = ([(m, k, n, torch.bfloat16)
                 for m in (4, 8, 64, 256, 512, 768, 2048, 6144)
                 for k, n in LAYER_GEMMS]
                + [(m, 1024, n, torch.bfloat16) for m in (8, 2048)
                   for n in (1024, 512)]
                + [(4, 1536, 8960, torch.float32),
                   (2048, 1536, 1536, torch.float32)])


def sweep() -> int:
    """`chip_smoke.py --sweep`: build the ReDas GEMM, then time every
    (dataflow, tile) of its menus at SWEEP_SHAPES beside `gemm_cost`'s
    prediction (OS on the route the shape takes, `shape_route`: the wgmma
    kernel's menu at these bf16 shapes, the sync kernel's at f32), each
    held to the plain version first; print one JSON line per
    configuration (also to runs/gemm_sweep.jsonl): the data
    `calibrate_gemm.py` fits `engine.cost.gemm_cost`'s constants to and
    holds its decisions against (tests/data/gemm_sweep_h100.jsonl is one
    such file, its fields trimmed)."""
    print(card_line())
    _build.build("redas_gemm")
    gen = torch.Generator(device="cuda").manual_seed(1)
    side = torch.cuda.Stream()
    out_dir = ROOT / "runs"
    out_dir.mkdir(exist_ok=True)
    failures = []
    with (out_dir / "gemm_sweep.jsonl").open("w") as fh:
        for m, k, n, dtype in SWEEP_SHAPES:
            sets = _operand_sets(m, k, n, dtype, gen)
            a, b = sets[0]
            size = a.element_size()
            ref = redas_gemm.gemm_reference(a, b)
            tol = BF16_ROW_TOL if dtype == torch.bfloat16 else F32_ROW_TOL
            for df in redas_gemm.DATAFLOWS:
                route = (redas_gemm.shape_route(size, k, n) if df == "os"
                         else None)
                for tile in redas_gemm.tiles_for(df, route or "sync"):
                    cost = gemm_cost(m, k, n, df, tile, size, size, route)
                    if cost is None:
                        continue
                    kw = {"dataflow": df, "bm": tile[0], "bk": tile[1],
                          "bn": tile[2]}
                    got = redas_gemm.gemm(a, b, **kw)
                    torch.cuda.synchronize()
                    rel = row_rel_l2(got, ref)
                    if not (math.isfinite(rel) and rel <= tol):
                        failures.append((m, k, n, df, tile, rel))
                    us = 1e3 * device_ms(
                        lambda x, y, kw=kw: redas_gemm.gemm(x, y, **kw), sets,
                        side)
                    row = {"m": m, "k": k, "n": n, "dtype": str(dtype)[6:],
                           "dataflow": df, **({"route": route} if route
                                              else {}),
                           "tile": list(tile), "us": us,
                           "model_us": cost["seconds"] * 1e6,
                           "row_rel_l2": rel,
                           **{key: cost[key] for key in
                              ("slabs", "groups", "blocks", "fill",
                               "workspace_bytes")}}
                    fh.write(json.dumps(row) + "\n")
                    print(json.dumps(row), flush=True)
            del sets
    print(f"failures {failures}")
    return 1 if failures else 0


#: the int8 kernel's sweep: every decode split at M <= 16 and every
#: tiled tile above it, at qwen2-1.5b's (K, N)
INT8_SWEEP_M = (1, 4, 8, 16, 17, 33, 512, 2048, 6144)


def sweep_int8() -> int:
    """`chip_smoke.py --sweep-int8`: build the int8 kernel, then time
    every configuration of the path the engine takes at each M of
    INT8_SWEEP_M (each decode split at M <= 16, each tiled tile above)
    at qwen's (K, N) beside `decide_int8`'s model, each held to the plain
    version bit for bit first; print one JSON line per configuration
    (also to runs/int8_sweep.jsonl): the data `calibrate_gemm.py --int8`
    fits the int8 model's constants to and holds its decisions against
    (tests/data/int8_sweep_h100.jsonl is one such file, its fields
    trimmed)."""
    from repro_torch.engine.cost import int8_decode_cost, int8_tiled_cost

    print(card_line())
    _build.build("quant_gemm")
    gen = torch.Generator(device="cuda").manual_seed(1)
    side = torch.cuda.Stream()
    out_dir = ROOT / "runs"
    out_dir.mkdir(exist_ok=True)
    failures = []
    with (out_dir / "int8_sweep.jsonl").open("w") as fh:
        for m in INT8_SWEEP_M:
            for k, n in LAYER_GEMMS:
                sets = _int8_sets(m, k, n, gen)
                ref = quant_gemm.gemm_int8_reference(*sets[0])
                path = ("decode" if m <= quant_gemm.DECODE_ROWS[-1]
                        else "tiled")
                for kw in _int8_options(path):
                    got = quant_gemm.gemm_int8(*sets[0], **kw)
                    torch.cuda.synchronize()
                    if not torch.equal(got, ref):
                        failures.append((m, k, n, _int8_label(kw)))
                    model = (int8_decode_cost(m, k, n, kw["split_k"])
                             if kw["path"] == "decode"
                             else int8_tiled_cost(m, k, n, kw["tile"]))
                    row = {"m": m, "k": k, "n": n, "path": kw["path"],
                           "split_k": kw.get("split_k", 1),
                           "tile": list(kw.get("tile", ())),
                           "us": 1e3 * device_ms(functools.partial(
                               quant_gemm.gemm_int8, **kw), sets, side),
                           "model_us": model["seconds"] * 1e6,
                           "blocks": model["blocks"]}
                    fh.write(json.dumps(row) + "\n")
                    print(json.dumps(row), flush=True)
                del sets
    print(f"failures {failures}")
    return 1 if failures else 0


def _paged_sets(dtype, count: int, seed: int, int8: bool,
                shape: tuple) -> list[tuple]:
    """`count` input sets of the paged serve's decode tick, each with its
    own pools: q (8, 1, H, D), pools (510, 16, KV, D) for `shape` = (H,
    KV, D), a 51-page table per slot whose live
    pages are drawn from the pool and whose other entries are holes (-1),
    kv_len = PAGED_LENS.  `int8`: random int8 pools and their scale pools
    (510, 16, KV) from U(1e-3, 2e-2), as tests/test_paged.py draws them,
    after the lengths."""
    h, kv, d = shape
    gen = torch.Generator().manual_seed(seed)
    lens = torch.tensor(PAGED_LENS, dtype=torch.int32)
    sets = []
    for _ in range(count):
        q = torch.randn(SLOTS, 1, h, d, generator=gen)
        if int8:
            kp, vp = (torch.randint(-127, 128, (POOL_PAGES, PAGE, kv, d),
                                    generator=gen, dtype=torch.int8)
                      for _ in range(2))
            scales = tuple(torch.rand(POOL_PAGES, PAGE, kv, generator=gen)
                           * 1.9e-2 + 1e-3 for _ in range(2))
        else:
            kp, vp = (torch.randn(POOL_PAGES, PAGE, kv, d, generator=gen)
                      for _ in range(2))
        perm = torch.randperm(POOL_PAGES, generator=gen).to(torch.int32)
        bt = torch.full((SLOTS, SLOT_PAGES), -1, dtype=torch.int32)
        ptr = 0
        for i, n in enumerate(PAGED_LENS):
            need = -(-n // PAGE)
            bt[i, :need] = perm[ptr:ptr + need]
            ptr += need
        pools = (kp.cuda(), vp.cuda()) if int8 else (kp.to("cuda", dtype),
                                                      vp.to("cuda", dtype))
        sets.append((q.to("cuda", dtype), *pools, bt.cuda(), lens.cuda())
                    + (tuple(x.cuda() for x in scales) if int8 else ()))
    return sets


def _paged_library(q, kp, vp, bt, lens, ks=None, vs=None):
    """The library yardstick: gather the pages (`k_pages[bt]`; int8 pools
    also their scales, then dequantize to q's dtype), then
    `F.scaled_dot_product_attention` with a length mask."""
    b, n_bt = bt.shape
    page, kv, d = kp.shape[1:]
    safe = bt.clamp(min=0).long()
    k, v = kp[safe], vp[safe]
    if ks is not None:
        k, v = ((x.float() * s[safe][..., None]).to(q.dtype)
                for x, s in ((k, ks), (v, vs)))
    k = k.reshape(b, n_bt * page, kv, d).transpose(1, 2)
    v = v.reshape(b, n_bt * page, kv, d).transpose(1, 2)
    mask = (torch.arange(n_bt * page, device=q.device)[None, :]
            < lens[:, None])[:, None, None, :]
    return F.scaled_dot_product_attention(q.transpose(1, 2), k, v,
                                          attn_mask=mask, enable_gqa=True)


def _peak(itemsize: int) -> float:
    return PEAK_FLOPS_BF16 if itemsize == 2 else PEAK_FLOPS_F32


def _bound_of(ops: float, bytes_: float, itemsize: int) -> tuple[float, str]:
    ops_ms = ops / _peak(itemsize) * 1e3
    bytes_ms = bytes_ / HBM_BW * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def paged_bound(itemsize: int, int8: bool,
                shape: tuple) -> tuple[float, str]:
    """q and o, each live K and V row read once (int8 pools: one byte an
    element and one f32 scale a row), the table and lengths; 4 x H x D
    operations per live row (QK^T and PV); `shape` = (H, KV, D)."""
    live = sum(PAGED_LENS)
    h, kv, d = shape
    rows = 2 * live * kv * ((d + 4) if int8 else d * itemsize)
    bytes_ = (2 * SLOTS * h * d * itemsize + rows + SLOTS * SLOT_PAGES * 4
              + SLOTS * 4)
    return _bound_of(4.0 * h * live * d, bytes_, itemsize)


def flash_bound(shape, causal: bool, itemsize: int) -> tuple[float, str]:
    """q, k, v read once and o written once; 4 B H Sq Sk D operations,
    halved for causal."""
    b, h, s, d = shape
    ops = 4.0 * b * h * s * s * d * (0.5 if causal else 1.0)
    return _bound_of(ops, 4 * b * h * s * d * itemsize, itemsize)


def _flash_sets(shape, dtype, count: int, seed: int = 3) -> list[tuple]:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [tuple(torch.randn(*shape, generator=gen, device="cuda").to(dtype)
                  for _ in range(3)) for _ in range(count)]


#: the paged kernel's decode shapes (H, KV, D) at the serve's 8 slots,
#: 51-page tables and PAGED_LENS: qwen2-1.5b's, granite-moe-1b-a400m's,
#: qwen3-14b's (G = 5: the kernel's padded 3 + 3 head chunks) and
#: gemma3-12b's (D = 240)
PAGED_SHAPES = {ARCH: (12, 2, 128), GRANITE: (16, 8, 64),
                QWEN3: (40, 8, 128), GEMMA3: (16, 8, 240)}
#: the cluster sizes the paged phases time, and the most the wrapper's
#: pick (`splits_for`) may take against the fastest of them (bf16)
PAGED_SPLITS = (1, 2, 4, 8)
PAGED_PICK_LIMIT = 1.25


def paged_kernel_rows(dtype, int8: bool, side) -> tuple[list[dict], list]:
    """The paged kernel (float pools, or int8 pools with their scales) at
    each of PAGED_SHAPES in `dtype`: held to its plain version at the
    wrapper's cluster size and at each of PAGED_SPLITS (per live row; the
    kv_len 0 rows exact zeros; a repeat bit for bit), timed at each and
    beside the plain version, the library yardstick and the bound; the
    cluster occupancy (`cudaOccupancyMaxActiveClusters`) and the host's
    us a call at the pick (enqueued back to back).  Returns the rows and
    the failures; in bf16 a pick slower than PAGED_PICK_LIMIT x the
    fastest split fails."""
    tol = BF16_ROW_TOL if dtype == torch.bfloat16 else F32_ROW_TOL
    name = str(dtype)[6:]
    itemsize = torch.tensor([], dtype=dtype).element_size()
    dead = [i for i, n in enumerate(PAGED_LENS) if n == 0]
    live = [i for i, n in enumerate(PAGED_LENS) if n > 0]
    kernel = "paged_attention_int8" if int8 else "paged_attention"
    rows, failures = [], []
    for arch, (h, kv, d) in PAGED_SHAPES.items():
        row_bytes = kv * ((d + 4) if int8 else d * itemsize)
        sets = _paged_sets(dtype, max(2, min(64, math.ceil(
            L2_BYTES / (sum(PAGED_LENS) * row_bytes)))),
            seed=7 if int8 else 2, int8=int8, shape=(h, kv, d))
        ref = paged_attention.paged_attention_reference(*sets[0])
        pick = paged_attention.splits_for(SLOTS, kv, SLOT_PAGES)
        rel, zeros, err = {}, {}, 0.0
        for c in (None, *PAGED_SPLITS):
            out = paged_attention.paged_attention(*sets[0], splits=c)
            torch.cuda.synchronize()
            rel[c] = row_rel_l2(out[live], ref[live])
            zeros[c] = bool((out[dead] == 0).all())
            err = max(err, (out[live].float() - ref[live].float()).abs()
                      .max().item())
        again = paged_attention.paged_attention(*sets[0])
        same = bool(torch.equal(again, paged_attention.paged_attention(
            *sets[0])))
        split_ms = {c: device_ms(functools.partial(
            paged_attention.paged_attention, splits=c), sets, side)
            for c in PAGED_SPLITS}
        ms = device_ms(paged_attention.paged_attention, sets, side)
        fastest = min(split_ms, key=split_ms.get)
        row = {"kernel": kernel, "arch": arch, "dtype": name,
               "shape": (f"q (8,1,{h},{d}), {'int8 ' if int8 else ''}pools "
                         f"(510,16,{kv},{d})" + (", scale pools (510,16,"
                                                 f"{kv})" if int8 else "")
                         + ", n_bt 51"),
               "kv_len": list(PAGED_LENS), "splits": pick, "ms": ms,
               "splits_ms": split_ms, "fastest_split": fastest,
               "pick_over_fastest": ms / split_ms[fastest],
               "plain_ms": device_ms(
                   paged_attention.paged_attention_reference, sets, side),
               "library_ms": device_ms(_paged_library, sets, side),
               "library": ("gather + dequantize + scaled_dot_product_attention"
                           if int8 else "k_pages[bt] gather + "
                           "scaled_dot_product_attention (two calls)"),
               "max_active_clusters": paged_attention.max_active_clusters(
                   *sets[0]),
               "host_us": host_enqueue_us(functools.partial(
                   paged_attention.paged_attention, *sets[0])),
               "max_abs_err": err, "row_rel_l2": max(rel.values()),
               "row_rel_l2_by_split": {str(c): v for c, v in rel.items()},
               "tol": tol, "kv_len_0_exact_zeros": all(zeros.values()),
               "repeat_bitwise": same}
        row["bound_ms"], row["bound_by"] = paged_bound(itemsize, int8,
                                                       (h, kv, d))
        rows.append(row)
        ok = (all(math.isfinite(r) and r <= tol for r in rel.values())
              and row["kv_len_0_exact_zeros"] and same)
        slow = dtype == torch.bfloat16 and (row["pick_over_fastest"]
                                            > PAGED_PICK_LIMIT)
        print(f"{kernel} {arch} {name}: {row['shape']}, kv_len "
              f"{PAGED_LENS}: row rel-L2 {row['row_rel_l2']:.2e} at C in "
              f"(pick, 1, 2, 4, 8) (tol {tol:g}), max|diff| {err:.3e}, kv_len "
              f"0 rows {'exact zeros' if row['kv_len_0_exact_zeros'] else 'NOT ZERO'}, "
              f"repeat {'bit for bit' if same else 'DIFFERS'}; kernel at the "
              f"pick C = {pick} {ms:.4f} ms ("
              + ", ".join(f"C={c} {v:.4f}" for c, v in split_ms.items())
              + f"; pick / fastest {row['pick_over_fastest']:.3f}, limit "
              f"{PAGED_PICK_LIMIT}), plain {row['plain_ms']:.4f} ms, "
              f"{'gather + dequantize + SDPA' if int8 else 'gather + SDPA (two calls)'} "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}); {row['max_active_clusters']} clusters of "
              f"{pick} fit at once; host {row['host_us']:.1f} us a call"
              f"{'' if ok and not slow else '  FAILED'}")
        if not ok:
            failures.append(f"{kernel} {arch} {name}: rel {rel}, zeros "
                            f"{zeros}, repeat {same}")
        if slow:
            failures.append(f"{kernel} {arch} {name}: the pick C = {pick} "
                            f"takes {row['pick_over_fastest']:.3f} x the "
                            f"fastest C = {fastest}")
        del sets
    return rows, failures


def _flash_call(q, k, v, causal: bool, window: int):
    """One flash call on the operands' route; returns the output and the
    route its launch was counted on (each call must launch once)."""
    flash_attention.reset_launches()
    out = flash_attention.flash_attention(q, k, v, causal=causal,
                                          window=window)
    launched = (flash_attention.launches, flash_attention.wgmma_launches)
    route = {(1, 1): "wgmma", (1, 0): "sync"}.get(launched, f"{launched}")
    return out, route


def flash_rows(side, failures: list) -> list[dict]:
    """The flash kernel on both routes: bf16 and f32 at every D of
    FLASH_HEAD_DIMS over FLASH_CASES (q (2, 3, Sq, D)), each call held to
    the plain version at the row tolerance, launched once on the route
    `flash_route` names (bf16 with D % 8 == 0: wgmma; the rest: sync) and
    repeated bit for bit; bf16 on operands at a misaligned base (the sync
    route); then timed, beside the plain version, SDPA and the bound: bf16
    at FLASH_SHAPE and FLASH_OPS_SHAPE (wgmma), f32 at FLASH_SHAPE and bf16
    at a misaligned base (sync), all causal."""
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(5)
    for dtype in (torch.bfloat16, torch.float32):
        tol = BF16_ROW_TOL if dtype == torch.bfloat16 else F32_ROW_TOL
        name = str(dtype)[6:]
        for d in FLASH_HEAD_DIMS:
            want = ("wgmma" if dtype == torch.bfloat16 and d % 8 == 0
                    else "sync")
            rel, err, bad = 0.0, 0.0, []
            for sq, sk, causal, window in FLASH_CASES:
                q = torch.randn(2, 3, sq, d, generator=gen, device="cuda")
                k, v = (torch.randn(2, 3, sk, d, generator=gen, device="cuda")
                        for _ in range(2))
                q, k, v = (x.to(dtype) for x in (q, k, v))
                out, route = _flash_call(q, k, v, causal, window)
                again, _ = _flash_call(q, k, v, causal, window)
                ref = flash_attention.flash_attention_reference(
                    q, k, v, causal=causal, window=window)
                torch.cuda.synchronize()
                r = row_rel_l2(out, ref)
                rel = max(rel, r)
                err = max(err, (out.float() - ref.float()).abs().max().item())
                if not (math.isfinite(r) and r <= tol and route == want
                        and torch.equal(out, again)):
                    bad.append(((sq, sk, causal, window), r, route,
                                bool(torch.equal(out, again))))
            rows.append({"kernel": "flash_attention", "dtype": name, "d": d,
                         "route": want, "cases": [list(c) for c in FLASH_CASES],
                         "row_rel_l2": rel, "max_abs_err": err, "tol": tol,
                         "repeat_bitwise": not bad})
            print(f"flash_attention {name} D={d} on the {want} route, "
                  f"{len(FLASH_CASES)} mask cases (Sq != Sk): row rel-L2 "
                  f"{rel:.2e} (tol {tol:g}), max|diff| {err:.3e}, one launch "
                  f"a call on the {want} route, repeats bit for bit"
                  + ("" if not bad else f"  FAILED {bad}"))
            if bad:
                failures.append(f"flash {name} D={d}: {bad}")

    def misaligned(shape):
        n = math.prod(shape)
        flat = torch.randn(3 * n + 1, generator=gen,
                           device="cuda").to(torch.bfloat16)
        return tuple(flat[1 + i * n:1 + (i + 1) * n].view(shape)
                     for i in range(3))

    timed = [("bfloat16", FLASH_SHAPE, "wgmma"),
             ("bfloat16", FLASH_OPS_SHAPE, "wgmma"),
             ("float32", FLASH_SHAPE, "sync"),
             ("bfloat16 at a misaligned base", FLASH_SHAPE, "sync")]
    for name, shape, want in timed:
        dtype = torch.float32 if name == "float32" else torch.bfloat16
        itemsize = torch.tensor([], dtype=dtype).element_size()
        per = 4 * math.prod(shape) * itemsize
        count = max(2, min(64, math.ceil(2 * L2_BYTES / per)))
        sets = ([misaligned(shape) for _ in range(count)]
                if "misaligned" in name else _flash_sets(shape, dtype, count))
        tol = BF16_ROW_TOL if dtype == torch.bfloat16 else F32_ROW_TOL
        bk = flash_attention.route_tile(want, shape[3])[1]
        run = functools.partial(flash_attention.flash_attention, causal=True)
        plain = functools.partial(flash_attention.flash_attention_reference,
                                  causal=True, bk=bk)
        (out, route), ref = _flash_call(*sets[0], True, 0), plain(*sets[0])
        torch.cuda.synchronize()
        rel = row_rel_l2(out, ref)
        row = {"kernel": "flash_attention", "dtype": name,
               "shape": list(shape), "causal": True, "route": route,
               "row_rel_l2": rel, "tol": tol,
               "max_abs_err": (out.float() - ref.float()).abs().max().item(),
               "ms": device_ms(run, sets, side),
               "plain_ms": device_ms(plain, sets, side),
               "library_ms": device_ms(functools.partial(
                   F.scaled_dot_product_attention, is_causal=True), sets,
                   side),
               "library": "scaled_dot_product_attention"}
        row["bound_ms"], row["bound_by"] = flash_bound(shape, True, itemsize)
        flops = 4.0 * math.prod(shape) * shape[2] * 0.5
        row["tflops"] = flops / row["ms"] * 1e-9
        row["peak_share"] = row["tflops"] * 1e12 / _peak(itemsize)
        rows.append(row)
        ok = math.isfinite(rel) and rel <= tol and route == want
        print(f"flash_attention {name} {shape} causal on the {route} route: "
              f"row rel-L2 {rel:.2e} (tol {tol:g}); kernel {row['ms']:.4f} "
              f"ms ({row['tflops']:.1f} TFLOP/s, {row['peak_share']:.3f} of "
              f"the peak), plain {row['plain_ms']:.4f} ms, SDPA "
              f"{row['library_ms']:.4f} ms (kernel / SDPA "
              f"{row['ms'] / row['library_ms']:.2f}), bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']})"
              + ("" if ok else "  FAILED"))
        if not ok:
            failures.append(f"flash {name} {shape}: {rel:.2e} on {route}")
        del sets
    return rows


def phase_attention_kernels() -> dict:
    side = torch.cuda.Stream()
    rows, failures = [], []
    for dtype in (torch.bfloat16, torch.float32):
        # paged attention at the paged serve's decode shapes
        paged_rows, paged_failures = paged_kernel_rows(dtype, False, side)
        rows += paged_rows
        failures += paged_failures
    rows += flash_rows(side, failures)
    # the engine entry point: Engine.attention plans once, then hits
    q, k, v = _flash_sets(FLASH_SHAPE, torch.bfloat16, 1, seed=4)[0]
    eng = Engine(backend="hopper")
    flash_attention.reset_launches()
    first = eng.attention(q, k, v, causal=True)
    second = eng.attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    entry = {"launches": flash_attention.launches,
             "wgmma_launches": flash_attention.wgmma_launches,
             "plan": eng.plan.stats,
             "equal": bool(torch.equal(first, second))}
    print(f"Engine.attention (hopper) twice at {FLASH_SHAPE}: flash kernel "
          f"launches {entry['launches']} ({entry['wgmma_launches']} on the "
          f"wgmma route), plan {entry['plan']}, outputs "
          f"{'equal' if entry['equal'] else 'DIFFER'}")
    check(entry["launches"] == entry["wgmma_launches"] == 2 and entry["equal"]
          and eng.plan.stats["misses"] == 1 and eng.plan.stats["hits"] == 1,
          f"Engine.attention entry point: {entry}")
    REPORT["attention_kernels"] = rows
    REPORT["engine_attention"] = entry
    check(not failures, f"attention kernel disagrees with its plain version: "
          f"{failures}")
    return {"rows": rows, "entry": entry}


def _serve(gen: int) -> dict:
    """One run of the main path's entry point: weights and prompt drawn
    from SEED, `gen` greedy tokens for each of the BATCH requests."""
    return launch_serve.main(
        ["--arch", ARCH, "--kernel-backend", "hopper", "--batch", str(BATCH),
         "--prompt-len", str(PROMPT), "--seed", str(SEED), "--gen", str(gen)])


def phase_main_path(cfg) -> dict:
    out, result = static_serve("static serve", cfg, _serve, PROMPT)
    launches, reduces = result["launches"], result["reductions"]
    prefill_ms = result["prefill_ms"]
    check(launches["os"] > 0 and launches["ws"] + launches["is"] > 0
          and reduces > 0, f"the static serve ran OS {launches['os']}, "
          f"WS/IS {launches['ws'] + launches['is']} and {reduces} "
          f"reductions: each GEMM kernel must run")
    REPORT["main_path"] = {
        **result, "tokens_per_s": out["tokens_per_s"],
        **_traces(out, prefill_ms, result["decode_ms_per_step"] * (GEN - 1))}
    check_traced_reductions("static serve, traced again",
                            REPORT["main_path"]["trace_serve"], reduces)
    traced = REPORT["main_path"]["trace_prefill"]["matched"]
    want = sum(LAYER_GEMMS[req.k, req.n] * cfg.n_layers
               for req, dec in out["engine"].plan
               if req.op == "gemm" and req.m == BATCH * PROMPT
               and dec.dataflow == "os")
    seen, sync = (traced[WGMMA_KERNEL]["count"],
                  traced["::os_kernel<"]["count"])
    prof = REPORT["main_path"]["trace_prefill"]
    counted, wgmma = prof["os_launches"], prof["os_wgmma_launches"]
    print(f"static serve, traced prefill: {counted} OS GEMMs counted, "
          f"{wgmma} on wgmma; the trace shows {seen} os_wgmma_kernel "
          f"launches ({traced[WGMMA_KERNEL]['ms']:.3f} ms) and {sync} "
          f"os_kernel; the plan's OS decisions at prefill make {want} calls")
    check(counted == wgmma == want and traced_within(seen, wgmma)
          and sync == 0,
          f"the traced prefill: {counted} OS GEMMs counted, {wgmma} on "
          f"wgmma, {seen} traced wgmma and {sync} traced sync, want {want} "
          f"and 0")
    return out


def decision_mix(eng) -> dict:
    """The engine's GEMM decisions by dataflow and slab count, each with
    its request's (M, K, N)."""
    mix = collections.defaultdict(list)
    for req, dec in eng.plan:
        if req.op == "gemm":
            slabs = dec.meta_dict.get("slabs", 1)
            mix[f"{dec.dataflow} x{slabs}"].append([req.m, req.k, req.n])
    return dict(mix)


def _paged_passes(sched) -> dict:
    """Forward passes of a paged serve by GEMM M: the decode ticks at
    M = SLOTS, each prefill call at M = SLOTS x its width."""
    return {SLOTS: sched.stats["decode_steps"],
            **{SLOTS * w: c for w, c in sched.prefill_width_calls.items()}}


def _decode_reductions(eng, per_layer: dict, layers: int) -> int:
    """The reductions one decode tick (M = SLOTS) makes by the plan."""
    return sum(per_layer[req.k, req.n] * layers for req, dec in eng.plan
               if req.op == "gemm" and req.m == SLOTS
               and dec.meta_dict.get("slabs", 1) > 1)


def _untraced_ticks(sched, n: int) -> float:
    """Host wall time (ms) of `n` scheduler ticks, each ending in the
    host reading the tokens back."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        sched.step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _replay_and_trace(params, cfg, scfg, eng, trace, tokens: dict,
                      label: str, match: tuple = (),
                      ticks: int = 10) -> tuple[int, dict]:
    """The served trace again through the same engine (nothing new to
    plan, the same tokens), then `ticks` decode ticks untraced and as
    many traced (all 8 slots decoding: the trace's first 8 requests
    outlive 2 x `ticks` + 1 ticks).  Returns the new plan misses and the
    trace's summary."""
    misses = eng.plan.misses
    again = Scheduler(params, cfg, scfg, engine=eng, prefill_bucket=BUCKET)
    again.run(launch_serve.trace_requests(cfg, trace, SEED))
    new_misses = eng.plan.misses - misses
    same = {u: c.tokens.tolist() for u, c in again.completions.items()} == tokens
    print(f"second pass through the same engine: {new_misses} new plan "
          f"misses, tokens {'identical' if same else 'DIFFER'}")
    check(new_misses == 0, f"{new_misses} new plan misses on the second pass")
    check(same, "the second pass served other tokens")
    del again

    probe = Scheduler(params, cfg, scfg, engine=eng, prefill_bucket=BUCKET)
    for r in launch_serve.trace_requests(cfg, trace, SEED):
        probe.submit(r)
    probe.step()                                   # admit 8, first tick
    untraced = _untraced_ticks(probe, ticks)
    before = (redas_gemm.reduce_launches, grouped_gemm.launches,
              grouped_gemm.wgmma_launches, paged_attention.launches,
              dict(quant_gemm.path_launches))
    prof = _profile(lambda: _untraced_ticks(probe, ticks), match)
    prof.pop("result")
    prof["reduce_launches"] = redas_gemm.reduce_launches - before[0]
    prof["grouped_launches"] = grouped_gemm.launches - before[1]
    prof["grouped_wgmma_launches"] = grouped_gemm.wgmma_launches - before[2]
    prof["paged_launches"] = paged_attention.launches - before[3]
    prof["int8_path_launches"] = {path: quant_gemm.path_launches[path]
                                  - before[4][path]
                                  for path in quant_gemm.PATHS}
    prof["untraced_ms"] = untraced
    prof["idle_share_untraced"] = max(0.0, 1.0 - prof["device_busy_ms"]
                                      / untraced)
    check(probe.stats["admitted"] == SLOTS and probe.stats["finished"] == 0,
          f"the traced ticks were not pure decode: {probe.stats}")
    print(f"trace of {ticks} {label}decode ticks: wall {prof['wall_ms']:.2f} ms, "
          f"device busy {prof['device_busy_ms']:.2f} ms, idle share "
          f"{prof['idle_share']:.2f}; against the untraced {untraced:.2f} ms "
          f"of the {ticks} ticks before, idle share "
          f"{prof['idle_share_untraced']:.2f}")
    for k in prof["top"]:
        print(f"    {k['ms']:9.3f} ms {k['count']:5d} x {k['name']}")
    return new_misses, prof


def phase_scheduler(cfg) -> dict:
    """The paged serve through the entry point, then a second pass
    through the same engine, then a device trace of 10 decode ticks."""
    return paged_serve_phase(ARCH, TRACE, "paged_serve")


def _shared_prefix_requests(cfg) -> list[Request]:
    """12 requests: one 256-token prefix, then 16-128 private tokens each;
    small budgets, so prefill dominates (the shape of the JAX package's
    shared-prefix bench)."""
    rng = np.random.default_rng(SEED)
    prefix = rng.integers(0, cfg.vocab, 256)
    gens = [3, 2, 4, 2, 3, 2, 4, 3, 2, 3, 2, 4]
    return [Request(uid=i, max_new_tokens=g, prompt=np.concatenate(
                [prefix, rng.integers(0, cfg.vocab, int(rng.integers(16, 129)))]
            ).astype(np.int32)) for i, g in enumerate(gens)]


def phase_shared_prefix(cfg, paged_out: dict) -> None:
    reqs = _shared_prefix_requests(cfg)
    max_seq = max(r.prompt.size + r.max_new_tokens for r in reqs) + 1
    runs = {}
    for layout in ("contiguous", "paged"):
        scfg = serve_lib.ServeConfig(
            max_seq=max_seq, batch=4, kernel_backend="hopper",
            cache_layout=layout, page_size=PAGE)
        sched = Scheduler(paged_out["params"], cfg, scfg,
                          prefill_bucket=BUCKET)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = sched.run([dataclasses.replace(r) for r in reqs])
        torch.cuda.synchronize()
        runs[layout] = {"seconds": time.perf_counter() - t0,
                        "tokens": {u: c.tokens.tolist() for u, c in done.items()},
                        "stats": {k: v for k, v in sched.stats.items()
                                  if k != "prefill_widths"},
                        "prefill_ms": sched.timings["prefill_s"] * 1e3}
        if sched.paged is not None:
            sched.paged.check_invariants()
        del sched
    cont, paged = runs["contiguous"], runs["paged"]
    agree = sum(cont["tokens"][u] == paged["tokens"][u] for u in cont["tokens"])
    print(f"shared prefix, 12 requests x (256 + 16..128) over 4 slots: "
          f"prefill tokens contiguous {cont['stats']['prefill_tokens']}, paged "
          f"{paged['stats']['prefill_tokens']} (shared "
          f"{paged['stats']['shared_prefix_tokens']}); prefill "
          f"{cont['prefill_ms']:.2f} -> {paged['prefill_ms']:.2f} ms; served "
          f"in {cont['seconds']:.3f} -> {paged['seconds']:.3f} s; tokens equal "
          f"for {agree}/12 requests (bf16: the two layouts attend in other "
          f"orders)")
    check(paged["stats"]["shared_prefix_tokens"] > 0, "no prefix was shared")
    check(paged["stats"]["prefill_tokens"] < cont["stats"]["prefill_tokens"],
          "prefix sharing did not cut the prefilled tokens")
    REPORT["shared_prefix"] = {**runs, "requests_with_equal_tokens": agree}


def _logit_gap(got: torch.Tensor, ref: torch.Tensor) -> dict:
    got, ref = got.float(), ref.float()
    diff = got - ref
    top = got.argmax(-1)
    # the kernel's top token, scored by the plain logits, within the
    # max-deviation bound of the plain top logit
    near = (ref.max(-1).values - ref.gather(-1, top[..., None])[..., 0]
            <= LOGIT_LIMITS["rel_max"] * ref.abs().max())
    return {"rel_l2": (diff.norm() / ref.norm()).item(),
            "rel_max": (diff.abs().max() / ref.abs().max()).item(),
            "argmax_agreement": (top == ref.argmax(-1)).float().mean().item(),
            "top_within_bound": bool(near.all())}


#: the sparse GEMM's kernels (csrc/sparse_gemm.cu), as the profiler names
#: them
SPARSE_KERNELS = ("sparse_decode_kernel", "sparse_reduce_kernel",
                  "sparse_os_kernel")


def _profile(fn, match: tuple = ()) -> dict:
    """Run `fn` under the profiler: wall and device-busy ms, idle share,
    the six kernels with the most device time, and the device ms of the
    kernels whose names hold each of `match`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [(ev.self_device_time_total / 1e3, ev.count, ev.key)
               for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA]
    kernels.sort(reverse=True)
    busy = sum(ms for ms, _, _ in kernels)
    return {"result": result, "wall_ms": wall, "device_busy_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / wall),
            "top": [{"ms": ms, "count": c, "name": name[:100]}
                    for ms, c, name in kernels[:6]],
            "matched": {key: {"ms": sum(ms for ms, _, name in kernels
                                        if key in name),
                              "count": sum(c for _, c, name in kernels
                                           if key in name)}
                        for key in match}}


def _traces(out: dict, prefill_ms: float, decode_ms: float) -> dict:
    """Device traces of the served run's `generate`, on its own weights,
    prompt, configuration and engine: one with the first token only
    (prefill) and one with all GEN tokens; decode is their difference.
    The profiler slows the host, so each idle share is given twice:
    against the traced wall time and against the untraced served time
    (`prefill_ms`, `decode_ms` for all decode steps)."""
    def run(n):
        return lambda: serve_lib.generate(out["params"], out["cfg"],
                                          out["serve_config"], out["prompt"],
                                          n, embeds=out.get("embeds"),
                                          engine=out["engine"])

    before = (redas_gemm.launches["os"], redas_gemm.os_wgmma_launches)
    prefill = _profile(run(1), GEMM_KERNELS)
    prefill["os_launches"] = redas_gemm.launches["os"] - before[0]
    prefill["os_wgmma_launches"] = redas_gemm.os_wgmma_launches - before[1]
    before = redas_gemm.reduce_launches
    whole = _profile(run(GEN), GEMM_KERNELS)
    whole["reduce_launches"] = redas_gemm.reduce_launches - before
    check(torch.equal(whole.pop("result").cpu(), out["tokens"]),
          "the traced run's tokens differ from the served run's")
    prefill.pop("result")
    wall = whole["wall_ms"] - prefill["wall_ms"]
    busy = whole["device_busy_ms"] - prefill["device_busy_ms"]
    decode = {"wall_ms": wall, "device_busy_ms": busy,
              "idle_share": max(0.0, 1.0 - busy / wall),
              "matched": {key: {k: whole["matched"][key][k]
                                - prefill["matched"][key][k]
                                for k in ("ms", "count")}
                          for key in GEMM_KERNELS}}
    for prof, served in ((prefill, prefill_ms), (whole, prefill_ms + decode_ms),
                         (decode, decode_ms)):
        prof["served_ms"] = served
        prof["idle_share_served"] = max(0.0, 1.0 - prof["device_busy_ms"] / served)
    for name, prof in (("prefill", prefill), (f"whole serve ({GEN} tokens)", whole),
                       (f"decode ({GEN - 1} steps, the difference)", decode)):
        print(f"trace {name}: wall {prof['wall_ms']:.2f} ms, device busy "
              f"{prof['device_busy_ms']:.2f} ms, idle share {prof['idle_share']:.2f}; "
              f"against the untraced {prof['served_ms']:.2f} ms served, idle "
              f"share {prof['idle_share_served']:.2f}")
        for k in prof.get("top", []):
            print(f"    {k['ms']:9.3f} ms {k['count']:5d} x {k['name']}")
    gemm = {"prefill": gemm_trace_line(prefill, 1, "prefill"),
            "decode": gemm_trace_line(decode, GEN - 1, "step")}
    return {"trace_prefill": prefill, "trace_serve": whole,
            "trace_decode": decode, "trace_gemm": gemm}


def prefill_gaps(label: str, params, cfg, prompt, max_seq: int,
                 embeds=None, f32_anchor: bool = False) -> dict:
    """Prefill logits of `hopper` against `torch-ref` on the same weights
    and prompt (and, for scale, plain bf16 `@` against `torch-ref`),
    within LOGIT_LIMITS; with `f32_anchor`, both bf16 runs against the
    f32 model instead (the weights cast to f32, f32 compute, `torch-ref`),
    the kernels' gap within F32_ANCHOR_LIMIT x the plain versions'."""
    dev = prompt.device
    spec = T.CacheSpec(max_seq, prompt.shape[0])

    def run_prefill(backend):
        cache = T.init_cache(cfg, spec, dtype=torch.bfloat16, device=dev)
        with torch.inference_mode():
            if backend is None:  # plain bf16 `@`, no engine
                return T.prefill(params, cfg, prompt, cache,
                                 embeds=embeds)[0]
            with use_engine(Engine(backend=backend)):
                return T.prefill(params, cfg, prompt, cache,
                                 embeds=embeds)[0]

    ref_logits, hop_logits = run_prefill("torch-ref"), run_prefill("hopper")
    lib_logits = run_prefill(None)
    gap = _logit_gap(hop_logits, ref_logits)
    lib_gap = _logit_gap(lib_logits, ref_logits)
    hop_lib_equal = torch.equal(hop_logits, lib_logits)
    print(f"{label}: prefill logits, hopper vs torch-ref on the card: "
          f"rel-L2 {gap['rel_l2']:.4e}, max|diff|/max|ref| {gap['rel_max']:.4e}, "
          f"argmax agreement {gap['argmax_agreement']:.2f} (limits {LOGIT_LIMITS}"
          f"{', not gated: held to the f32 model' if f32_anchor else ''}); "
          f"for scale, plain bf16 @ vs torch-ref: rel-L2 {lib_gap['rel_l2']:.4e}, "
          f"max {lib_gap['rel_max']:.4e}; hopper and plain bf16 @ logits "
          f"{'bitwise equal' if hop_lib_equal else 'differ'}")
    check(all(math.isfinite(v) for v in (gap["rel_l2"], gap["rel_max"])),
          "non-finite logits")
    out = {"prefill_logits": gap, "plain_bf16_matmul_logits": lib_gap,
           "hopper_equals_plain_bf16_matmul": hop_lib_equal,
           "limits": LOGIT_LIMITS}
    if f32_anchor:
        cache = T.init_cache(cfg, spec, dtype=torch.float32, device=dev)
        f32 = _to(params, torch.float32)
        with torch.inference_mode(), use_engine(Engine(backend="torch-ref")):
            exact = T.prefill(f32, cfg, prompt, cache, embeds=embeds,
                              compute_dtype=torch.float32)[0]
        del f32, cache
        out["hopper_vs_f32"] = _logit_gap(hop_logits, exact)
        out["plain_vs_f32"] = _logit_gap(ref_logits, exact)
        out["f32_ratio"] = (out["hopper_vs_f32"]["rel_l2"]
                            / out["plain_vs_f32"]["rel_l2"])
        print(f"{label}: against the f32 model, hopper's bf16 prefill "
              f"logits rel-L2 {out['hopper_vs_f32']['rel_l2']:.4e}, the "
              f"plain versions' {out['plain_vs_f32']['rel_l2']:.4e}: ratio "
              f"{out['f32_ratio']:.3f} (limit {F32_ANCHOR_LIMIT})")
        check(out["f32_ratio"] <= F32_ANCHOR_LIMIT,
              f"{label}: the kernels' logits are {out['f32_ratio']:.3f}x as "
              f"far from the f32 model as the plain versions'")
    else:
        check(gap["rel_l2"] <= LOGIT_LIMITS["rel_l2"]
              and gap["rel_max"] <= LOGIT_LIMITS["rel_max"],
              f"logit gap {gap}")
    check(gap["top_within_bound"], f"top token outside the bound: {gap}")
    return out


def phase_parity(cfg, served: dict) -> None:
    """Prefill logits on the served run's own weights and prompt, and the
    smoke configuration's tokens on the card against the CPU."""
    gaps = prefill_gaps("full width", served["params"], cfg, served["prompt"],
                        PROMPT + GEN + 1)
    dev = served["prompt"].device

    # smoke configuration in f32: tokens on the card == plain versions on CPU
    smoke = get_config(ARCH, smoke=True)
    cpu_params = T.init_params(smoke, generator=torch.Generator().manual_seed(SEED),
                               dtype=torch.float32)
    card_params = _to(cpu_params, dev)
    sprompt = torch.randint(0, smoke.vocab, (2, 24),
                            generator=torch.Generator().manual_seed(SEED + 1),
                            dtype=torch.int32)
    kw = {"max_seq": 33, "batch": 2, "compute_dtype": "float32",
          "cache_dtype": "float32"}
    want = serve_lib.generate(cpu_params, smoke, serve_lib.ServeConfig(
        kernel_backend="torch-ref", device="cpu", **kw), sprompt, 8)
    got = serve_lib.generate(card_params, smoke, serve_lib.ServeConfig(
        kernel_backend="hopper", device="cuda", **kw), sprompt, 8)
    same = torch.equal(got.cpu(), want)
    print(f"smoke config f32, 2 x (24 + 8): tokens on the card "
          f"{'identical to' if same else 'DIFFER from'} the plain versions on the CPU")
    check(same, "smoke tokens differ")
    REPORT["parity"] = {**gaps, "smoke_tokens_identical": same}


def paged_tick_gap(label: str, cfg, paged_out: dict) -> dict:
    """One paged decode tick of a served trace's first 8 requests at full
    width, `hopper` against `torch-ref` from the same state, within
    LOGIT_LIMITS' rel-L2."""
    return tick_gap(f"{label}: paged", paged_out["params"], cfg,
                    paged_out["serve_config"], paged_out["engine"],
                    paged_out["trace"])


def phase_paged_parity(cfg, paged_out: dict) -> None:
    """One paged decode tick at full width, `hopper` against `torch-ref`
    from the same state; then the smoke configuration in f32 through the
    Scheduler: the card's tokens (paged and contiguous) against the plain
    versions' on the CPU."""
    gap = paged_tick_gap("full width", cfg, paged_out)

    smoke = get_config(ARCH, smoke=True)
    cpu_params = T.init_params(smoke, generator=torch.Generator().manual_seed(SEED),
                               dtype=torch.float32)
    card_params = _to(cpu_params, "cuda")
    rng = np.random.default_rng(SEED)
    prefix = rng.integers(0, smoke.vocab, 24)
    spec = [(uid, (np.concatenate([prefix, rng.integers(0, smoke.vocab, 3 + uid)])
                   if uid % 2 else rng.integers(0, smoke.vocab, 5 + 3 * uid)
                   ).astype(np.int32), 4 + uid % 5) for uid in range(8)]
    tokens = {}
    for device, backend, layout in (("cpu", "torch-ref", "paged"),
                                    ("cpu", "torch-ref", "contiguous"),
                                    ("cuda", "hopper", "paged"),
                                    ("cuda", "hopper", "contiguous")):
        sc = serve_lib.ServeConfig(max_seq=48, batch=3, compute_dtype="float32",
                                   cache_dtype="float32", kernel_backend=backend,
                                   device=device, cache_layout=layout,
                                   page_size=8)
        sched = Scheduler(cpu_params if device == "cpu" else card_params, smoke,
                          sc)
        done = sched.run([Request(uid=u, prompt=x, max_new_tokens=g)
                          for u, x, g in spec])
        tokens[(device, layout)] = {u: c.tokens.tolist() for u, c in done.items()}
        if layout == "paged":
            shared = sched.stats["shared_prefix_tokens"]
            check(shared > 0, f"smoke trace shared no prefix on {device}")
    want = tokens[("cpu", "paged")]
    same = {f"{d} {l}": t == want for (d, l), t in tokens.items()}
    print(f"smoke config f32 through the Scheduler, 8 requests over 3 slots "
          f"with a shared 24-token prefix: tokens identical to the CPU's paged "
          f"plain run: {same}")
    check(all(same.values()), f"smoke scheduler tokens differ: {same}")
    REPORT["paged_parity"] = {"decode_tick_logits": gap,
                              "smoke_scheduler_tokens_identical": same}

# --------------------------------------------------------------------------
# qwen2-1.5b under quantize=True: the int8 kernel and the int8 serves
# --------------------------------------------------------------------------


def int8_bound(m: int, k: int, n: int) -> tuple[float, str]:
    """int8 A and B read once and the int32 result written once; 2 M K N
    operations at the dense int8 peak."""
    ops_ms = 2.0 * m * k * n / PEAK_OPS_INT8 * 1e3
    bytes_ms = (m * k + k * n + 4 * m * n) / HBM_BW * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


#: the int8 kernel's two paths (csrc/quant_gemm.cu), as the profiler
#: names them
INT8_KERNELS = ("::decode_kernel<", "::tiled_kernel<")


def int8_path_counts(cfg, decode_passes: int, prefill_passes: int) -> dict:
    """The int8 GEMMs a qwen serve makes by path: 7 a layer a forward
    pass, decode passes (M <= 16) on the decode path, prefill passes on
    the tiled path."""
    per = sum(LAYER_GEMMS.values()) * cfg.n_layers
    return {"decode": per * decode_passes, "tiled": per * prefill_passes}


def check_int8_paths(label: str, want: dict) -> dict:
    """`quant_gemm.path_launches` since the last reset equal `want`."""
    got = dict(quant_gemm.path_launches)
    print(f"{label}: int8 GEMMs by path {got} (want {want})")
    check(got == want, f"{label}: int8 GEMMs by path {got}, not {want}")
    return got


def int8_trace_line(prof: dict, label: str, cfg) -> dict:
    """The int8 kernel's device ms in a trace of 10 decode ticks: the
    wrapper counted 7 decode-path launches a layer a tick and no tiled
    one; the trace shows `decode_kernel` within that count
    (`traced_within`) and no `tiled_kernel`."""
    dec, tiled = (prof["matched"][key] for key in INT8_KERNELS)
    counted = prof["int8_path_launches"]
    want = 10 * sum(LAYER_GEMMS.values()) * cfg.n_layers
    print(f"  the int8 kernel in {label}10 traced ticks: {dec['ms']:.3f} ms "
          f"of device time in {dec['count']} decode_kernel launches "
          f"({dec['ms'] / 10:.3f} ms a tick; want {want} launches), "
          f"{tiled['count']} tiled_kernel launches; the ticks' device busy "
          f"{prof['device_busy_ms']:.2f} ms")
    check(counted == {"decode": want, "tiled": 0}
          and traced_within(dec["count"], want) and tiled["count"] == 0,
          f"{label}traced ticks: counted {counted}, traced {dec['count']} "
          f"decode and {tiled['count']} tiled int8 launches, want {want} "
          f"and 0")
    return {"decode_kernel": dict(dec), "tiled_kernel": dict(tiled),
            "ms_per_tick": dec["ms"] / 10}


def _int8_sets(m, k, n, gen) -> list[tuple]:
    count = max(2, min(64, math.ceil(2 * L2_BYTES / (m * k + k * n))))
    return [tuple(torch.randint(-127, 128, shape, generator=gen, device="cuda",
                                dtype=torch.int32).to(torch.int8)
                  for shape in ((m, k), (k, n))) for _ in range(count)]


def _int8_decision(m, k, n) -> dict:
    """The engine's int8 kernel arguments for a `gemm_w8` of this shape in
    a bf16 serve (`int8_args`: the decode path and its split, or the
    tiled path and its tile)."""
    return int8_args(HopperModel().decide(KernelRequest(
        "gemm_w8", m, k, n, in_bytes=1, out_bytes=2)))


def _int8_options(path: str) -> list[dict]:
    """Every configuration of an int8 kernel path: each split of the
    decode path, or each tile of the tiled menu."""
    if path == "decode":
        return [{"path": "decode", "split_k": s}
                for s in range(1, quant_gemm.DECODE_MAX_SPLIT + 1)]
    return [{"path": "tiled", "tile": t} for t in quant_gemm.TILES]


def _int8_label(kw: dict) -> str:
    return (f"split {kw['split_k']}" if kw["path"] == "decode"
            else f"tile {kw['tile']}")


#: the int8 kernel's (K, N) and M that phase 12 times at every option
#: (the qwen serves' decode and prefill); the rest are checked only
INT8_TIMED_M = (BATCH, SLOTS, BATCH * PROMPT)


def phase_int8_kernel() -> list[dict]:
    """The int8 kernel at qwen's dense shapes (the static decode M = 4, the
    paged decode M = 8, the prefill M = 2048), granite's under --quantize
    (GRANITE_INT8_SHAPES) and a ragged one, against its
    plain version bit for bit at every configuration of both paths (each
    split of the decode path at M <= 16, every tile of the tiled menu),
    each launched twice; at qwen's shapes the time of the engine's
    decision and of every configuration of its path (the pick within
    GEMM_PICK_LIMIT of the fastest), beside the plain version's,
    torch._int_mm's and the bound, and the host's us a call at decode."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    side = torch.cuda.Stream()
    rows, failures = [], []
    for m, k, n in INT8_SHAPES + GRANITE_INT8_SHAPES:
        sets = _int8_sets(m, k, n, gen)
        a, b = sets[0]
        ref = quant_gemm.gemm_int8_reference(a, b)
        pick = _int8_decision(m, k, n)
        configs = _int8_options("tiled") + (
            _int8_options("decode") if m <= quant_gemm.DECODE_ROWS[-1]
            else [])
        wrong = []
        for kw in configs:
            first = quant_gemm.gemm_int8(a, b, **kw)
            again = quant_gemm.gemm_int8(a, b, **kw)
            torch.cuda.synchronize()
            if not (torch.equal(first, ref) and torch.equal(again, first)):
                wrong.append(_int8_label(kw))
        out = quant_gemm.gemm_int8(a, b, **pick)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        timed = m in INT8_TIMED_M and (k, n) in LAYER_GEMMS
        run = functools.partial(quant_gemm.gemm_int8, **pick)
        row = {"m": m, "k": k, "n": n, "path": pick["path"],
               "split_k": pick.get("split_k", 1),
               "tile": list(pick["tile"]) if "tile" in pick else None,
               "ms": device_ms(run, sets, side),
               "max_abs_err": err, "bitwise_every_configuration": not wrong,
               "configurations_checked": len(configs)}
        if timed:
            options = [device_ms(functools.partial(quant_gemm.gemm_int8,
                                                   **kw), sets, side)
                       for kw in _int8_options(pick["path"])]
            row["option_ms"] = options
            row["pick_over_fastest"] = row["ms"] / min(options)
            # torch._int_mm takes M > 16: a decode operand is padded to 32
            pad = 32 - m if m <= 16 else 0
            lib_sets = [(F.pad(x, (0, 0, 0, pad)), y) for x, y in sets]
            row.update(
                plain_ms=device_ms(quant_gemm.gemm_int8_reference, sets, side),
                library_ms=device_ms(torch._int_mm, lib_sets, side),
                library="torch._int_mm" + (" (M padded to 32)" if pad
                                           else ""))
            del lib_sets
            if pick["path"] == "decode":
                row["host_us"] = host_enqueue_us(lambda: run(a, b))
        row["bound_ms"], row["bound_by"] = int8_bound(m, k, n)
        rows.append(row)
        ok = not wrong and err == 0
        slow = timed and row["pick_over_fastest"] > GEMM_PICK_LIMIT
        line = (f"quant_gemm int8 {m}x{k}x{n} {pick['path']} "
                f"{_int8_label(pick)}: int32 "
                f"{'bitwise equal' if ok else 'DIFFERS'} at every one of "
                f"{len(configs)} configurations, each twice"
                f"{'' if not wrong else f' (not at {wrong})'}; kernel "
                f"{row['ms']:.4f} ms")
        if timed:
            names = ("splits 1-8" if pick["path"] == "decode"
                     else f"tiles {list(quant_gemm.TILES)}")
            line += (f" ({names}: "
                     + ", ".join(f"{t:.4f}" for t in row["option_ms"])
                     + f"; pick / fastest {row['pick_over_fastest']:.3f}, "
                     f"limit {GEMM_PICK_LIMIT}), plain {row['plain_ms']:.4f} "
                     f"ms, {row['library']} {row['library_ms']:.4f} ms")
            if "host_us" in row:
                line += f", host {row['host_us']:.1f} us a call"
        print(line + f", bound {row['bound_ms']:.4f} ms ({row['bound_by']})"
              + ("" if ok and not slow else "  FAILED"))
        if not ok:
            failures.append(f"{m}x{k}x{n}: {wrong}, max|diff| {err}")
        if slow:
            failures.append(f"{m}x{k}x{n}: the pick {_int8_label(pick)} "
                            f"takes {row['pick_over_fastest']:.3f}x the "
                            f"fastest")
        del sets
    REPORT["int8_kernel"] = rows
    check(not failures, f"int8 kernel: {failures}")
    return rows


def _int8_params(cfg) -> tuple[dict, dict]:
    """The launcher's bf16 weights (seed SEED) and their quantized tree;
    the bytes of both."""
    params = T.init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(SEED), device="cuda", dtype=torch.bfloat16)
    qparams = quantize_params(params)
    sizes = {"bf16_weight_bytes": tree_bytes(params),
             "int8_weight_bytes": tree_bytes(qparams)}
    del params
    torch.cuda.empty_cache()
    return qparams, sizes


def phase_int8_static(cfg) -> dict:
    """qwen2-1.5b at full width under quantize=True through `generate`:
    4 x (512 + 16), bf16, "hopper-int8" (every dense weight int8, every
    dense matmul on the int8 kernel); then the prefill logits against
    "torch-ref-int8" on the same quantized weights and prompt."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    qparams, sizes = _int8_params(cfg)
    quantize_peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    scfg = serve_lib.ServeConfig(max_seq=PROMPT + GEN + 1, batch=BATCH,
                                 compute_dtype="bfloat16",
                                 cache_dtype="bfloat16", quantize=True)
    check(scfg.kernel_backend == "hopper-int8", f"{scfg.kernel_backend}")
    prompt = torch.randint(0, cfg.vocab, (BATCH, PROMPT), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(
                               SEED + 1), dtype=torch.int32)
    eng = serve_lib.warm_start_engine(scfg)

    def serve(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = serve_lib.generate(qparams, cfg, scfg, prompt, n, engine=eng)
        torch.cuda.synchronize()
        return toks, time.perf_counter() - t0

    serve(2)                                   # warm-up
    first, prefill_s = serve(1)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    tokens, seconds = serve(GEN)
    counts = read_counts()
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    want = {"redas_gemm": 0, "paged_attention": 0, "flash_attention": 0,
            "grouped_gemm": 0, "sparse_gemm": 0, "sparse_gemm_int8": 0,
            "quant_gemm": sum(LAYER_GEMMS.values()) * cfg.n_layers * GEN}
    decode_ms = (seconds - prefill_s) * 1e3 / (GEN - 1)
    print(f"int8 static serve (quantize=True, hopper-int8, bf16, {BATCH} x "
          f"({PROMPT} + {GEN})): {seconds:.3f} s, "
          f"{BATCH * GEN / seconds:.1f} tok/s; prefill and first token "
          f"{prefill_s * 1e3:.2f} ms, decode {decode_ms:.3f} ms/step; weights "
          f"{sizes['int8_weight_bytes'] / 2**30:.3f} GiB int8 tree against "
          f"{sizes['bf16_weight_bytes'] / 2**30:.3f} GiB bf16; max memory "
          f"allocated by the run {peak:.2f} GiB (weights included; "
          f"{quantize_peak:.2f} GiB while quantizing the bf16 tree); plan "
          f"{eng.plan.stats}; kernel launches {counts} (want {want})")
    check(counts == want, f"int8 static serve launches {counts}, not {want}")
    paths = check_int8_paths("int8 static serve",
                             int8_path_counts(cfg, GEN - 1, 1))
    check(tuple(tokens.shape) == (BATCH, GEN)
          and bool(((tokens >= 0) & (tokens < cfg.vocab)).all()),
          f"int8 static tokens {tuple(tokens.shape)}")
    check(torch.equal(first, tokens[:, :1]), "1-token and 16-token runs differ")
    check(sizes["int8_weight_bytes"] < 0.65 * sizes["bf16_weight_bytes"],
          f"weight bytes {sizes}")
    check({req.op for req, _ in eng.plan} == {"gemm_w8"},
          f"plan ops {[req.op for req, _ in eng.plan]}")

    logits = {}
    for backend in ("torch-ref-int8", "hopper-int8"):
        cache = T.init_cache(cfg, T.CacheSpec(PROMPT + GEN + 1, BATCH),
                             dtype=torch.bfloat16, device="cuda")
        with torch.inference_mode(), use_engine(Engine(backend=backend)):
            logits[backend] = T.prefill(qparams, cfg, prompt, cache)[0]
    gap = _logit_gap(logits["hopper-int8"], logits["torch-ref-int8"])
    same = torch.equal(logits["hopper-int8"], logits["torch-ref-int8"])
    print(f"int8 full-width prefill logits, hopper-int8 vs torch-ref-int8 on "
          f"the same quantized weights and prompt: "
          f"{'bitwise equal' if same else 'DIFFER'} (rel-L2 "
          f"{gap['rel_l2']:.4e}, max|diff|/max|ref| {gap['rel_max']:.4e}): "
          f"both take the same int32 sums and the same f32 rescale")
    check(same, f"int8 prefill logits not bitwise equal: {gap}")
    REPORT["int8_static"] = {
        "seconds": seconds, "tokens_per_s": BATCH * GEN / seconds,
        "prefill_ms": prefill_s * 1e3, "decode_ms_per_step": decode_ms,
        "max_memory_gib": peak, "quantize_peak_gib": quantize_peak, **sizes,
        "plan": eng.plan.stats,
        "counts": counts, "int8_paths": paths, "prefill_logits": gap,
        "prefill_logits_bitwise": same, "tokens": tokens.tolist()}
    return qparams


def phase_int8_paged(cfg, qparams) -> None:
    """The paged serve's trace and slots through the Scheduler under
    quantize=True (bf16 cache): launch counts, a second pass, a device
    trace of 10 decode ticks, and one decode tick's logits against
    "torch-ref-int8"."""
    trace = launch_serve.parse_trace(POSTURE_TRACE)
    scfg = serve_lib.ServeConfig(
        max_seq=max(p + g for p, g in trace) + 1, batch=SLOTS,
        compute_dtype="bfloat16", cache_dtype="bfloat16", quantize=True,
        cache_layout="paged", page_size=PAGE)
    sched = Scheduler(qparams, cfg, scfg, prefill_bucket=BUCKET)
    eng = sched.engine
    check(eng.backend == "hopper-int8", f"engine {eng.backend}")
    reqs = launch_serve.trace_requests(cfg, trace, SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_counts()
    t0 = time.perf_counter()
    sched.run(reqs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    st = sched.stats
    ticks, calls = st["decode_steps"], st["prefill_calls"]
    n_tok = sum(len(c.tokens) for c in sched.completions.values())
    tick_ms = sched.timings["decode_s"] * 1e3 / ticks
    plan = dict(eng.plan.stats)
    want = {"redas_gemm": 0, "grouped_gemm": 0, "flash_attention": 0,
            "sparse_gemm": 0, "sparse_gemm_int8": 0,
            "paged_attention": cfg.n_layers * ticks,
            "quant_gemm": sum(LAYER_GEMMS.values()) * cfg.n_layers
            * (ticks + calls)}
    tokens = {u: c.tokens.tolist() for u, c in sched.completions.items()}
    print(f"int8 paged serve (quantize=True, bf16 cache): "
          f"{len(sched.completions)} requests / {n_tok} tokens in "
          f"{seconds:.3f} s, {n_tok / seconds:.1f} tok/s over {SLOTS} slots; "
          f"{ticks} decode ticks, {tick_ms:.3f} ms per tick (mean); {calls} "
          f"prefill calls of widths {sorted(st['prefill_widths'])}, "
          f"{sched.timings['prefill_s'] * 1e3:.2f} ms in all; plan "
          f"{plan}; kernel launches {counts} (want {want}); peak "
          f"memory above what the script held {peak:.3f} GiB")
    check(len(sched.completions) == len(trace), "int8 paged served too few")
    check(counts == want, f"int8 paged serve launches {counts}, not {want}")
    paths = check_int8_paths("int8 paged serve",
                             int8_path_counts(cfg, ticks, calls))
    for uid, toks in tokens.items():
        check(len(toks) == trace[uid][1]
              and all(0 <= t < cfg.vocab for t in toks), f"request {uid}")
    sched.paged.check_invariants()
    new_misses, prof = _replay_and_trace(qparams, cfg, scfg, eng, trace,
                                         tokens, "int8 ", INT8_KERNELS)
    prof["int8_kernel"] = int8_trace_line(prof, "int8 ", cfg)

    gap = _decode_tick_gap(qparams, cfg, scfg, eng, trace)
    print(f"int8 full-width paged decode tick logits (8 slots), hopper-int8 "
          f"vs torch-ref-int8: rel-L2 {gap['rel_l2']:.4e}, max|diff|/max|ref| "
          f"{gap['rel_max']:.4e}, argmax agreement "
          f"{gap['argmax_agreement']:.2f} (limit rel-L2 "
          f"{LOGIT_LIMITS['rel_l2']}; the paged kernel sums in another order)")
    REPORT["int8_paged"] = {
        "trace": POSTURE_TRACE, "slots": SLOTS, "seconds": seconds,
        "tokens_per_s": n_tok / seconds, "tokens": n_tok,
        "decode_ticks": ticks, "decode_ms_per_tick": tick_ms,
        "prefill_calls": calls, "prefill_widths": sorted(st["prefill_widths"]),
        "prefill_ms": sched.timings["prefill_s"] * 1e3, "plan": plan,
        "counts": counts, "int8_paths": paths, "max_memory_gib": peak,
        "second_pass_new_misses": new_misses, "trace_10_ticks": prof,
        "decode_tick_logits": gap}
    check(math.isfinite(gap["rel_l2"]) and gap["rel_l2"] <= LOGIT_LIMITS["rel_l2"],
          f"int8 paged decode logit gap {gap}")


def phase_int8_smoke_parity(cache_dtype: str = "float32") -> None:
    """qwen2-1.5b SMOKE in f32 under quantize=True, weights quantized on
    the CPU: the card's tokens equal the CPU's plain run, static
    (`generate`) and through the Scheduler, paged and contiguous.  With
    cache_dtype="int8" (the full --quantize posture) also the int8 cache
    alone (float weights, "hopper"), paged."""
    smoke = get_config(ARCH, smoke=True)
    float_params = T.init_params(
        smoke, generator=torch.Generator().manual_seed(SEED),
        dtype=torch.float32)
    cpu_params = quantize_params(float_params)
    card_params = _to(cpu_params, "cuda")
    result = {}
    sprompt = torch.randint(0, smoke.vocab, (2, 24),
                            generator=torch.Generator().manual_seed(SEED + 1),
                            dtype=torch.int32)
    kw = {"max_seq": 33, "batch": 2, "compute_dtype": "float32",
          "cache_dtype": cache_dtype, "quantize": True}
    want = serve_lib.generate(cpu_params, smoke, serve_lib.ServeConfig(
        device="cpu", **kw), sprompt, 8)
    quant_gemm.reset_launches()
    got = serve_lib.generate(card_params, smoke, serve_lib.ServeConfig(
        device="cuda", **kw), sprompt, 8)
    check(quant_gemm.launches == 7 * smoke.n_layers * 8,
          f"smoke static int8 launches {quant_gemm.launches}")
    result["static"] = torch.equal(got.cpu(), want)
    rng = np.random.default_rng(SEED)
    prefix = rng.integers(0, smoke.vocab, 24)
    spec = [(uid, (np.concatenate([prefix, rng.integers(0, smoke.vocab, 3 + uid)])
                   if uid % 2 else rng.integers(0, smoke.vocab, 5 + 3 * uid)
                   ).astype(np.int32), 4 + uid % 5) for uid in range(8)]
    tokens = {}
    runs = [(device, layout, True) for device in ("cpu", "cuda")
            for layout in ("paged", "contiguous")]
    if cache_dtype == "int8":
        runs += [("cpu", "paged", False), ("cuda", "paged", False)]
    for device, layout, quant in runs:
        sc = serve_lib.ServeConfig(max_seq=48, batch=3, compute_dtype="float32",
                                   cache_dtype=cache_dtype, quantize=quant,
                                   kernel_backend="hopper", device=device,
                                   cache_layout=layout, page_size=8)
        params = cpu_params if quant else float_params
        paged_attention.reset_launches()
        sched = Scheduler(params if device == "cpu" else _to(params, "cuda"),
                          smoke, sc)
        done = sched.run([Request(uid=u, prompt=x, max_new_tokens=g)
                          for u, x, g in spec])
        tokens[(device, layout, quant)] = {u: c.tokens.tolist()
                                           for u, c in done.items()}
        if layout == "paged":
            check(sched.stats["shared_prefix_tokens"] > 0,
                  f"smoke trace shared no prefix on {device}")
            check(device == "cpu" or paged_attention.launches > 0,
                  "the paged kernel did not run on the card")
    for layout, quant in dict.fromkeys((lay, q) for _, lay, q in runs):
        name = f"scheduler {layout}" + ("" if quant else ", float weights")
        result[name] = (tokens[("cuda", layout, quant)]
                        == tokens[("cpu", layout, quant)])
    label = "full --quantize posture" if cache_dtype == "int8" else "float KV"
    print(f"int8 SMOKE f32 (quantize=True, {label}): card tokens identical "
          f"to the CPU's plain run: {result}")
    REPORT["int8_smoke_parity" + ("_int8_kv" if cache_dtype == "int8"
                                  else "")] = result
    check(all(result.values()), f"int8 smoke tokens differ: {result}")


def phase_paged_int8_kernel() -> list[dict]:
    """The int8-pool variant of the paged kernel at the paged decode
    shapes, bf16 and f32 q, against its plain version."""
    side = torch.cuda.Stream()
    rows, failures = [], []
    for dtype in (torch.bfloat16, torch.float32):
        more, bad = paged_kernel_rows(dtype, True, side)
        rows += more
        failures += bad
    REPORT["paged_int8_kernel"] = rows
    check(not failures, f"int8-pool paged kernel disagrees with its plain "
          f"version: {failures}")
    return rows


def _quantize_serve(gen: int) -> dict:
    """The launcher's --quantize static serve: BATCH requests of PROMPT
    tokens, weights and prompt from SEED."""
    return launch_serve.main(
        ["--arch", ARCH, "--quantize", "--batch", str(BATCH), "--prompt-len",
         str(PROMPT), "--seed", str(SEED), "--gen", str(gen)])


def phase_quantize_static(cfg) -> None:
    """qwen2-1.5b through `launch.serve --quantize` at full width: int8
    weights, contiguous int8 KV, "hopper-int8"; attention is plain torch
    over the int8 rows and their scales, as in the reference."""
    _quantize_serve(1)                         # warm-up
    first = _quantize_serve(1)
    first_tokens, prefill_ms = first["tokens"], first["seconds"] * 1e3
    del first
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_counts()
    out = _quantize_serve(GEN)
    counts = read_counts()
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    scfg, tokens = out["serve_config"], out["tokens"]
    decode_ms = (out["seconds"] * 1e3 - prefill_ms) / (GEN - 1)
    want = {"redas_gemm": 0, "paged_attention": 0, "flash_attention": 0,
            "grouped_gemm": 0, "sparse_gemm": 0, "sparse_gemm_int8": 0,
            "quant_gemm": sum(LAYER_GEMMS.values()) * cfg.n_layers * GEN}
    print(f"--quantize static serve ({BATCH} x ({PROMPT} + {GEN}), "
          f"{scfg.kernel_backend}, cache {scfg.cache_dtype}): "
          f"{out['seconds']:.3f} s, {out['tokens_per_s']:.1f} tok/s; prefill "
          f"and first token {prefill_ms:.2f} ms, decode {decode_ms:.3f} "
          f"ms/step; max memory allocated by the run {peak:.2f} GiB; plan "
          f"{out['engine_plan']}; kernel launches {counts} (want {want})")
    check((scfg.kernel_backend, scfg.cache_dtype) == ("hopper-int8",
                                                      torch.int8),
          f"--quantize gave {scfg.kernel_backend}, {scfg.cache_dtype}")
    check(counts == want, f"--quantize static launches {counts}, not {want}")
    paths = check_int8_paths("--quantize static serve",
                             int8_path_counts(cfg, GEN - 1, 1))
    check(tuple(tokens.shape) == (BATCH, GEN)
          and bool(((tokens >= 0) & (tokens < cfg.vocab)).all()),
          f"--quantize static tokens {tuple(tokens.shape)}")
    check(torch.equal(first_tokens, tokens[:, :1]),
          "1-token and 16-token --quantize runs differ")
    REPORT["quantize_static"] = {
        "seconds": out["seconds"], "tokens_per_s": out["tokens_per_s"],
        "prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
        "max_memory_gib": peak, "plan": out["engine_plan"], "counts": counts,
        "int8_paths": paths, "tokens": tokens.tolist()}


def _decode_tick_gap(params, cfg, scfg, eng, trace,
                     backends=("torch-ref-int8", "hopper-int8")) -> dict:
    """One decode tick at full width from one state, the kernels' backend
    against its plain twin (`backends` = (plain, kernels)): the slots
    admitted by the trace's first Scheduler step, each at its decode
    frontier (on a paged plane, with its next page ensured).  Both ticks
    start from the same state: decode_step writes only each slot's row at
    its clock (the second tick overwrites the first's) and returns the
    advanced clock in a new dict, and a recurrent block's state, which
    a tick updates in place, is restored before each tick.  Each
    tick's kernel launches are kept.  For a MoE model the kernels' tick
    runs twice: free (its routers' top-k sets that differ from the plain
    tick's are counted) and on the plain tick's expert choices
    (`_PinTopk`; the gap under "pinned")."""
    probe = Scheduler(params, cfg, scfg, engine=eng, prefill_bucket=BUCKET)
    for r in launch_serve.trace_requests(cfg, trace, SEED):
        probe.submit(r)
    probe.step()                                  # admit 8, first tick
    bt = None
    if probe.paged is not None:
        for i, s in enumerate(probe.slots):
            probe.paged.ensure_decode_page(
                i, s.req.prompt.size + len(s.emitted) - 1)
        bt = torch.from_numpy(probe.paged.tables).cuda()
    toks = torch.tensor([[s.last_token] for s in probe.slots],
                        dtype=torch.int32, device="cuda")
    active = torch.ones(SLOTS, dtype=torch.bool, device="cuda")
    states = [(c, {n: c[n].clone() for n in ("conv", "state", "h") if n in c})
              for c in [*probe.cache["slots"].values(), *probe.cache["tail"]]]

    def tick(backend, mode):
        for c, saved in states:
            for name, value in saved.items():
                c[name].copy_(value)
        before = read_counts()
        with torch.inference_mode(), use_engine(Engine(backend=backend)), \
                mode:
            out = T.decode_step(params, cfg, probe.cache, toks,
                                active=active, block_tables=bt)[0]
        after = read_counts()
        return out, {k: after[k] - before[k] for k in after}

    plain, kernels = backends
    ref, launches = tick(plain, rec := _TopkSets())
    got, launches_k = tick(kernels, rec_k := _TopkSets())
    gap = _logit_gap(got, ref)
    gap["kv_len"] = (probe.cache["t"] + 1).tolist()
    gap["paged_plane"] = probe.paged is not None
    gap["launches"] = {plain: launches, kernels: launches_k}
    if cfg.moe is not None:
        gap["topk_sets_differing"] = sum(
            int((a != b).any(dim=-1).sum())
            for a, b in zip(rec_k.sets, rec.sets, strict=True))
        gap["token_layer_pairs"] = SLOTS * len(rec.sets)
        gap["pinned"] = _logit_gap(tick(kernels, _PinTopk(rec.raw))[0], ref)
    return gap


def tick_gap(label: str, params, cfg, scfg, eng, trace,
             backends=("torch-ref", "hopper")) -> dict:
    """`_decode_tick_gap`, printed and held within LOGIT_LIMITS' rel-L2 (a
    MoE model's on the plain tick's expert choices, its free gap and the
    top-k sets that differ printed beside), the plain tick launching no
    kernel and the kernels' tick launching some, the paged kernel once a
    paged layer where there is a paged plane."""
    gap = _decode_tick_gap(params, cfg, scfg, eng, trace, backends)
    plain, kernels = (gap["launches"][b] for b in backends)
    held = gap.get("pinned", gap)
    moe = ("" if "pinned" not in gap else
           f"; on the plain tick's expert choices rel-L2 "
           f"{held['rel_l2']:.4e}, max|diff|/max|ref| {held['rel_max']:.4e}"
           f" ({gap['topk_sets_differing']} of {gap['token_layer_pairs']} "
           f"(token, layer) top-k sets differ in the free tick)")
    print(f"{label}: decode tick logits ({SLOTS} slots, kv_len "
          f"{gap['kv_len']}), {backends[1]} vs {backends[0]}: rel-L2 "
          f"{gap['rel_l2']:.4e}, max|diff|/max|ref| {gap['rel_max']:.4e}, "
          f"argmax agreement {gap['argmax_agreement']:.2f}{moe} (limit "
          f"rel-L2 {LOGIT_LIMITS['rel_l2']}); kernel launches "
          f"{ {k: v for k, v in kernels.items() if v} }")
    check(math.isfinite(held["rel_l2"])
          and held["rel_l2"] <= LOGIT_LIMITS["rel_l2"],
          f"{label}: decode tick logit gap {gap}")
    paged = paged_layers(cfg) if gap["paged_plane"] else 0
    check(not any(plain.values()) and any(kernels.values())
          and kernels["paged_attention"] == paged,
          f"{label}: the tick's launches, {backends[0]} {plain}, "
          f"{backends[1]} {kernels} (want the paged kernel {paged} times)")
    return gap


def phase_quantize_paged(cfg) -> dict:
    """The paged serve's trace through `launch.serve --quantize`: the
    Scheduler on int8 pools, every decode tick on the int8 GEMM and the
    int8-pool paged kernel."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_counts()
    out = launch_serve.main(SERVE_ARGS + ["--quantize"])
    counts = read_counts()
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    sched, eng, scfg = out["scheduler"], out["engine"], out["serve_config"]
    st = sched.stats
    ticks, calls = st["decode_steps"], st["prefill_calls"]
    tick_ms = sched.timings["decode_s"] * 1e3 / ticks
    want = {"redas_gemm": 0, "grouped_gemm": 0, "flash_attention": 0,
            "sparse_gemm": 0, "sparse_gemm_int8": 0,
            "paged_attention": cfg.n_layers * ticks,
            "quant_gemm": sum(LAYER_GEMMS.values()) * cfg.n_layers
            * (ticks + calls)}
    pools = sched.cache["slots"]["b0"]
    rows = tree_bytes({k: v for k, v in sched.cache["slots"].items()})
    scale_bytes = tree_bytes([pools["k_scale_pages"], pools["v_scale_pages"]])
    row_bytes = rows - scale_bytes
    bf16_bytes = 2 * row_bytes                 # the same pool at 2 B a value
    tokens = {u: c.tokens.tolist() for u, c in sched.completions.items()}
    print(f"--quantize paged serve ({scfg.kernel_backend}, "
          f"{pools['k_pages'].dtype} pools): {out['requests']} requests / "
          f"{out['tokens']} tokens in {out['seconds']:.3f} s, "
          f"{out['tokens_per_s']:.1f} tok/s over {SLOTS} slots; {ticks} decode "
          f"ticks, {tick_ms:.3f} ms per tick (mean); {calls} prefill calls of "
          f"widths {sorted(st['prefill_widths'])}, "
          f"{sched.timings['prefill_s'] * 1e3:.2f} ms in all; plan "
          f"{eng.plan.stats}; kernel launches {counts} (want {want}); KV pool "
          f"{row_bytes / 2**20:.2f} MiB of int8 rows + "
          f"{scale_bytes / 2**20:.2f} MiB of scales against "
          f"{bf16_bytes / 2**20:.2f} MiB in bf16; peak memory above what the "
          f"script held {peak:.3f} GiB")
    check(pools["k_pages"].dtype == torch.int8
          and pools["k_scale_pages"].dtype == torch.float32,
          f"pools {pools['k_pages'].dtype}")
    check(out["requests"] == len(launch_serve.parse_trace(POSTURE_TRACE)),
          f"served {out['requests']} requests")
    check(counts == want, f"--quantize paged launches {counts}, not {want}")
    paths = check_int8_paths("--quantize paged serve",
                             int8_path_counts(cfg, ticks, calls))
    for uid, toks in tokens.items():
        check(len(toks) == out["trace"][uid][1]
              and all(0 <= t < cfg.vocab for t in toks), f"request {uid}")
    check(rows < 0.55 * bf16_bytes, f"KV bytes {rows} against {bf16_bytes}")
    sched.paged.check_invariants()
    new_misses, prof = _replay_and_trace(out["params"], cfg, scfg, eng,
                                         out["trace"], tokens, "--quantize ",
                                         INT8_KERNELS)
    prof["int8_kernel"] = int8_trace_line(prof, "--quantize ", cfg)
    gap = _decode_tick_gap(out["params"], cfg, scfg, eng, out["trace"])
    print(f"--quantize full-width paged decode tick logits (8 slots, int8 "
          f"pools), hopper-int8 vs torch-ref-int8: rel-L2 "
          f"{gap['rel_l2']:.4e}, max|diff|/max|ref| {gap['rel_max']:.4e}, "
          f"argmax agreement {gap['argmax_agreement']:.2f} (limit rel-L2 "
          f"{LOGIT_LIMITS['rel_l2']})")
    REPORT["quantize_paged"] = {
        "trace": POSTURE_TRACE, "slots": SLOTS, "seconds": out["seconds"],
        "tokens_per_s": out["tokens_per_s"], "tokens": out["tokens"],
        "decode_ticks": ticks, "decode_ms_per_tick": tick_ms,
        "prefill_calls": calls, "prefill_widths": sorted(st["prefill_widths"]),
        "prefill_ms": sched.timings["prefill_s"] * 1e3,
        "plan": eng.plan.stats, "counts": counts, "int8_paths": paths,
        "max_memory_gib": peak, "kv_row_bytes": row_bytes,
        "kv_scale_bytes": scale_bytes,
        "kv_bf16_bytes": bf16_bytes, "second_pass_new_misses": new_misses,
        "trace_10_ticks": prof, "decode_tick_logits": gap}
    check(math.isfinite(gap["rel_l2"]) and gap["rel_l2"] <= LOGIT_LIMITS["rel_l2"],
          f"--quantize paged decode logit gap {gap}")
    return REPORT["quantize_paged"]


def paged_int8_line(rows: list[dict], qpaged: dict) -> dict:
    """Per call at the paged decode tick in bf16 over int8 pools; launches
    from the --quantize paged serve (every launch there is on int8
    pools)."""
    main = next(r for r in rows if r["dtype"] == "bfloat16")
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library")
    return {"name": "paged_attention_int8", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:195",
            "launches": qpaged["counts"]["paged_attention"],
            "launches_by_serve": {
                "quantize_paged_serve": qpaged["counts"]["paged_attention"],
                **{f"granite_quantize_{serve}":
                   run["counts"]["paged_attention"] for serve, run
                   in REPORT["granite_quantize"].items()}},
            "per": f"call, bf16 q, {main['shape']}, kv_len {main['kv_len']}",
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            **{k: main[k] for k in keys}}


def int8_lines(rows: list[dict]) -> list[dict]:
    """The int8 static serve's GEMM work by path (decode: the 15 decode
    steps at M = 4; tiled: the prefill at M = 2048): each shape's time at
    the engine's decision, weighted by the launches that serve makes (the
    bound, plain version and torch._int_mm likewise); launches by path
    from the int8 static and paged serves and the traced ticks."""
    cfg = get_config(ARCH)
    static, paged = REPORT["int8_static"], REPORT["int8_paged"]
    qstatic, qpaged = REPORT["quantize_static"], REPORT["quantize_paged"]
    lines = []
    for path, m, steps, kernel in (("decode", BATCH, GEN - 1,
                                    "decode_kernel"),
                                   ("tiled", BATCH * PROMPT, 1,
                                    "tiled_kernel")):
        totals = dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms"),
                               0.0)
        ops_ms = bytes_ms = 0.0
        errs = []
        for (k, n), per_layer in LAYER_GEMMS.items():
            row = next(r for r in rows if (r["m"], r["k"], r["n"]) == (m, k, n))
            check(row["path"] == path, f"{m}x{k}x{n} planned {row['path']}")
            calls = per_layer * cfg.n_layers * steps
            for key in totals:
                totals[key] += calls * row[key]
            ops_ms += calls * 2.0 * m * k * n / PEAK_OPS_INT8 * 1e3
            bytes_ms += calls * (m * k + k * n + 4 * m * n) / HBM_BW * 1e3
            errs.append(row["max_abs_err"])
        errs += [r["max_abs_err"] for r in rows if r["path"] == path]
        lines.append({
            "name": f"quant_gemm_{path}", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/quant_gemm.cu",
            "replaces": "src/repro/kernels/quant_gemm.py:148",
            "kernel": kernel,
            "launches": static["int8_paths"][path],
            "launches_by_serve": {
                "int8_static_serve": static["int8_paths"][path],
                "int8_paged_serve": paged["int8_paths"][path],
                "quantize_static_serve": qstatic["int8_paths"][path],
                "quantize_paged_serve": qpaged["int8_paths"][path],
                **{f"granite_quantize_{serve}": run["int8_paths"][path]
                   for serve, run in REPORT["granite_quantize"].items()},
                **{f"{label.split()[0]}_smoke_quantize_card": sum(
                    run.get(path, 0) for run in by_run.values())
                   for label, by_run in REPORT["new_smoke_parity"][
                       "card_int8_paths"].items() if "--quantize" in label}},
            "traced_10_quantize_ticks_ms":
                qpaged["trace_10_ticks"]["int8_kernel"][kernel]["ms"],
            "per": f"the int8 static serve's {static['int8_paths'][path]} "
                   f"{path} launches at M = {m}, summed",
            "max_abs_err": max(errs),
            "ms": totals["ms"], "plain_ms": totals["plain_ms"],
            "bound_ms": totals["bound_ms"],
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": totals["library_ms"],
            "library": "torch._int_mm" + (" (M padded to 32)"
                                          if path == "decode" else "")})
        print(f"quant_gemm {path} path over the int8 static serve's "
              f"{lines[-1]['launches']} calls: {totals['ms']:.3f} ms, plain "
              f"{totals['plain_ms']:.3f}, torch._int_mm "
              f"{totals['library_ms']:.3f}, bound {totals['bound_ms']:.3f} "
              f"({lines[-1]['bound_by']})")
    return lines


# --------------------------------------------------------------------------
# qwen2-1.5b under --sparsity 2:4 (float values) and under --sparsity 2:4
# --quantize (sparse x int8: int8 values and per-column scales): the sparse
# kernel's two variants and their serves
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Posture:
    """What tells the two sparse postures apart in phases 17-23."""
    quantize: bool      # int8 values and scales (the launcher's --quantize)
    label: str          # of the printed lines
    report: str         # the prefix of its REPORT keys
    counter: str        # `read_counts` key of the variant it runs
    other: str          # the other variant's key, which must stay 0
    cache: torch.dtype  # the launcher's KV cache
    in_bytes: int       # its requests' key under bf16 activations

    @property
    def flags(self) -> list[str]:
        return ["--sparsity", "2:4"] + (["--quantize"] if self.quantize
                                        else [])

    def paths(self) -> dict:
        return dict(sparse_gemm.int8_path_launches if self.quantize
                    else sparse_gemm.path_launches)


FLOAT_SPARSE = Posture(False, "--sparsity", "sparse", "sparse_gemm",
                       "sparse_gemm_int8", torch.bfloat16, 2)
INT8_SPARSE = Posture(True, "sparse x int8", "sparse_int8",
                      "sparse_gemm_int8", "sparse_gemm", torch.int8, 1)


def sparse_bound(m: int, k: int, n: int, itemsize: int, n_keep: int = 2,
                 m_group: int = 4, quantize: bool = False
                 ) -> tuple[float, str]:
    """2 M K N x density operations at the activations' peak; A read once,
    the compressed weight (values at their itemsize, int8 ones at one
    byte with the N f32 scales, and one index byte per kept value) read
    once, the output written once."""
    k_c = -(-k // m_group) * n_keep
    weight = (k_c * n * 2 + 4 * n if quantize
              else k_c * n * (itemsize + 1))
    return _bound_of(2.0 * m * k * n * n_keep / m_group,
                     (m * k + m * n) * itemsize + weight, itemsize)


def _sparse_sets(m, k, n, dtype, gen, n_keep, m_group, count=None,
                 quantize=False, extremes=False):
    """Operand sets (past the L2 unless `count` is given): activations, a
    random weight pruned by `sparsify` (with `quantize` its values int8
    and scaled) as values, indices and scale (None for float values), and
    the same weight densified (and scaled) ahead of time in `dtype` for
    the library yardstick.  With `extremes`, column 7 is all zero (scale
    1.0) and column 11 holds +-50 at every kept place (int8 values -127
    and 127)."""
    size = torch.tensor([], dtype=dtype).element_size()
    per = m * k * size + -(-k // m_group) * n_keep * n * (
        (1 if quantize else size) + 1)
    count = count or max(2, min(32, math.ceil(2 * L2_BYTES / per)))
    sets = []
    for _ in range(count):
        a = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
        w = torch.randn(k, n, generator=gen, device="cuda") / math.sqrt(k)
        if extremes:
            w[:, 7] = 0.0
            w[::2, 11], w[1::2, 11] = 50.0, -50.0
        st = sparsify(w.to(dtype), n_keep, m_group, quantize=quantize)
        sets.append((a, st.values, st.indices, st.scale, st.densify(dtype)))
    return sets


def reduce_bound(split: int, m: int, n: int,
                 out_itemsize: int) -> tuple[float, str]:
    """The split-K reduction: the f32 partials read once and the output
    written once; (split - 1) M N f32 additions."""
    return _bound_of((split - 1) * m * n, split * m * n * 4
                     + m * n * out_itemsize, 4)


def _sparse_configs(m: int, k: int, m_group: int, planned: dict) -> list:
    """The kernel arguments a sparse kernel case is held at: the engine's
    decision; at M <= 16 the decode path at split 1, the planner's and
    the largest the shape allows (one group a split)."""
    configs = [planned]
    if m <= sparse_gemm.DECODE_ROWS[-1]:
        for split in (1, sparse_gemm.max_split(k, m_group)):
            conf = {"path": "decode", "split_k": split}
            if conf not in configs:
                configs.append(conf)
    return configs


def _sparse_cases(quantize: bool) -> list[tuple]:
    """(M, K, N, A's dtype, n_keep, m_group, out dtype, kind) of the
    sparse kernel phase.  kind: "timed" at the engine's decision; "timed,
    menu" also at every tile of the tiled menu; "menu" untimed, with the
    menu; "any index" as "menu" with offsets -2..8 (out of range,
    repeated); "extremes" as "menu" on `_sparse_sets`' extremes."""
    bf16, f32 = torch.bfloat16, torch.float32
    main = [BATCH, SLOTS, BATCH * PROMPT]
    if not quantize:
        return ([(m, k, n, bf16, 2, 4, bf16, "timed")
                 for m in main for k, n in LAYER_GEMMS]
                + [(BATCH, 1536, 8960, f32, 2, 4, f32, "timed"),
                   (BATCH * PROMPT, 1536, 1536, f32, 2, 4, f32, "timed")]
                + [(m, 8960, 1536, bf16, 2, 4, bf16, "menu")
                   for m in (1, 16, 17)]
                + [(SLOTS, 1536, 1536, bf16, nk, mg, bf16, "menu")
                   for nk, mg in ((1, 2), (1, 4), (4, 8), (3, 7))]
                + [(5, 1003, 200, bf16, 2, 4, bf16, "menu"),
                   (5, 1003, 200, bf16, 2, 4, f32, "menu"),
                   (5, 1003, 200, f32, 3, 7, f32, "any index")])
    return ([(m, k, n, bf16, 2, 4, bf16,
              "timed" if m <= sparse_gemm.DECODE_ROWS[-1] else "timed, menu")
             for m in main for k, n in LAYER_GEMMS]
            + [(BATCH, 1536, 8960, f32, 2, 4, f32, "timed")]
            + [(SLOTS, 1536, 1536, bf16, nk, mg, bf16, "menu")
               for nk, mg in ((1, 2), (4, 8), (3, 7))]
            + [(5, 1003, 200, bf16, 2, 4, f32, "menu"),
               (SLOTS, 1536, 1536, bf16, 2, 4, bf16, "extremes"),
               (BATCH * PROMPT, 1536, 1536, bf16, 2, 4, bf16, "extremes")])


def phase_sparse_kernel(p: Posture) -> list[dict]:
    """The sparse kernel's variant of posture `p` against its plain
    version on both paths (`_sparse_cases`): qwen's dense shapes at 2:4
    with bf16 activations (M = 4, 8 on the decode path, 2048 on the tiled
    one, each at the engine's decision, timed beside the plain version,
    torch.matmul over the weight densified (and scaled) ahead of time and
    the bound; the decode shapes' split-K reduction (with int8 values the
    scaled one) timed alone and held to its plain version bit for bit),
    f32 activations, other N:M specs, a ragged shape, and for float values
    M = 1, 16, 17 and an index array with offsets out of range and
    repeated, for int8 values an all-zero column (scale 1.0) and values
    of -127 and 127.  Every case runs at the decision and, at M <= 16, at
    split 1 and the largest split; every configuration twice, the two
    outputs bit for bit equal."""
    gen = torch.Generator(device="cuda").manual_seed(9 if p.quantize else 8)
    side = torch.cuda.Stream()
    rows, failures = [], []
    variant = "sparse_gemm int8 values" if p.quantize else "sparse_gemm"
    for m, k, n, dtype, nk, mg, out_dtype, kind in _sparse_cases(p.quantize):
        timed = kind.startswith("timed")
        sets = _sparse_sets(m, k, n, dtype, gen, nk, mg,
                            None if timed else 1, p.quantize,
                            kind == "extremes")
        if kind == "any index":
            sets = [(a, v, torch.randint(-2, 9, i.shape, generator=gen,
                                         device="cuda", dtype=torch.int8),
                     s, w) for a, v, i, s, w in sets]
        a, v, i, s, _ = sets[0]
        size = a.element_size()
        tol = F32_ROW_TOL if out_dtype == torch.float32 else BF16_ROW_TOL
        kw = {"n_keep": nk, "m_group": mg}
        ref = sparse_gemm.sparse_gemm_reference(a, v, i, s,
                                                out_dtype=out_dtype, **kw)
        dec = HopperModel().decide(KernelRequest(
            "gemm_sparse", m, k, n, in_bytes=1 if p.quantize else size,
            out_bytes=size, density=nk / mg))
        planned = sparse_args(dec)
        want_path = ("decode" if m <= sparse_gemm.DECODE_ROWS[-1]
                     else "tiled")
        check(planned["path"] == want_path,
              f"{variant} {m}x{k}x{n} planned {planned}, not the "
              f"{want_path} path")
        configs = _sparse_configs(m, k, mg, planned)
        if kind != "timed":
            configs += [{"path": "tiled", "tile": t}
                        for t in sparse_gemm.TILES
                        if {"path": "tiled", "tile": t} != planned]
        rel = err = 0.0
        repeat_equal = True
        for conf in configs:
            out = sparse_gemm.sparse_gemm(a, v, i, s, out_dtype=out_dtype,
                                          **conf, **kw)
            again = sparse_gemm.sparse_gemm(a, v, i, s, out_dtype=out_dtype,
                                            **conf, **kw)
            torch.cuda.synchronize()
            check(out.dtype == out_dtype and out.shape == (m, n),
                  f"{variant} output {out.dtype} {tuple(out.shape)}")
            repeat_equal &= torch.equal(out, again)
            rel = max(rel, row_rel_l2(out, ref))
            err = max(err, (out.float() - ref.float()).abs().max().item())
        if kind == "extremes":
            check(s[0, 7].item() == 1.0 and not ref[:, 7].any()
                  and {-127, 127} <= set(v[:, 11].tolist()),
                  "the extremes' weight lost its zero column or its +-127")
        name = f"{str(dtype)[6:]}" + ("" if out_dtype == dtype
                                      else f" -> {str(out_dtype)[6:]}")
        row = {"m": m, "k": k, "n": n, "dtype": str(dtype)[6:],
               "out_dtype": str(out_dtype)[6:], "spec": f"{nk}:{mg}",
               "kind": kind,
               "decision": {key: list(val) if key == "tile" else val
                            for key, val in planned.items()},
               "main_path": timed and dtype == torch.bfloat16,
               "configs_checked": [{key: list(val) if key == "tile" else val
                                    for key, val in c.items()}
                                   for c in configs],
               "repeat_bit_identical": repeat_equal,
               "any_index": kind == "any index", "max_abs_err": err,
               "row_rel_l2": rel, "tol": tol}
        row["bound_ms"], row["bound_by"] = sparse_bound(m, k, n, size, nk, mg,
                                                        p.quantize)
        times = ""
        if timed:
            row["ms"] = device_ms(functools.partial(
                lambda a, v, i, s, w, **kw: sparse_gemm.sparse_gemm(
                    a, v, i, s, **kw), **planned, **kw), sets, side)
            row["plain_ms"] = device_ms(functools.partial(
                lambda a, v, i, s, w, **kw: sparse_gemm.sparse_gemm_reference(
                    a, v, i, s, **kw), **kw), sets, side)
            row["library_ms"] = device_ms(lambda a, v, i, s, w: a @ w, sets,
                                          side)
            times = (f"; kernel {row['ms']:.4f} ms, plain "
                     f"{row['plain_ms']:.4f} ms, torch.matmul over the "
                     f"densified{', scaled' if p.quantize else ''} weight "
                     f"{row['library_ms']:.4f} ms")
            split = planned.get("split_k", 1)
            if split > 1:
                row.update(_time_reduce(
                    split, m, n, dtype, gen, side,
                    kernel=lambda w, dt: sparse_gemm.split_reduce(w, dt, s),
                    plain=lambda w, dt: sparse_gemm.split_reduce_reference(
                        w, dt, s)))
                times += (f"; its {'scaled ' if p.quantize else ''}reduction "
                          f"of {split} partials {row['reduce_ms']:.4f} ms "
                          f"(plain {row['reduce_plain_ms']:.4f}, torch.sum "
                          f"{row['reduce_library_ms']:.4f}, bound "
                          f"{row['reduce_bound_ms']:.4f}; bit for bit)")
        rows.append(row)
        ok = math.isfinite(rel) and rel <= tol and repeat_equal
        more = (f" and {len(configs) - 1} more configurations"
                if len(configs) > 1 else "")
        print(f"{variant} {nk}:{mg} {name} {m}x{k}x{n} ({kind}) decision "
              f"{planned}{more}: row rel-L2 {rel:.2e} (tol {tol:g}), "
              f"max|diff| {err:.3e}, repeat launches "
              f"{'bit-identical' if repeat_equal else 'DIFFER'}{times}, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']})"
              f"{'' if ok else '  FAILED'}")
        if not ok:
            failures.append(f"{nk}:{mg} {name} {m}x{k}x{n} {kind}: "
                            f"{rel:.2e}, repeat equal {repeat_equal}")
        del sets
    REPORT[f"{p.report}_kernel"] = rows
    check(not failures, f"{variant} disagrees with its plain version: "
          f"{failures}")
    return rows


def _time_reduce(parts: int, m: int, n: int, dtype, gen,
                 side: torch.cuda.Stream, kernel=sparse_gemm.split_reduce,
                 plain=sparse_gemm.split_reduce_reference) -> dict:
    """A split-K (or K slab) reduction alone at a decision's count of
    partials: (parts, M, N) f32 partials cycled past the L2, to the
    operand dtype, held to its plain version bit for bit (the same sum in
    the same order); its plain version and torch.sum beside it.  The
    sparse GEMM's unless `kernel` and `plain` name another."""
    count = max(2, min(32, math.ceil(2 * L2_BYTES / (parts * m * n * 4))))
    sets = [(torch.randn(parts, m, n, generator=gen, device="cuda"),)
            for _ in range(count)]
    got = kernel(sets[0][0], dtype)
    want = plain(sets[0][0], dtype)
    check(torch.equal(got, want), f"the reduction of {parts} partials at "
          f"{m} x {n} differs from its plain version (same order)")
    bound_ms, bound_by = reduce_bound(parts, m, n, got.element_size())
    return {"reduce_parts": parts,
            "reduce_ms": device_ms(lambda w: kernel(w, dtype), sets, side),
            "reduce_plain_ms": device_ms(lambda w: plain(w, dtype), sets,
                                         side),
            "reduce_library_ms": device_ms(
                lambda w: torch.sum(w, 0).to(dtype), sets, side),
            "reduce_bound_ms": bound_ms, "reduce_bound_by": bound_by,
            "reduce_max_abs_err": (got.float() - want.float()).abs().max()
            .item()}


def _split_gemms(m: int, in_bytes: int = 2) -> int:
    """Sparse GEMMs of one qwen layer at M = m that the engine plans with
    split_k > 1 (each launches the reduction once), keyed at `in_bytes`
    (1 for int8 values) under bf16 activations."""
    model = HopperModel()
    return sum(calls for (k, n), calls in LAYER_GEMMS.items()
               if sparse_args(model.decide(KernelRequest(
                   "gemm_sparse", m, k, n, in_bytes=in_bytes, out_bytes=2,
                   density=0.5))).get("split_k", 1) > 1)


def _sparse_serve(p: Posture, gen: int) -> dict:
    """The launcher's static serve in posture `p`: BATCH requests of
    PROMPT tokens, weights (pruned, and quantized with --quantize, after
    `init_params`) and prompt from SEED."""
    return launch_serve.main(
        ["--arch", ARCH, *p.flags, "--batch", str(BATCH), "--prompt-len",
         str(PROMPT), "--seed", str(SEED), "--gen", str(gen)])


def _dense_bytes(tree) -> int:
    """Bytes of the tree with every SparseTensor at its dense shape in its
    values' dtype (what the unpruned weights take)."""
    if isinstance(tree, dict):
        return sum(_dense_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_dense_bytes(v) for v in tree)
    if isinstance(tree, SparseTensor):
        return math.prod(tree.shape) * tree.values.element_size()
    return tree_bytes(tree)


def _float_sparse_bytes(tree) -> int:
    """Bytes of the tree with every SparseTensor's values at 2 bytes and no
    scale: the float 2:4 posture's bf16 storage of the same weights."""
    if isinstance(tree, dict):
        return sum(_float_sparse_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_float_sparse_bytes(v) for v in tree)
    if isinstance(tree, SparseTensor):
        return 2 * tree.values.numel() + tree.indices.nbytes
    return tree_bytes(tree)


def _want_counts(p: Posture, sparse: int, paged: int = 0) -> dict:
    """`read_counts` of a serve in posture `p`: `sparse` launches of its
    variant, `paged` of the paged kernel, every other kernel 0."""
    return {"redas_gemm": 0, "paged_attention": paged, "flash_attention": 0,
            "grouped_gemm": 0, "quant_gemm": 0, "sparse_gemm": 0,
            "sparse_gemm_int8": 0, p.counter: sparse}


def phase_sparse_static(cfg, p: Posture) -> None:
    """qwen2-1.5b through the launcher in posture `p` (`--sparsity 2:4`,
    or with `--quantize` int8 values and scales and a contiguous int8 KV
    cache) at full width: 4 x (512 + 16), bf16 activations,
    "hopper-sparse" (every dense matmul on the posture's variant of the
    sparse kernel); then the prefill logits against "torch-ref-sparse" on
    the served run's own weights and prompt."""
    _sparse_serve(p, 1)                        # warm-up
    first = _sparse_serve(p, 1)
    first_tokens, prefill_ms = first["tokens"], first["seconds"] * 1e3
    del first
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_counts()
    out = _sparse_serve(p, GEN)
    counts = read_counts()
    by_path = p.paths()
    reduces = sparse_gemm.reduce_launches
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    scfg, tokens, eng = out["serve_config"], out["tokens"], out["engine"]
    # the weights against the float 2:4 posture's (sparse x int8) or the
    # unpruned bf16 ones (float 2:4)
    baseline, baseline_bytes = (("float 2:4", _float_sparse_bytes)
                                if p.quantize else ("bf16", _dense_bytes))
    sizes = {"weight_bytes": tree_bytes(out["params"]),
             "baseline_weight_bytes": baseline_bytes(out["params"])}
    decode_ms = (out["seconds"] * 1e3 - prefill_ms) / (GEN - 1)
    layer = sum(LAYER_GEMMS.values()) * cfg.n_layers
    want = _want_counts(p, layer * GEN)
    print(f"{p.label} static serve ({' '.join(p.flags)}, {BATCH} x "
          f"({PROMPT} + {GEN}), {scfg.kernel_backend}, cache "
          f"{scfg.cache_dtype}): {out['seconds']:.3f} s, "
          f"{out['tokens_per_s']:.1f} tok/s; prefill and first token "
          f"{prefill_ms:.2f} ms, decode {decode_ms:.3f} ms/step; weights "
          f"{sizes['weight_bytes'] / 2**30:.3f} GiB against "
          f"{sizes['baseline_weight_bytes'] / 2**30:.3f} GiB {baseline}; max "
          f"memory allocated by the run {peak:.2f} GiB (the bf16 draw and "
          f"its pruning included); plan {out['engine_plan']}; kernel "
          f"launches {counts} (want {want})")
    check((scfg.kernel_backend, scfg.cache_dtype) == ("hopper-sparse",
                                                      p.cache),
          f"{' '.join(p.flags)} gave {scfg.kernel_backend}, "
          f"{scfg.cache_dtype}")
    check(counts == want, f"{p.label} static launches {counts}, not {want}")
    want_paths = {"decode": layer * (GEN - 1), "tiled": layer}
    want_reduces = (GEN - 1) * cfg.n_layers * _split_gemms(BATCH, p.in_bytes)
    print(f"{p.label} static serve: sparse GEMMs by path {by_path} (want "
          f"{want_paths}), split-K reductions {reduces} (want "
          f"{want_reduces})")
    check(by_path == want_paths and reduces == want_reduces,
          f"{p.label} static paths {by_path}, reductions {reduces}")
    check(tuple(tokens.shape) == (BATCH, GEN)
          and bool(((tokens >= 0) & (tokens < cfg.vocab)).all()),
          f"{p.label} static tokens {tuple(tokens.shape)}")
    check(torch.equal(first_tokens, tokens[:, :1]),
          f"1-token and 16-token {p.label} runs differ")
    check({(req.op, req.in_bytes, req.out_bytes, req.density)
           for req, _ in eng.plan} == {("gemm_sparse", p.in_bytes, 2, 0.5)},
          f"plan {[(req.op, req.in_bytes, req.density) for req, _ in eng.plan]}")
    check(sizes["weight_bytes"] < 0.85 * sizes["baseline_weight_bytes"],
          f"weight bytes {sizes}")

    logits = {}
    for backend in ("torch-ref-sparse", "hopper-sparse"):
        cache = T.init_cache(cfg, T.CacheSpec(PROMPT + GEN + 1, BATCH),
                             dtype=p.cache, device="cuda")
        with torch.inference_mode(), use_engine(Engine(backend=backend)):
            logits[backend] = T.prefill(out["params"], cfg, out["prompt"],
                                        cache)[0]
    gap = _logit_gap(logits["hopper-sparse"], logits["torch-ref-sparse"])
    print(f"{p.label} full-width prefill logits ({p.cache} KV), "
          f"hopper-sparse vs torch-ref-sparse on the same weights and "
          f"prompt: rel-L2 {gap['rel_l2']:.4e}, max|diff|/max|ref| "
          f"{gap['rel_max']:.4e}, argmax agreement "
          f"{gap['argmax_agreement']:.2f} (limits {LOGIT_LIMITS})")
    check(all(math.isfinite(gap[k]) and gap[k] <= LOGIT_LIMITS[k]
              for k in LOGIT_LIMITS), f"{p.label} prefill logit gap {gap}")
    REPORT[f"{p.report}_static"] = {
        "seconds": out["seconds"], "tokens_per_s": out["tokens_per_s"],
        "prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
        "max_memory_gib": peak, **sizes, "plan": out["engine_plan"],
        "counts": counts, "sparse_paths": by_path,
        "sparse_reduces": reduces, "prefill_logits": gap,
        "tokens": tokens.tolist()}


def phase_sparse_paged(cfg, p: Posture) -> None:
    """The paged serve's trace through the launcher in posture `p`: the
    Scheduler on float pools (on int8 pools with --quantize), every dense
    matmul on the posture's variant of the sparse kernel and every decode
    attention on the paged kernel; a second pass, a device trace of 10
    decode ticks, and one tick's logits against "torch-ref-sparse"."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_counts()
    out = launch_serve.main(SERVE_ARGS + p.flags)
    counts = read_counts()
    by_path = p.paths()
    reduces = sparse_gemm.reduce_launches
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    sched, eng, scfg = out["scheduler"], out["engine"], out["serve_config"]
    st = sched.stats
    ticks, calls = st["decode_steps"], st["prefill_calls"]
    tick_ms = sched.timings["decode_s"] * 1e3 / ticks
    layer = sum(LAYER_GEMMS.values()) * cfg.n_layers
    want = _want_counts(p, layer * (ticks + calls), cfg.n_layers * ticks)
    pools = sched.cache["slots"]["b0"]
    kv_bytes = tree_bytes(dict(sched.cache["slots"]))
    tokens = {u: c.tokens.tolist() for u, c in sched.completions.items()}
    print(f"{p.label} paged serve ({' '.join(p.flags)}, "
          f"{scfg.kernel_backend}, {pools['k_pages'].dtype} pools): "
          f"{out['requests']} requests / {out['tokens']} tokens in "
          f"{out['seconds']:.3f} s, {out['tokens_per_s']:.1f} tok/s over "
          f"{SLOTS} slots; {ticks} decode ticks, {tick_ms:.3f} ms per tick "
          f"(mean); {calls} prefill calls of widths "
          f"{sorted(st['prefill_widths'])}, "
          f"{sched.timings['prefill_s'] * 1e3:.2f} ms in all; plan "
          f"{eng.plan.stats}; kernel launches {counts} (want {want}); KV pool "
          f"{kv_bytes / 2**20:.2f} MiB; peak memory above what the script "
          f"held {peak:.3f} GiB")
    check(scfg.kernel_backend == "hopper-sparse", f"{scfg.kernel_backend}")
    check(pools["k_pages"].dtype == p.cache,
          f"pools {pools['k_pages'].dtype}, not {p.cache}")
    check(out["requests"] == len(launch_serve.parse_trace(POSTURE_TRACE)),
          f"served {out['requests']} requests")
    check(counts == want, f"{p.label} paged launches {counts}, not {want}")
    if p.quantize:
        # the int8 pool of --quantize: one byte a K/V value, an f32 scale a
        # row
        want_kv = (cfg.n_layers * 2 * POOL_PAGES * PAGE * cfg.n_kv
                   * (cfg.head_dim_ + 4))
        check(pools["k_scale_pages"].dtype == torch.float32
              and kv_bytes == want_kv, f"KV pool {kv_bytes} bytes, not the "
              f"int8 pool's {want_kv}")
    want_paths = {"decode": layer * ticks, "tiled": layer * calls}
    want_reduces = ticks * cfg.n_layers * _split_gemms(SLOTS, p.in_bytes)
    print(f"{p.label} paged serve: sparse GEMMs by path {by_path} (want "
          f"{want_paths}: every prefill width is above the decode rows), "
          f"split-K reductions {reduces} (want {want_reduces})")
    check(min(st["prefill_widths"]) > sparse_gemm.DECODE_ROWS[-1]
          and by_path == want_paths and reduces == want_reduces,
          f"{p.label} paged paths {by_path}, reductions {reduces}")
    for uid, toks in tokens.items():
        check(len(toks) == out["trace"][uid][1]
              and all(0 <= t < cfg.vocab for t in toks), f"request {uid}")
    sched.paged.check_invariants()
    new_misses, prof = _replay_and_trace(out["params"], cfg, scfg, eng,
                                         out["trace"], tokens, f"{p.label} ",
                                         SPARSE_KERNELS)
    sparse_ms = sum(v["ms"] for v in prof["matched"].values())
    detail = ", ".join(f"{key} {v['ms']:.3f} ms in {v['count']} launches"
                       for key, v in prof["matched"].items())
    print(f"the sparse kernels in the 10 traced ticks: {sparse_ms:.3f} ms of "
          f"device time, {sparse_ms / 10:.3f} ms a tick ({detail})")
    gap = _decode_tick_gap(out["params"], cfg, scfg, eng, out["trace"],
                           backends=("torch-ref-sparse", "hopper-sparse"))
    print(f"{p.label} full-width paged decode tick logits (8 slots, "
          f"{p.cache} pools), hopper-sparse vs torch-ref-sparse: rel-L2 "
          f"{gap['rel_l2']:.4e}, max|diff|/max|ref| {gap['rel_max']:.4e}, "
          f"argmax agreement {gap['argmax_agreement']:.2f} (limit rel-L2 "
          f"{LOGIT_LIMITS['rel_l2']})")
    REPORT[f"{p.report}_paged"] = {
        "trace": POSTURE_TRACE, "slots": SLOTS, "seconds": out["seconds"],
        "tokens_per_s": out["tokens_per_s"], "tokens": out["tokens"],
        "decode_ticks": ticks, "decode_ms_per_tick": tick_ms,
        "prefill_calls": calls, "prefill_widths": sorted(st["prefill_widths"]),
        "prefill_ms": sched.timings["prefill_s"] * 1e3,
        "plan": eng.plan.stats, "counts": counts, "max_memory_gib": peak,
        "kv_bytes": kv_bytes, "sparse_paths": by_path,
        "sparse_reduces": reduces,
        "sparse_ms_per_traced_tick": sparse_ms / 10,
        "second_pass_new_misses": new_misses, "trace_10_ticks": prof,
        "decode_tick_logits": gap}
    check(math.isfinite(gap["rel_l2"]) and gap["rel_l2"] <= LOGIT_LIMITS["rel_l2"],
          f"{p.label} paged decode logit gap {gap}")


def phase_sparse_smoke_parity(p: Posture) -> None:
    """qwen2-1.5b SMOKE in f32 under sparsity="2:4" (and quantize=True for
    sparse x int8), weights pruned (and quantized) on the CPU: the card's
    tokens (the posture's variant of the sparse kernel) equal the CPU's
    plain run, static (`generate`) and through the Scheduler, paged and
    contiguous, with a shared prefix, under a float KV cache and, for
    sparse x int8, under an int8 one."""
    smoke = get_config(ARCH, smoke=True)
    cpu_params = prune_params(T.init_params(
        smoke, generator=torch.Generator().manual_seed(SEED),
        dtype=torch.float32), 2, 4, quantize=p.quantize)
    card_params = _to(cpu_params, "cuda")
    result = {}
    sprompt = torch.randint(0, smoke.vocab, (2, 24),
                            generator=torch.Generator().manual_seed(SEED + 1),
                            dtype=torch.int32)
    rng = np.random.default_rng(SEED)
    prefix = rng.integers(0, smoke.vocab, 24)
    spec = [(uid, (np.concatenate([prefix, rng.integers(0, smoke.vocab, 3 + uid)])
                   if uid % 2 else rng.integers(0, smoke.vocab, 5 + 3 * uid)
                   ).astype(np.int32), 4 + uid % 5) for uid in range(8)]
    for cache in ("float32", "int8") if p.quantize else ("float32",):
        kw = {"max_seq": 33, "batch": 2, "compute_dtype": "float32",
              "cache_dtype": cache, "sparsity": "2:4",
              "quantize": p.quantize}
        want = serve_lib.generate(cpu_params, smoke, serve_lib.ServeConfig(
            device="cpu", **kw), sprompt, 8)
        reset_counts()
        got = serve_lib.generate(card_params, smoke, serve_lib.ServeConfig(
            device="cuda", **kw), sprompt, 8)
        counts = read_counts()
        check(counts[p.counter] == 7 * smoke.n_layers * 8
              and counts[p.other] == 0,
              f"smoke static sparse launches {counts}")
        result[f"static, {cache} KV"] = torch.equal(got.cpu(), want)
        tokens = {}
        for device in ("cpu", "cuda"):
            for layout in ("paged", "contiguous"):
                sc = serve_lib.ServeConfig(
                    max_seq=48, batch=3, compute_dtype="float32",
                    cache_dtype=cache, sparsity="2:4", quantize=p.quantize,
                    device=device, cache_layout=layout, page_size=8)
                reset_counts()
                sched = Scheduler(cpu_params if device == "cpu"
                                  else card_params, smoke, sc)
                done = sched.run([Request(uid=u, prompt=x, max_new_tokens=g)
                                  for u, x, g in spec])
                tokens[(device, layout)] = {u: c.tokens.tolist()
                                            for u, c in done.items()}
                counts = read_counts()
                check(device == "cpu" or (counts[p.counter] > 0
                                          and counts[p.other] == 0),
                      f"the {p.label} sparse kernel did not run on the card: "
                      f"{counts}")
                if layout == "paged":
                    check(sched.stats["shared_prefix_tokens"] > 0,
                          f"smoke trace shared no prefix on {device}")
        for layout in ("paged", "contiguous"):
            result[f"scheduler {layout}, {cache} KV"] = (
                tokens[("cuda", layout)] == tokens[("cpu", layout)])
    print(f"{p.label} SMOKE f32 (sparsity='2:4', quantize={p.quantize}): "
          f"card tokens identical to the CPU's plain run: {result}")
    REPORT[f"{p.report}_smoke_parity"] = result
    check(all(result.values()), f"{p.label} smoke tokens differ: {result}")


def phase_sparse_serves(cfg, p: Posture) -> None:
    """The static serve, the paged serve and SMOKE parity in posture
    `p`."""
    phase_sparse_static(cfg, p)
    torch.cuda.empty_cache()
    phase_sparse_paged(cfg, p)
    torch.cuda.empty_cache()
    phase_sparse_smoke_parity(p)


def _static_sparse_calls(cfg):
    """(row, calls) for each main-path shape of the sparse static serves:
    the prefill at M = BATCH x PROMPT once, the decode at M = BATCH for
    GEN - 1 steps, per layer as LAYER_GEMMS counts."""
    for (k, n), per_layer in LAYER_GEMMS.items():
        for m, steps in ((BATCH * PROMPT, 1), (BATCH, GEN - 1)):
            yield (k, n, m), per_layer * cfg.n_layers * steps


def sparse_line(rows: list[dict], p: Posture) -> dict:
    """The static serve's sparse GEMM work in posture `p`: each main-path
    shape's time at the engine's decision (on the decode path the
    reduction included), weighted by the launches that serve makes (the
    plain version, torch.matmul over the weight densified (and scaled)
    ahead of time and the bound likewise)."""
    cfg = get_config(ARCH)
    totals = dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms"), 0.0)
    ops_ms = bytes_ms = 0.0
    for (k, n, m), calls in _static_sparse_calls(cfg):
        row = next(r for r in rows if r["main_path"]
                   and (r["m"], r["k"], r["n"]) == (m, k, n))
        for key in totals:
            totals[key] += calls * row[key]
        weight = k // 2 * n * 2 + 4 * n if p.quantize else k // 2 * n * 3
        ops_ms += calls * m * k * n / PEAK_FLOPS_BF16 * 1e3
        bytes_ms += calls * ((m * k + m * n) * 2 + weight) / HBM_BW * 1e3
    static = REPORT[f"{p.report}_static"]
    paged = REPORT[f"{p.report}_paged"]
    variant = "<T, signed char>" if p.quantize else ""
    kernels = {f"sparse_decode_kernel{variant}": static["sparse_paths"]["decode"],
               f"sparse_os_kernel{variant}": static["sparse_paths"]["tiled"]}
    if p.quantize:
        kernels["sparse_reduce_kernel (scaled)"] = static["sparse_reduces"]
    return {"name": p.counter, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sparse_gemm.cu",
            "replaces": "src/repro/kernels/sparse_gemm.py:163" + (
                " (int8 values, the scale of :225-226)" if p.quantize
                else ""),
            "launches": static["counts"][p.counter],
            "launches_by_path": {
                f"{p.report}_static_serve": static["sparse_paths"],
                f"{p.report}_paged_serve": paged["sparse_paths"]},
            "reductions": {f"{p.report}_static_serve": static["sparse_reduces"],
                           f"{p.report}_paged_serve": paged["sparse_reduces"]},
            "kernels": kernels,
            "per": f"the {' '.join(p.flags)} static serve's "
                   f"{static['counts'][p.counter]} launches, summed (decode "
                   f"calls with their reduction)",
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": totals["ms"], "plain_ms": totals["plain_ms"],
            "bound_ms": totals["bound_ms"],
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": totals["library_ms"],
            "library": ("torch.matmul over the weight densified and scaled "
                        "ahead of time in bf16" if p.quantize else
                        "torch.matmul over the weight densified ahead of "
                        "time")}


def sparse_reduce_line(rows: list[dict]) -> dict:
    """The decode path's split-K reduction over the --sparsity static
    serve: each decode shape's reduction alone at its planned split,
    weighted by the launches that serve makes (`reduce_launches`)."""
    cfg = get_config(ARCH)
    keys = ("ms", "plain_ms", "library_ms", "bound_ms")
    totals = dict.fromkeys(keys, 0.0)
    errs, bound_by = [], collections.Counter()
    for (k, n, m), calls in _static_sparse_calls(cfg):
        row = next(r for r in rows if r["main_path"]
                   and (r["m"], r["k"], r["n"]) == (m, k, n))
        if "reduce_ms" in row:
            for key in keys:
                totals[key] += calls * row[f"reduce_{key}"]
            errs.append(row["reduce_max_abs_err"])
            bound_by[row["reduce_bound_by"]] += calls * row["reduce_bound_ms"]
    static, paged = REPORT["sparse_static"], REPORT["sparse_paged"]
    return {"name": "sparse_reduce", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sparse_gemm.cu",
            "replaces": "src/repro/kernels/sparse_gemm.py:163 (the OS "
                        "accumulation across K blocks, split on the card)",
            "launches": static["sparse_reduces"],
            "launches_by_path": {"sparse_static_serve":
                                 static["sparse_reduces"],
                                 "sparse_paged_serve": paged["sparse_reduces"]},
            "kernels": {"sparse_reduce_kernel": static["sparse_reduces"]},
            "per": "the --sparsity 2:4 static serve's reductions, summed",
            "max_abs_err": max(errs),
            "ms": totals["ms"], "plain_ms": totals["plain_ms"],
            "bound_ms": totals["bound_ms"],
            "bound_by": bound_by.most_common(1)[0][0],
            "library_ms": totals["library_ms"],
            "library": "torch.sum over the split dimension"}


# --------------------------------------------------------------------------
# granite-moe-1b-a400m: the grouped kernel and the MoE serves
# --------------------------------------------------------------------------


def grouped_bound(e, c, d, f, itemsize: int) -> tuple[float, str]:
    """x and w read once and y written once; 2 E C D F operations."""
    return _bound_of(2.0 * e * c * d * f,
                     e * (c * d + d * f + c * f) * itemsize, itemsize)


def _grouped_sets(e, c, d, f, dtype, gen) -> list[tuple]:
    per = e * (c * d + d * f) * torch.tensor([], dtype=dtype).element_size()
    count = max(2, min(64, math.ceil(2 * L2_BYTES / per)))
    return [(torch.randn(e, c, d, generator=gen, device="cuda").to(dtype),
             (torch.randn(e, d, f, generator=gen, device="cuda")
              / math.sqrt(d)).to(dtype)) for _ in range(count)]


def _sync_entry(tile, x, w):
    """The sync route's kernel (the grouped kernel before the wgmma one)
    on aligned bf16 operands, through its C entry: the wrapper routes
    those to the wgmma kernel.  For timing it against the wgmma route;
    counts nothing."""
    e, c, d = x.shape
    out = torch.empty((e, c, w.shape[2]), dtype=x.dtype, device=x.device)
    code = 0 if x.dtype == torch.bfloat16 else 1
    err = grouped_gemm._library().grouped_gemm_launch(
        code, code, *tile, x.data_ptr(), w.data_ptr(), out.data_ptr(), e, c,
        d, w.shape[2], torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"grouped sync entry {tile}: CUDA error {err}")
    return out


def phase_grouped_kernel() -> list[dict]:
    """The grouped kernel at granite's expert shapes, on both routes,
    against its plain version; times of kernel, plain version and
    torch.bmm (the one PyTorch call computing the same function) beside
    the bound.  bf16 runs on the wgmma route: the engine's tile, every
    tile of the wgmma menu (the pick within GEMM_PICK_LIMIT of the
    fastest), the sync kernel at its own roofline tile on the same
    aligned operands (through its C entry) and through the wrapper on a
    copy at a misaligned base (the route TMA cannot describe), each call's
    route read from the counters; the host's us per call at the decode
    shapes on both routes.  f32 runs on the sync route."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    side = torch.cuda.Stream()
    rows, failures, picks = [], [], []
    for dtype in (torch.bfloat16, torch.float32):
        tol = BF16_ROW_TOL if dtype == torch.bfloat16 else F32_ROW_TOL
        name = str(dtype)[6:]
        for e, c, d, f in GROUPED_SHAPES:
            sets = _grouped_sets(e, c, d, f, dtype, gen)
            x, w = sets[0]
            size = x.element_size()
            dec = HopperModel().decide(KernelRequest(
                "grouped_gemm", c, d, f, groups=e, in_bytes=size,
                out_bytes=size))
            tile = (dec.bm, dec.bk, dec.bn)
            route = grouped_gemm.grouped_route(x, w)
            check(route == ("wgmma" if size == 2 else "sync"),
                  f"grouped {name} {(e, c, d, f)} on the {route} route")
            run = functools.partial(grouped_gemm.grouped_matmul, tile=tile)
            grouped_gemm.reset_launches()
            out, ref = run(x, w), grouped_gemm.grouped_matmul_reference(x, w)
            torch.cuda.synchronize()
            check(grouped_gemm.launches == 1 and grouped_gemm.wgmma_launches
                  == (route == "wgmma"), f"grouped {name} {(e, c, d, f)}: "
                  f"counted {grouped_gemm.launches}, "
                  f"{grouped_gemm.wgmma_launches} on wgmma")
            rel = row_rel_l2(out, ref)
            err = (out.float() - ref.float()).abs().max().item()
            row = {"shape": [e, c, d, f], "dtype": name, "route": route,
                   "tile": list(tile), "ms": device_ms(run, sets, side),
                   "plain_ms": device_ms(grouped_gemm.grouped_matmul_reference,
                                         sets, side),
                   "library_ms": device_ms(torch.bmm, sets, side),
                   "library": "torch.bmm", "predicted_ms": dec.seconds * 1e3,
                   "max_abs_err": err, "row_rel_l2": rel, "tol": tol}
            row["bound_ms"], row["bound_by"] = grouped_bound(e, c, d, f, size)
            if route == "wgmma":
                row.update(_grouped_wgmma_extras(sets, tile, ref, tol, side))
                fastest = min(row["tiles_ms"].values())
                picks.append({"shape": [e, c, d, f], "tile": list(tile),
                              "ratio": row["ms"] / fastest})
            rows.append(row)
            ok = math.isfinite(rel) and rel <= tol
            extra = (f"; sync kernel {tuple(row['sync_tile'])} "
                     f"{row['sync_ms']:.4f} ms (misaligned base "
                     f"{row['sync_misaligned_ms']:.4f}); every wgmma tile "
                     + ", ".join(f"{t} {v:.4f}"
                                 for t, v in row["tiles_ms"].items())
                     if route == "wgmma" else "")
            print(f"grouped_gemm {name} ({e}, {c}, {d}) @ ({e}, {d}, {f}) "
                  f"{route} tile {tile}: row rel-L2 {rel:.2e} (tol {tol:g}), "
                  f"max|diff| {err:.3e}; kernel {row['ms']:.4f} ms "
                  f"(predicted {row['predicted_ms']:.4f}), plain "
                  f"{row['plain_ms']:.4f} ms, torch.bmm "
                  f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
                  f"({row['bound_by']}){extra}{'' if ok else '  FAILED'}")
            if "host_us" in row:
                print("  host us per call (enqueued back to back, the card "
                      "not waited for): " + ", ".join(
                          f"{k} {v:.1f} us" for k, v in row["host_us"].items()))
            if not ok:
                failures.append(f"grouped {name} {(e, c, d, f)}: {rel:.2e}")
            failures += row.pop("failures", [])
            del sets, x, w, out, ref
    REPORT["grouped_kernel"] = rows
    REPORT["grouped_picks"] = picks
    check(not failures, f"grouped kernel disagrees with its plain version: "
          f"{failures}")
    slow = [p for p in picks if p["ratio"] > GEMM_PICK_LIMIT]
    check(not slow, f"the grouped decision takes more than {GEMM_PICK_LIMIT}x "
          f"the fastest wgmma tile: {slow}")
    return rows


def _grouped_wgmma_extras(sets, tile, ref, tol, side) -> dict:
    """At a bf16 shape on the wgmma route: every tile of the wgmma menu
    held to the plain version (a repeat bit for bit) and timed; the sync
    kernel at its roofline tile on the same aligned operands and through
    the wrapper on a misaligned copy, held and timed; at decode C the
    host's us per call of each route and of torch.bmm
    (`host_enqueue_us`)."""
    x, w = sets[0]
    e, c, d = x.shape
    f = w.shape[2]
    out, failures = {"tiles_ms": {}}, []
    for t in grouped_gemm.WGMMA_TILES:
        run = functools.partial(grouped_gemm.grouped_matmul, tile=t)
        got, again = run(x, w), run(x, w)
        torch.cuda.synchronize()
        if not (row_rel_l2(got, ref) <= tol and torch.equal(got, again)):
            failures.append(f"grouped wgmma {(e, c, d, f)} tile {t}")
        out["tiles_ms"][str(t)] = device_ms(run, sets, side)
    old = choose_tile(c, d, f, 2, 2, dataflows=("os",),
                      tiles=grouped_gemm.TILES)
    old = (old.bm, old.bk, old.bn)
    sync = functools.partial(_sync_entry, old)
    off = [(_misaligned(a), b) for a, b in sets]
    via = functools.partial(grouped_gemm.grouped_matmul, tile=old)
    before = (grouped_gemm.launches, grouped_gemm.wgmma_launches)
    for got in (sync(x, w), via(*off[0])):
        torch.cuda.synchronize()
        if not row_rel_l2(got, ref) <= tol:
            failures.append(f"grouped sync {(e, c, d, f)} tile {old}")
    check(grouped_gemm.launches == before[0] + 1
          and grouped_gemm.wgmma_launches == before[1],
          "a misaligned grouped call did not run on the sync kernel")
    out.update(sync_tile=list(old), sync_ms=device_ms(sync, sets, side),
               sync_misaligned_ms=device_ms(via, off, side),
               failures=failures)
    if c == GROUPED_SHAPES[0][1]:
        new = functools.partial(grouped_gemm.grouped_matmul, x, w, tile=tile)
        out["host_us"] = {
            "wgmma": host_enqueue_us(new),
            "sync_misaligned": host_enqueue_us(lambda: via(*off[0])),
            "torch.bmm": host_enqueue_us(lambda: torch.bmm(x, w))}
    del off
    return out


def _sorted(cfg):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            impl="sort"))


def phase_granite_sorted() -> dict:
    """Full-width granite with sorted dispatch through the Scheduler on
    the paged layout: POSTURE_TRACE, launch counts, a second
    pass through the same engine, and a device trace of 10 decode
    ticks."""
    cfg = _sorted(get_config(GRANITE))
    trace = launch_serve.parse_trace(POSTURE_TRACE)
    scfg = serve_lib.ServeConfig(
        max_seq=max(p + g for p, g in trace) + 1, batch=SLOTS,
        kernel_backend="hopper", cache_layout="paged", page_size=PAGE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    params = T.init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(SEED), device="cuda", dtype=torch.bfloat16)
    # an engine of its own: the per-ServeConfig memo would hand this serve
    # the qwen paged serve's engine (the ServeConfigs are equal), and the
    # plan stats printed below are granite's alone
    sched = Scheduler(params, cfg, scfg, engine=Engine(backend="hopper"),
                      prefill_bucket=BUCKET)
    reqs = launch_serve.trace_requests(cfg, trace, SEED)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sched.run(reqs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    launches = dict(redas_gemm.launches)
    check_reductions("granite sorted serve", sched.engine,
                     GRANITE_LAYER_GEMMS, cfg.n_layers, _paged_passes(sched))
    wgmma = check_os_routes("granite sorted serve", sched.engine,
                            GRANITE_LAYER_GEMMS, cfg.n_layers,
                            _paged_passes(sched))
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    eng, st = sched.engine, sched.stats
    ticks, calls = st["decode_steps"], st["prefill_calls"]
    n_tok = sum(len(c.tokens) for c in sched.completions.values())
    tick_ms = sched.timings["decode_s"] * 1e3 / ticks
    prefill_ms = sched.timings["prefill_s"] * 1e3
    layers = cfg.n_layers
    want = {"grouped_gemm": 3 * layers * (ticks + calls),
            "redas_gemm": 4 * layers * (ticks + calls),
            "paged_attention": layers * ticks, "flash_attention": 0,
            "quant_gemm": 0, "sparse_gemm": 0, "sparse_gemm_int8": 0}
    tokens = {u: c.tokens.tolist() for u, c in sched.completions.items()}
    print(f"granite sorted serve (paged, full width, bf16): "
          f"{len(sched.completions)} requests / {n_tok} tokens in "
          f"{seconds:.3f} s, {n_tok / seconds:.1f} tok/s over {SLOTS} slots; "
          f"{ticks} decode ticks, {tick_ms:.3f} ms per tick (mean); {calls} "
          f"prefill calls of widths {sorted(st['prefill_widths'])}, "
          f"{prefill_ms:.2f} ms in all; plan {eng.plan.stats}; kernel "
          f"launches {counts} (want {want}); peak memory above what the "
          f"script held {peak:.3f} GiB")
    check(len(sched.completions) == len(trace), "granite served too few")
    check(counts == want, f"granite sorted serve launches {counts}, not {want}")
    grouped_wgmma = grouped_gemm.wgmma_launches
    print(f"granite sorted serve: {grouped_wgmma} of its "
          f"{counts['grouped_gemm']} grouped calls on the wgmma kernel")
    check(grouped_wgmma == counts["grouped_gemm"],
          f"granite sorted serve: {grouped_wgmma} of "
          f"{counts['grouped_gemm']} grouped calls on the wgmma kernel")
    for uid, toks in tokens.items():
        check(len(toks) == trace[uid][1]
              and all(0 <= t < cfg.vocab for t in toks), f"request {uid}")
    sched.paged.check_invariants()

    new_misses, prof = _replay_and_trace(
        params, cfg, scfg, eng, trace, tokens, "granite ",
        GEMM_KERNELS + GROUPED_KERNELS + (PAGED_KERNEL,))
    check_traced_reductions("granite sorted serve, 10 traced ticks", prof,
                            10 * _decode_reductions(eng, GRANITE_LAYER_GEMMS,
                                                    layers))
    check_traced_grouped(prof, 10 * 3 * layers)
    prof["paged"] = paged_trace_line(prof, "granite's", cfg)
    REPORT["granite_sorted"] = {
        "trace": TRACE, "slots": SLOTS, "page_size": PAGE,
        "prefill_bucket": BUCKET, "seconds": seconds,
        "tokens_per_s": n_tok / seconds, "tokens": n_tok,
        "decode_ticks": ticks, "decode_ms_per_tick": tick_ms,
        "prefill_calls": calls, "prefill_widths": sorted(st["prefill_widths"]),
        "prefill_ms": prefill_ms, "plan": eng.plan.stats, "counts": counts,
        "launches": launches, "os_wgmma": wgmma,
        "grouped_wgmma": grouped_wgmma, "max_memory_gib": peak,
        "second_pass_new_misses": new_misses, "trace_10_ticks": prof}
    return {"cfg": cfg, "scfg": scfg, "params": params, "engine": eng,
            "trace": trace}


class _TopkSets(torch.overrides.TorchFunctionMode):
    """Records the indices of every `torch.topk` call inside it (`raw`) and
    their sorted sets (`sets`): in a decode tick the only one is each MoE
    layer's router."""

    def __enter__(self):
        self.sets, self.raw = [], []
        return super().__enter__()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.topk:
            self.raw.append(out[1])
            self.sets.append(out[1].sort(dim=-1).values)
        return out


class _PinTopk(torch.overrides.TorchFunctionMode):
    """Replays recorded `torch.topk` indices in order: each call returns
    them with its own input's values at them (a router's expert choices
    pinned, its gates its own)."""

    def __init__(self, raw: list):
        super().__init__()
        self.raw = list(raw)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.topk:
            idx = self.raw.pop(0)
            return torch.return_types.topk((args[0].gather(-1, idx), idx))
        return out


def phase_granite_parity(run: dict) -> None:
    """One full-width paged decode tick, hopper against torch-ref from the
    same state, with the (token, layer) top-k sets of the two runs."""
    cfg, params = run["cfg"], run["params"]
    sched = Scheduler(params, cfg, run["scfg"], engine=run["engine"],
                      prefill_bucket=BUCKET)
    for r in launch_serve.trace_requests(cfg, run["trace"], SEED):
        sched.submit(r)
    sched.step()                                  # admit 8, first tick
    for i, s in enumerate(sched.slots):
        sched.paged.ensure_decode_page(i, s.req.prompt.size + len(s.emitted) - 1)
    toks = torch.tensor([[s.last_token] for s in sched.slots],
                        dtype=torch.int32, device="cuda")
    active = torch.ones(SLOTS, dtype=torch.bool, device="cuda")
    bt = torch.from_numpy(sched.paged.tables).cuda()
    logits, picks = {}, {}
    for backend in ("torch-ref", "hopper"):
        # both ticks start from the same state (see phase_paged_parity)
        with torch.inference_mode(), use_engine(Engine(backend=backend)), \
                _TopkSets() as rec:
            logits[backend] = T.decode_step(
                params, cfg, sched.cache, toks, active=active,
                block_tables=bt)[0]
        picks[backend] = rec.sets
    gap = _logit_gap(logits["hopper"], logits["torch-ref"])
    flips = sum(int((a != b).any(dim=-1).sum()) for a, b in
                zip(picks["hopper"], picks["torch-ref"], strict=True))
    pairs = SLOTS * len(picks["hopper"])
    print(f"granite full-width paged decode tick logits (8 slots), hopper vs "
          f"torch-ref: rel-L2 {gap['rel_l2']:.4e}, max|diff|/max|ref| "
          f"{gap['rel_max']:.4e}, argmax agreement "
          f"{gap['argmax_agreement']:.2f} (limit rel-L2 "
          f"{LOGIT_LIMITS['rel_l2']}); top-k sets that differ: {flips} of "
          f"{pairs} (token, layer) pairs")
    REPORT["granite_parity"] = {"decode_tick_logits": gap,
                                "topk_sets_differing": flips,
                                "token_layer_pairs": pairs}
    check(math.isfinite(gap["rel_l2"]) and gap["rel_l2"] <= LOGIT_LIMITS["rel_l2"],
          f"granite decode logit gap {gap}, {flips} top-k sets differ")


def phase_granite_einsum() -> None:
    """The default dispatch through the launcher's static mode: the expert
    matmuls stay plain einsums, so the grouped kernel never launches."""
    reset_counts()
    out = launch_serve.main(["--arch", GRANITE, "--kernel-backend", "hopper",
                             "--batch", str(SLOTS), "--prompt-len",
                             str(EINSUM_PROMPT), "--gen", str(EINSUM_GEN),
                             "--seed", str(SEED)])
    counts = read_counts()
    cfg = out["cfg"]
    passes = {SLOTS * EINSUM_PROMPT: 1, SLOTS: EINSUM_GEN - 1}
    check_reductions("granite einsum serve", out["engine"],
                     GRANITE_LAYER_GEMMS, cfg.n_layers, passes)
    check_os_routes("granite einsum serve", out["engine"],
                    GRANITE_LAYER_GEMMS, cfg.n_layers, passes)
    want = {"grouped_gemm": 0,
            "redas_gemm": 4 * cfg.n_layers * EINSUM_GEN,
            "paged_attention": 0, "flash_attention": 0, "quant_gemm": 0,
            "sparse_gemm": 0, "sparse_gemm_int8": 0}
    tokens = out["tokens"]
    print(f"granite einsum serve (static, {SLOTS} x ({EINSUM_PROMPT} + "
          f"{EINSUM_GEN}), impl={cfg.moe.impl!r}): {out['seconds']:.3f} s, "
          f"{out['tokens_per_s']:.1f} tok/s; plan {out['engine_plan']}; "
          f"kernel launches {counts} (want {want})")
    check(cfg.moe.impl == "einsum", f"the launcher served impl={cfg.moe.impl}")
    check(counts == want, f"granite einsum serve launches {counts}, not {want}")
    check(tuple(tokens.shape) == (SLOTS, EINSUM_GEN)
          and bool(((tokens >= 0) & (tokens < cfg.vocab)).all()),
          f"einsum serve tokens {tuple(tokens.shape)}")
    # the two dispatches compute one function (same capacity and
    # priority): their prefill logits on the served weights and prompt
    # differ by bf16 rounding alone
    logits = {}
    for impl in ("einsum", "sort"):
        c = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                             impl=impl))
        cache = T.init_cache(c, T.CacheSpec(EINSUM_PROMPT + EINSUM_GEN + 1,
                                            SLOTS), device="cuda")
        with torch.inference_mode(), use_engine(Engine(backend="hopper")):
            logits[impl] = T.prefill(out["params"], c, out["prompt"], cache)[0]
    gap = _logit_gap(logits["sort"], logits["einsum"])
    first = logits["einsum"][:, -1].argmax(-1)
    print(f"granite prefill logits on the served prompt, sorted vs einsum "
          f"dispatch: rel-L2 {gap['rel_l2']:.4e}, max|diff|/max|ref| "
          f"{gap['rel_max']:.4e}, argmax agreement {gap['argmax_agreement']:.2f}"
          f" (limit rel-L2 {LOGIT_LIMITS['rel_l2']}); served first tokens "
          f"{tokens[:, 0].tolist()}, einsum prefill argmax {first.tolist()}")
    check(torch.equal(first.cpu(), tokens[:, 0].to(first.dtype)),
          "the prefill argmax differs from the served first tokens")
    check(math.isfinite(gap["rel_l2"]) and gap["rel_l2"] <= LOGIT_LIMITS["rel_l2"],
          f"sorted vs einsum prefill logit gap {gap}")
    REPORT["granite_einsum"] = {"seconds": out["seconds"],
                                "tokens_per_s": out["tokens_per_s"],
                                "plan": out["engine_plan"], "counts": counts,
                                "sorted_vs_einsum_prefill_logits": gap}


def phase_granite_smoke_parity() -> None:
    """granite SMOKE in f32 through the Scheduler: the card's tokens equal
    the plain versions' on the CPU, per uid, for both dispatches, paged
    and contiguous, at cf 8.0 and at the default cf."""
    base = get_config(GRANITE, smoke=True)
    cpu_params = T.init_params(base, generator=torch.Generator().manual_seed(SEED),
                               dtype=torch.float32)
    card_params = _to(cpu_params, "cuda")
    rng = np.random.default_rng(SEED)
    prefix = rng.integers(0, base.vocab, 24)
    spec = [(uid, (np.concatenate([prefix, rng.integers(0, base.vocab, 3 + uid)])
                   if uid % 2 else rng.integers(0, base.vocab, 5 + 3 * uid)
                   ).astype(np.int32), 4 + uid % 5) for uid in range(8)]
    result = {}
    for impl in ("sort", "einsum"):
        for cf in (8.0, base.moe.capacity_factor):
            cfg = dataclasses.replace(base, moe=dataclasses.replace(
                base.moe, impl=impl, capacity_factor=cf))
            tokens = {}
            for device, backend, layout in (("cpu", "torch-ref", "paged"),
                                            ("cuda", "hopper", "paged"),
                                            ("cpu", "torch-ref", "contiguous"),
                                            ("cuda", "hopper", "contiguous")):
                sc = serve_lib.ServeConfig(
                    max_seq=48, batch=3, compute_dtype="float32",
                    cache_dtype="float32", kernel_backend=backend,
                    device=device, cache_layout=layout, page_size=8)
                grouped_gemm.reset_launches()
                sched = Scheduler(cpu_params if device == "cpu"
                                  else card_params, cfg, sc)
                done = sched.run([Request(uid=u, prompt=x, max_new_tokens=g)
                                  for u, x, g in spec])
                check((grouped_gemm.launches > 0)
                      == (impl == "sort" and device == "cuda"),
                      f"smoke {impl} {device}: {grouped_gemm.launches} "
                      f"grouped launches")
                tokens[(device, layout)] = {u: c.tokens.tolist()
                                            for u, c in done.items()}
            for layout in ("paged", "contiguous"):
                same = tokens[("cuda", layout)] == tokens[("cpu", layout)]
                result[f"{impl} cf {cf} {layout}"] = same
    print(f"granite SMOKE f32 through the Scheduler, 8 requests over 3 slots: "
          f"card tokens identical to the CPU's plain run: {result}")
    REPORT["granite_smoke_parity"] = result
    check(all(result.values()), f"granite smoke tokens differ: {result}")


# --------------------------------------------------------------------------
# qwen3-14b and gemma3-12b at full width, mistral-large-123b at its
# published widths over 4 layers, the new archs' SMOKE configurations, and
# granite-moe-1b-a400m under --quantize
# --------------------------------------------------------------------------

#: the full-width serves: the static prompt (4 requests, GEN new tokens
#: each) and the paged trace over SLOTS slots; gemma3's prompts are longer
#: than its 1024-row window, so its rings wrap
WIDE = {QWEN3: {"prompt": PROMPT, "trace": POSTURE_TRACE},
        GEMMA3: {"prompt": 1536, "trace": "1536x32*4,768x24*4,256x8*4"}}
#: mistral-large-123b at its published widths, its 88 layers cut to 4
MISTRAL_LAYERS = 4
#: mixtral-8x7b at its published widths, its 32 layers cut to 4 (11.5 GiB
#: of bf16 weights; all 32 take 87.0 GiB): a static serve and this trace
#: under a paged ServeConfig, all 8 requests admitted in the first step
MIXTRAL_LAYERS, MIXTRAL_TRACE = 4, "512x16*4,256x24*4"
#: the M at which the GEMM decisions are gated at the new archs' shapes:
#: the static decode, the paged decode and a 2048-row prefill
DECISION_M = (BATCH, SLOTS, 2048)
#: granite under --quantize: the paged trace of the sorted dispatch, whose
#: int8 grouped op loops the int8 GEMM over the experts (some 1.75 s a
#: tick: 4 new tokens a request since PR 36, 8 before)
GRANITE_QUANT_TRACE = "256x4*8"


def layer_gemms(cfg, kind: str = "attn") -> dict:
    """The engine GEMMs of one layer of `kind`, (K, N) -> calls: an
    attention layer's q, k, v and o, an "rglru" layer's lin_x, lin_y,
    w_a, w_x and lin_out, and either's dense feed-forward, wi, wg (when
    gated) and wo (a MoE layer's experts are grouped or einsum matmuls);
    none for an "ssm" layer, whose projections are plain matmuls."""
    d, q = cfg.d_model, cfg.n_heads * cfg.head_dim_
    calls = collections.Counter()
    if kind == "ssm":
        return {}
    if kind == "rglru":
        w = cfg.rglru_width or d
        calls[d, w] += 2                              # lin_x, lin_y
        calls[w, w] += 2                              # w_a, w_x
        calls[w, d] += 1                              # lin_out
    else:
        calls[d, q] += 1                              # q
        calls[d, cfg.n_kv * cfg.head_dim_] += 2       # k, v
        calls[q, d] += 1                  # o: q's key too where q == d_model
    if cfg.moe is None:
        calls[d, cfg.d_ff] += 2 if cfg.gated_mlp else 1
        calls[cfg.d_ff, d] += 1
    return dict(calls)


def model_gemms(cfg) -> dict:
    """The engine GEMMs of one forward pass through every layer, (K, N) ->
    calls, each layer by its kind."""
    calls = collections.Counter()
    for i in range(cfg.n_layers):
        kind = cfg.layer_pattern[i % len(cfg.layer_pattern)]
        calls.update(layer_gemms(cfg, kind))
    return dict(calls)


def paged_layers(cfg) -> int:
    """The layers whose KV is paged: the "attn" ones (a "local" layer
    keeps a ring)."""
    period = cfg.layer_pattern
    return sum(period[i % len(period)] == "attn" for i in range(cfg.n_layers))


def phase_decisions(arch: str, cfg, gated: bool) -> list[dict]:
    """The ReDas GEMM's three dataflows, each at the cost model's best
    configuration for it, at `cfg`'s layer GEMMs in bf16 and each M of
    DECISION_M: held to the plain version, timed beside torch.matmul, and
    the model's decision against the fastest dataflow (within
    GEMM_PICK_LIMIT where `gated`)."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    side = torch.cuda.Stream()
    model = HopperModel()
    picks, failures = [], []
    for m in DECISION_M:
        for k, n in layer_gemms(cfg):
            sets = _operand_sets(m, k, n, torch.bfloat16, gen)
            a, b = sets[0]
            ref = redas_gemm.gemm_reference(a, b)
            request = KernelRequest("gemm", m, k, n, in_bytes=2, out_bytes=2)
            main = model.decide(request)
            by = {}
            for df in redas_gemm.DATAFLOWS:
                conf = gemm_args(decide_gemm(request, model.name,
                                             dataflows=(df,)))
                rel = row_rel_l2(redas_gemm.gemm(a, b, **conf), ref)
                if not (math.isfinite(rel) and rel <= BF16_ROW_TOL):
                    failures.append(f"{m}x{k}x{n} {df}: row rel-L2 {rel:.2e}")
                by[df] = {"tile": [conf["bm"], conf["bk"], conf["bn"]],
                          "row_rel_l2": rel, "ms": device_ms(
                              lambda x, y, conf=conf: redas_gemm.gemm(
                                  x, y, **conf), sets, side)}
            fastest = min(by, key=lambda df: by[df]["ms"])
            pick = {"m": m, "k": k, "n": n, "decision": main.dataflow,
                    "tile": [main.bm, main.bk, main.bn],
                    "slabs": main.meta_dict.get("slabs", 1),
                    "ms": by[main.dataflow]["ms"], "fastest": fastest,
                    "fastest_ms": by[fastest]["ms"],
                    "library_ms": device_ms(torch.matmul, sets, side),
                    "by_dataflow": by}
            pick["ratio"] = pick["ms"] / pick["fastest_ms"]
            picks.append(pick)
            print(f"{arch} gemm {m}x{k}x{n}: decision {main.dataflow} "
                  f"{tuple(pick['tile'])} x{pick['slabs']} {pick['ms']:.4f} "
                  f"ms; " + ", ".join(f"{df} {tuple(r['tile'])} {r['ms']:.4f}"
                                      for df, r in by.items())
                  + f"; torch.matmul {pick['library_ms']:.4f} ms; decision / "
                  f"fastest {pick['ratio']:.2f}x"
                  + (f" (limit {GEMM_PICK_LIMIT}x)" if gated
                     else " (not gated)"))
            del sets
    REPORT.setdefault("decisions", {})[arch] = picks
    check(not failures, f"{arch}: kernel disagrees with its plain version: "
          f"{failures}")
    if gated:
        slow = [p for p in picks if p["ratio"] > GEMM_PICK_LIMIT]
        check(not slow, f"{arch}: the model's decision is slower than "
              f"{GEMM_PICK_LIMIT}x the fastest dataflow: "
              + "; ".join(f"{p['m']}x{p['k']}x{p['n']} {p['ratio']:.2f}x"
                          for p in slow))
    return picks


def grouped_calls(cfg) -> int:
    """The grouped GEMM calls of one layer a pass: wi, wg and wo for a
    sorted MoE dispatch, none for einsum or a dense feed-forward."""
    return 3 if cfg.moe is not None and cfg.moe.impl == "sort" else 0


def check_static_serve(label: str, cfg, out: dict, prefill_ms: float,
                       first_tokens, prompt: int) -> dict:
    """A static serve of BATCH x (`prompt` + GEN): every layer GEMM on the
    ReDas kernel (`model_gemms`: 7 an attention layer a pass, 4 for MoE,
    8 an "rglru" layer, none an "ssm" layer), every OS call on the wgmma
    kernel, the reductions the plan implies, the experts of a sorted MoE
    on the grouped kernel's wgmma route (3 a layer a pass), no other
    kernel; tokens in range, the first equal to a 1-token run's; each
    decision missed once.  `prompt` is a request's prefill rows (a VLM's
    prefix included)."""
    counts = read_counts()
    launches = dict(redas_gemm.launches)
    per_pass = model_gemms(cfg)
    grouped = grouped_calls(cfg) * cfg.n_layers * GEN
    grouped_wgmma = grouped_gemm.wgmma_launches
    passes = {BATCH * prompt: 1, BATCH: GEN - 1}
    reduces = check_reductions(label, out["engine"], per_pass, 1, passes)
    wgmma = check_os_routes(label, out["engine"], per_pass, 1, passes)
    want = {"redas_gemm": sum(per_pass.values()) * GEN,
            "grouped_gemm": grouped}
    # each grouped shape (E, C, D, F) and (E, C, F, D) at both passes
    decisions = 2 * (len(per_pass) + (2 if grouped else 0))
    tokens = out["tokens"]
    decode_ms = (out["seconds"] * 1e3 - prefill_ms) / (GEN - 1)
    plan = out["engine"].plan.stats
    print(f"{label}: {BATCH} requests x ({prompt} prompt + {GEN} new) in "
          f"{out['seconds']:.3f} s, {BATCH * GEN / out['seconds']:.1f} tok/s; "
          f"prefill and first token {prefill_ms:.2f} ms (a served run of 1 "
          f"token), decode {decode_ms:.3f} ms/step (the difference); plan "
          f"{plan}; decisions {decision_mix(out['engine'])}; launches "
          f"{launches}, grouped {counts['grouped_gemm']} ({grouped_wgmma} "
          f"on wgmma), want {want}")
    check(all(counts[k] == v for k, v in want.items()),
          f"{label}: kernels launched {counts}, not {want}")
    check(all(v == 0 for k, v in counts.items() if k not in want),
          f"{label}: another kernel on the static path: {counts}")
    check(grouped_wgmma == grouped,
          f"{label}: {grouped_wgmma} of {grouped} grouped calls on wgmma")
    check(tuple(tokens.shape) == (BATCH, GEN)
          and bool(((tokens >= 0) & (tokens < cfg.vocab)).all()),
          f"{label}: tokens {tuple(tokens.shape)} out of shape or range")
    check(torch.equal(first_tokens.cpu(), tokens[:, :1].cpu()),
          f"{label}: the 1-token run's token differs from the served run's")
    check(plan["misses"] == plan["decisions"] == decisions,
          f"{label}: plan {plan}, want each of {decisions} decisions missed "
          f"once")
    return {"seconds": out["seconds"], "prefill_ms": prefill_ms,
            "decode_ms_per_step": decode_ms, "plan": plan,
            "decision_mix": decision_mix(out["engine"]), "counts": counts,
            "launches": launches, "os_wgmma": wgmma, "reductions": reduces,
            "tokens": tokens.tolist()}


def static_serve(label: str, cfg, serve, prompt: int) -> tuple[dict, dict]:
    """A static serve of BATCH x (`prompt` + GEN) by `serve(n)`, which
    serves n new tokens a request and returns the run's tokens, seconds,
    engine, params and prompt: a warm-up, a 1-token run (the prefill and
    first token), then the timed run, checked by `check_static_serve`,
    with its peak memory above what was held before it.  Returns the
    timed run and its result."""
    serve(1)                                             # warm-up
    first = serve(1)
    first_tokens, prefill_ms = first["tokens"], first["seconds"] * 1e3
    del first
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_counts()
    out = serve(GEN)
    result = check_static_serve(label, cfg, out, prefill_ms, first_tokens,
                                prompt)
    result["max_memory_gib"] = (torch.cuda.max_memory_allocated()
                                - held) / 2**30
    result["weights_gib"] = tree_bytes(out["params"]) / 2**30
    print(f"{label}: weights {result['weights_gib']:.2f} GiB, peak memory "
          f"{result['max_memory_gib']:.2f} GiB above what was held before "
          f"the run")
    return out, result


def generate_serve(params, cfg):
    """`serve(n)` for `static_serve` through `generate` on `hopper`: a
    BATCH x PROMPT prompt from SEED, one engine for every run."""
    prompt = torch.randint(0, cfg.vocab, (BATCH, PROMPT), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(SEED + 1), dtype=torch.int32)
    scfg = serve_lib.ServeConfig(max_seq=PROMPT + GEN + 1, batch=BATCH,
                                 kernel_backend="hopper")
    eng = Engine(backend="hopper")

    def serve(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tokens = serve_lib.generate(params, cfg, scfg, prompt, n, engine=eng)
        torch.cuda.synchronize()
        return {"tokens": tokens, "seconds": time.perf_counter() - t0,
                "engine": eng, "params": params, "prompt": prompt}
    return serve


def _launch_static(arch: str, prompt: int):
    """`serve(n)` for `static_serve` through `launch.serve` static mode:
    BATCH x `prompt` tokens, weights from SEED, `hopper`."""
    args = ["--arch", arch, "--kernel-backend", "hopper", "--batch",
            str(BATCH), "--prompt-len", str(prompt), "--seed", str(SEED)]
    return lambda n: launch_serve.main(args + ["--gen", str(n)])


def phase_wide_static(arch: str) -> dict:
    """`launch.serve` at full width, static mode: BATCH x (prompt + GEN),
    bf16, weights from SEED, `hopper`; prefill logits against
    `torch-ref`.  Returns the served run."""
    cfg, prompt = get_config(arch), WIDE[arch]["prompt"]
    serve_lib._ENGINES.clear()      # its own engine (see paged_serve_phase)
    out, result = static_serve(f"{arch} static serve", cfg,
                               _launch_static(arch, prompt), prompt)
    result["parity"] = prefill_gaps(f"{arch} full width", out["params"], cfg,
                                    out["prompt"], prompt + GEN + 1)
    REPORT[f"{arch}_static"] = result
    return out


def _cache_bytes(cache: dict) -> dict:
    """A cache's bytes: the paged pools ("attn" layers), the rows
    ("local" layers' rings) and the recurrent state ("ssm", "rglru"),
    scales included."""
    out = collections.Counter()
    for c in [*cache["slots"].values(), *cache["tail"]]:
        kind = "pool" if "k_pages" in c else "ring" if "k" in c else "state"
        out[kind] += sum(t.numel() * t.element_size() for t in c.values())
    return dict(out)


def paged_serve_phase(arch: str, trace: str, report: str,
                      tick_parity: bool = False) -> dict:
    """`launch.serve` at full width in trace mode, paged, over SLOTS slots:
    the paged kernel once a paged layer a tick, 7 GEMMs a layer a pass
    (every OS call on wgmma), prefix sharing on pure "attn" archs only; a
    second pass planning nothing new; 10 traced ticks; the cache's bytes
    and the peak; with `tick_parity`, one tick's logits against
    `torch-ref`.  Kept in REPORT[report]; returns the served run."""
    cfg = get_config(arch)
    # an engine of this serve's own: the per-ServeConfig memo would hand
    # it an earlier arch's engine where their ServeConfigs are equal
    serve_lib._ENGINES.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_counts()
    out = launch_serve.main(
        ["--arch", arch, "--kernel-backend", "hopper", "--batch", str(SLOTS),
         "--cache-layout", "paged", "--page-size", str(PAGE),
         "--prefill-bucket", str(BUCKET), "--seed", str(SEED), "--trace",
         trace])
    counts = read_counts()
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    sched, eng = out["scheduler"], out["engine"]
    st, per_layer, layers = sched.stats, layer_gemms(cfg), cfg.n_layers
    ticks, calls = st["decode_steps"], st["prefill_calls"]
    passes = _paged_passes(sched)
    reduces = check_reductions(f"{arch} paged serve", eng, per_layer, layers,
                               passes)
    wgmma = check_os_routes(f"{arch} paged serve", eng, per_layer, layers,
                            passes)
    want = {"redas_gemm": sum(per_layer.values()) * layers * (ticks + calls),
            "paged_attention": paged_layers(cfg) * ticks}
    cache = _cache_bytes(sched.cache)
    sharing = sched.paged.index is not None
    tick_ms = sched.timings["decode_s"] * 1e3 / ticks
    print(f"{arch} paged serve: {out['requests']} requests / {out['tokens']} "
          f"tokens in {out['seconds']:.3f} s, {out['tokens_per_s']:.1f} tok/s "
          f"over {SLOTS} slots; {ticks} decode ticks, {tick_ms:.3f} ms a tick "
          f"(mean); {calls} prefill calls of widths "
          f"{sorted(st['prefill_widths'])}, "
          f"{sched.timings['prefill_s'] * 1e3:.2f} ms in all; plan "
          f"{eng.plan.stats}; launches {counts} (want {want}); prefix sharing "
          f"{'on' if sharing else 'off'}; cache bytes {cache}; peak memory "
          f"above what the script held {peak:.3f} GiB")
    check(out["requests"] == len(launch_serve.parse_trace(trace)),
          f"{arch}: served {out['requests']} requests")
    check(all(counts[k] == v for k, v in want.items()),
          f"{arch} paged serve launches {counts}, not {want}")
    check(all(v == 0 for k, v in counts.items() if k not in want),
          f"{arch}: another kernel on the paged path: {counts}")
    check(sharing == (set(cfg.layer_pattern) == {"attn"}),
          f"{arch}: prefix sharing {'on' if sharing else 'off'} for the "
          f"layer pattern {cfg.layer_pattern}")
    tokens = {u: c.tokens.tolist() for u, c in sched.completions.items()}
    for uid, toks in tokens.items():
        check(len(toks) == out["trace"][uid][1]
              and all(0 <= t < cfg.vocab for t in toks),
              f"{arch} request {uid}")
    sched.paged.check_invariants()
    new_misses, prof = _replay_and_trace(
        out["params"], cfg, out["serve_config"], eng, out["trace"], tokens,
        f"{arch} ", GEMM_KERNELS + (PAGED_KERNEL,))
    prof["gemm"] = gemm_trace_line(prof, 10, "tick")
    prof["paged"] = paged_trace_line(prof, f"{arch}'s", cfg)
    check_traced_reductions(f"{arch} paged serve, 10 traced ticks", prof,
                            10 * _decode_reductions(eng, per_layer, layers))
    REPORT[report] = {
        "trace": trace, "slots": SLOTS, "page_size": PAGE,
        "prefill_bucket": BUCKET, "seconds": out["seconds"],
        "tokens_per_s": out["tokens_per_s"], "requests": out["requests"],
        "tokens": out["tokens"],
        "decode_ticks": ticks, "decode_ms_per_tick": tick_ms,
        "prefill_calls": calls, "prefill_widths": sorted(st["prefill_widths"]),
        "prefill_ms": sched.timings["prefill_s"] * 1e3,
        "stats": {k: v for k, v in st.items() if k != "prefill_widths"},
        "plan": eng.plan.stats, "counts": counts, "launches":
        dict(redas_gemm.launches), "os_wgmma": wgmma, "reductions": reduces,
        "prefix_sharing": sharing, "cache_bytes": cache,
        "max_memory_gib": peak, "decision_mix": decision_mix(eng),
        "second_pass_new_misses": new_misses, "trace_10_ticks": prof}
    if tick_parity:
        REPORT[report]["tick_logits"] = paged_tick_gap(f"{arch} full width",
                                                       cfg, out)
    return out


def seeded_params(cfg) -> dict:
    return T.init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(SEED), device="cuda", dtype=torch.bfloat16)


def phase_mistral() -> None:
    """mistral-large-123b at its published widths with its 88 layers cut
    to MISTRAL_LAYERS: a static serve through `generate`, BATCH x (PROMPT
    + GEN), checked as the wide static serves are; each decision printed
    beside the fastest dataflow (not gated)."""
    cfg = dataclasses.replace(get_config(MISTRAL), n_layers=MISTRAL_LAYERS)
    phase_decisions(MISTRAL, cfg, gated=False)
    _, result = static_serve(
        f"{MISTRAL} x {MISTRAL_LAYERS} layers static serve", cfg,
        generate_serve(seeded_params(cfg), cfg), PROMPT)
    REPORT[f"{MISTRAL}_static"] = {"n_layers": MISTRAL_LAYERS, **result}


def hold_plan_kernels(label: str, eng) -> list[dict]:
    """Every GEMM and grouped GEMM decision in `eng`'s plan through the
    `hopper` backend's entry for it (the kernel at the decision's
    configuration) against the plain version, on random bf16 operands of
    its shape: row rel-L2 within BF16_ROW_TOL."""
    gen = torch.Generator(device="cuda").manual_seed(7)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * scale).to(torch.bfloat16)

    rows = []
    for req, dec in eng.plan:
        if req.op == "gemm":
            a, b = randn(req.m, req.k), randn(req.k, req.n,
                                              scale=req.k ** -0.5)
            got, ref = hopper_gemm(dec, a, b), ref_gemm(dec, a, b)
        elif req.op == "grouped_gemm":
            a = randn(req.groups, req.m, req.k)
            b = randn(req.groups, req.k, req.n, scale=req.k ** -0.5)
            got, ref = (hopper_grouped_gemm(dec, a, b),
                        ref_grouped_gemm(dec, a, b))
        else:
            continue
        rows.append({"op": req.op, "shape": [req.groups, req.m, req.k, req.n],
                     "dataflow": dec.dataflow,
                     "row_rel_l2": row_rel_l2(got, ref)})
        del a, b, got, ref
    print(f"{label}: the plan's {len(rows)} GEMM and grouped decisions on "
          f"their kernels against the plain versions, row rel-L2 at most "
          f"{max(r['row_rel_l2'] for r in rows):.2e} (tol {BF16_ROW_TOL:g}): "
          + ", ".join(f"{r['op']} {tuple(r['shape'])} {r['row_rel_l2']:.1e}"
                      for r in rows))
    bad = [r for r in rows if not (math.isfinite(r["row_rel_l2"])
                                   and r["row_rel_l2"] <= BF16_ROW_TOL)]
    check(rows and not bad, f"{label}: kernels disagree with their plain "
          f"versions: {bad}")
    return rows


def phase_mixtral() -> None:
    """mixtral-8x7b at its published widths with its 32 layers cut to
    MIXTRAL_LAYERS, sorted dispatch (the grouped kernel at E = 8, top-2,
    D = 4096, F = 14336): a static serve through `generate`, checked as
    the wide static serves are; then MIXTRAL_TRACE through the Scheduler
    under a paged ServeConfig, which builds no paged plane (every block is
    "local") and runs the contiguous path on per-slot rings: exact GEMM
    and grouped launches, every grouped call on wgmma, no other kernel,
    every decision of the plan held on its kernel against the plain
    version, and one decode tick's logits against `torch-ref` from the
    same state."""
    cfg = _sorted(dataclasses.replace(get_config(MIXTRAL),
                                      n_layers=MIXTRAL_LAYERS))
    label = f"{MIXTRAL} x {MIXTRAL_LAYERS} layers"
    params = seeded_params(cfg)
    out, static = static_serve(f"{label} static serve (sorted)", cfg,
                               generate_serve(params, cfg), PROMPT)
    static_engine = out["engine"]
    del out
    trace = launch_serve.parse_trace(MIXTRAL_TRACE)
    scfg = serve_lib.ServeConfig(
        max_seq=max(p + g for p, g in trace) + 1, batch=SLOTS,
        kernel_backend="hopper", cache_layout="paged", page_size=PAGE)
    eng = Engine(backend="hopper")
    sched = Scheduler(params, cfg, scfg, engine=eng, prefill_bucket=BUCKET)
    check(sched.paged is None, f"{label}: a paged plane for the layer "
          f"pattern {cfg.layer_pattern}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_counts()
    t0 = time.perf_counter()
    sched.run(launch_serve.trace_requests(cfg, trace, SEED))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts, grouped_wgmma = read_counts(), grouped_gemm.wgmma_launches
    launches = dict(redas_gemm.launches)
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    st, per_layer, layers = sched.stats, layer_gemms(cfg), cfg.n_layers
    ticks, calls = st["decode_steps"], st["prefill_calls"]
    passes = _paged_passes(sched)
    reduces = check_reductions(f"{label} serve", eng, per_layer, layers,
                               passes)
    wgmma = check_os_routes(f"{label} serve", eng, per_layer, layers, passes)
    want = {"redas_gemm": sum(per_layer.values()) * layers * (ticks + calls),
            "grouped_gemm": grouped_calls(cfg) * layers * (ticks + calls)}
    cache = _cache_bytes(sched.cache)
    tick_ms = sched.timings["decode_s"] * 1e3 / ticks
    print(f"{label} serve under a paged ServeConfig (contiguous rings): "
          f"{len(sched.completions)} requests in {seconds:.3f} s over {SLOTS} "
          f"slots; {ticks} decode ticks, {tick_ms:.3f} ms a tick (mean); "
          f"{calls} prefill calls of widths {sorted(st['prefill_widths'])}, "
          f"{sched.timings['prefill_s'] * 1e3:.2f} ms in all; plan "
          f"{eng.plan.stats}; launches {counts} (want {want}), "
          f"{grouped_wgmma} grouped on wgmma; cache bytes {cache}; peak "
          f"memory above what the script held {peak:.3f} GiB")
    check(len(sched.completions) == len(trace), f"{label}: served too few")
    check(all(counts[k] == v for k, v in want.items())
          and all(v == 0 for k, v in counts.items() if k not in want),
          f"{label} serve launches {counts}, not {want}")
    check(grouped_wgmma == want["grouped_gemm"],
          f"{label}: {grouped_wgmma} of {want['grouped_gemm']} grouped calls "
          f"on wgmma")
    check(set(cache) == {"ring"}, f"{label}: cache {cache}, want rings only")
    for uid, c in sched.completions.items():
        check(len(c.tokens) == trace[uid][1]
              and all(0 <= t < cfg.vocab for t in c.tokens.tolist()),
              f"{label} request {uid}")
    held = (hold_plan_kernels(f"{label} static serve", static_engine)
            + hold_plan_kernels(f"{label} serve", eng))
    gap = tick_gap(f"{label} (contiguous rings)", params, cfg, scfg, eng,
                   trace)
    REPORT[MIXTRAL] = {
        "n_layers": MIXTRAL_LAYERS, "static": static, "trace": MIXTRAL_TRACE,
        "seconds": seconds, "decode_ticks": ticks,
        "decode_ms_per_tick": tick_ms, "prefill_calls": calls,
        "prefill_ms": sched.timings["prefill_s"] * 1e3, "counts": counts,
        "launches": launches, "grouped_wgmma": grouped_wgmma, "os_wgmma": wgmma,
        "reductions": reduces, "plan": eng.plan.stats, "cache_bytes": cache,
        "max_memory_gib": peak, "kernels_held": held, "tick_logits": gap}


# --------------------------------------------------------------------------
# The recurrent kinds and the embedding inputs: mamba2-780m ("ssm") and
# recurrentgemma-2b ("rglru" + "local") at full width, hubert-xlarge
# (frame embeddings into an encoder) and internvl2-1b (a patch-embedding
# prefix)
# --------------------------------------------------------------------------

MAMBA, RGEMMA = "mamba2-780m", "recurrentgemma-2b"
HUBERT, INTERNVL = "hubert-xlarge", "internvl2-1b"
#: the recurrent archs' full-width serves: the static prompt (BATCH
#: requests, GEN new tokens each) and the Scheduler's trace over SLOTS
#: slots under a paged ServeConfig (no "attn" layer: the contiguous
#: path), with `ticks` traced decode ticks (the trace's first 8 requests
#: outlive 2 x ticks + 1 ticks).  mamba2's 2048 tokens are 8 SSD chunks
#: of 256; recurrentgemma's 2560-token prompts wrap its 2048-row rings
RECURRENT = {MAMBA: {"prompt": 2048, "trace": POSTURE_TRACE, "ticks": 10},
             RGEMMA: {"prompt": 2560, "trace": "2560x32*2,768x32*4,256x16*8",
                      "ticks": 6}}
#: hubert's (batch, frames) through `forward`; internvl2's text prompt,
#: after its 256 prefix rows
HUBERT_FRAMES, VLM_TEXT = (BATCH, 1024), 512


def phase_recurrent(arch: str) -> None:
    """`launch.serve` at full width in bf16: the static serve, checked as
    the wide static serves are (recurrentgemma's GEMMs 8 an "rglru" layer
    and 7 a "local" layer a pass, (8 x 18 + 7 x 8) x GEN; mamba2's none:
    its projections and head are plain matmuls, so every kernel count is
    0 and nothing is planned), and, for recurrentgemma, its prefill
    logits against `torch-ref` and the f32 model (`prefill_gaps`'
    `f32_anchor`); then the
    trace through the Scheduler under a paged ServeConfig, which builds no
    paged plane and runs the contiguous path on ragged prompts: exact
    launches, no other kernel, a second pass planning nothing new, traced
    ticks, the cache's bytes equal at max_seq and 4 x max_seq (the
    recurrent state is O(1), the rings O(window)), and, for
    recurrentgemma, one decode tick's logits against `torch-ref` from the
    same state."""
    cfg, spec = get_config(arch), RECURRENT[arch]
    prompt, n_ticks = spec["prompt"], spec["ticks"]
    serve_lib._ENGINES.clear()      # its own engine (see paged_serve_phase)
    out, static = static_serve(f"{arch} static serve", cfg,
                               _launch_static(arch, prompt), prompt)
    if model_gemms(cfg):
        static["parity"] = prefill_gaps(f"{arch} full width", out["params"],
                                        cfg, out["prompt"], prompt + GEN + 1,
                                        f32_anchor=True)
    else:
        check(len(out["engine"].plan) == 0, f"{arch}: the engine planned "
              f"{len(out['engine'].plan)} decisions for plain matmuls")
    REPORT[f"{arch}_static"] = static
    params = out["params"]
    del out
    torch.cuda.empty_cache()

    label = f"{arch} serve"
    trace = launch_serve.parse_trace(spec["trace"])
    scfg = serve_lib.ServeConfig(
        max_seq=max(p + g for p, g in trace) + 1, batch=SLOTS,
        kernel_backend="hopper", cache_layout="paged", page_size=PAGE)
    eng = Engine(backend="hopper")
    sched = Scheduler(params, cfg, scfg, engine=eng, prefill_bucket=BUCKET)
    check(sched.paged is None, f"{label}: a paged plane for the layer "
          f"pattern {cfg.layer_pattern}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_counts()
    t0 = time.perf_counter()
    sched.run(launch_serve.trace_requests(cfg, trace, SEED))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts, launches = read_counts(), dict(redas_gemm.launches)
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    st, per_pass = sched.stats, model_gemms(cfg)
    ticks, calls = st["decode_steps"], st["prefill_calls"]
    passes = _paged_passes(sched)
    reduces = check_reductions(label, eng, per_pass, 1, passes)
    wgmma = check_os_routes(label, eng, per_pass, 1, passes)
    want = {"redas_gemm": sum(per_pass.values()) * (ticks + calls)}
    cache = _cache_bytes(sched.cache)
    longer = _cache_bytes(T.init_cache(
        cfg, T.CacheSpec(4 * scfg.max_seq, SLOTS), dtype=torch.bfloat16,
        device="cuda"))
    n_tok = sum(len(c.tokens) for c in sched.completions.values())
    tick_ms = sched.timings["decode_s"] * 1e3 / ticks
    print(f"{label} under a paged ServeConfig (contiguous path): "
          f"{len(sched.completions)} requests / {n_tok} tokens in "
          f"{seconds:.3f} s, {n_tok / seconds:.1f} tok/s over {SLOTS} slots; "
          f"{ticks} decode ticks, {tick_ms:.3f} ms a tick (mean); {calls} "
          f"prefill calls of widths {sorted(st['prefill_widths'])}, "
          f"{sched.timings['prefill_s'] * 1e3:.2f} ms in all; plan "
          f"{eng.plan.stats}; launches {counts} (want {want}); cache bytes "
          f"{cache}, at 4 x max_seq {longer}; peak memory above what the "
          f"script held {peak:.3f} GiB")
    check(len(sched.completions) == len(trace), f"{label}: served too few")
    check(all(counts[k] == v for k, v in want.items())
          and all(v == 0 for k, v in counts.items() if k not in want),
          f"{label} launches {counts}, not {want}")
    check(cache == longer and "pool" not in cache,
          f"{label}: cache bytes {cache} at max_seq {scfg.max_seq}, {longer} "
          f"at 4 x: the recurrent state and the rings must not grow")
    tokens = {u: c.tokens.tolist() for u, c in sched.completions.items()}
    for uid, toks in tokens.items():
        check(len(toks) == trace[uid][1]
              and all(0 <= t < cfg.vocab for t in toks),
              f"{label} request {uid}")
    new_misses, prof = _replay_and_trace(params, cfg, scfg, eng, trace,
                                         tokens, f"{arch} ", GEMM_KERNELS,
                                         n_ticks)
    prof["gemm"] = gemm_trace_line(prof, n_ticks, "tick")
    check_traced_reductions(f"{label}, {n_ticks} traced ticks", prof,
                            n_ticks * _decode_reductions(eng, per_pass, 1))
    REPORT[arch] = {
        "trace": spec["trace"], "slots": SLOTS, "seconds": seconds,
        "tokens_per_s": n_tok / seconds, "tokens": n_tok,
        "decode_ticks": ticks, "decode_ms_per_tick": tick_ms,
        "prefill_calls": calls, "prefill_widths": sorted(st["prefill_widths"]),
        "prefill_ms": sched.timings["prefill_s"] * 1e3,
        "stats": {k: v for k, v in st.items() if k != "prefill_widths"},
        "plan": eng.plan.stats, "counts": counts, "launches": launches,
        "os_wgmma": wgmma, "reductions": reduces, "cache_bytes": cache,
        "cache_bytes_4x_max_seq": longer, "max_memory_gib": peak,
        "decision_mix": decision_mix(eng), "second_pass_new_misses":
        new_misses, f"trace_{n_ticks}_ticks": prof}
    if per_pass:
        REPORT[arch]["tick_logits"] = tick_gap(f"{arch} full width", params,
                                               cfg, scfg, eng, trace)


def phase_hubert() -> None:
    """hubert-xlarge at full width in bf16: `forward` over HUBERT_FRAMES
    frame embeddings (drawn from SEED) inside a `hopper` engine's scope:
    6 GEMMs a layer (q, k, v, o and the GELU feed-forward's wi and wo),
    6 x 48 = 288, every OS call on wgmma, no other kernel, nothing new
    planned on a second call; logits (B, frames, 504) finite and within
    LOGIT_LIMITS' rel-L2 of `torch-ref`'s; a device trace's idle share."""
    cfg = get_config(HUBERT)
    params = seeded_params(cfg)
    frames = torch.randn(*HUBERT_FRAMES, cfg.d_model, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(
                             SEED + 1)).to(torch.bfloat16)
    eng = Engine(backend="hopper")

    def run(engine):
        with torch.inference_mode(), use_engine(engine):
            return T.forward(params, cfg, None, embeds=frames)[0]

    run(eng)                                        # warm-up: plans it all
    misses = eng.plan.misses
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_counts()
    t0 = time.perf_counter()
    logits = run(eng)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts, launches = read_counts(), dict(redas_gemm.launches)
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    per_pass = model_gemms(cfg)
    rows = HUBERT_FRAMES[0] * HUBERT_FRAMES[1]
    reduces = check_reductions("hubert forward", eng, per_pass, 1, {rows: 1})
    wgmma = check_os_routes("hubert forward", eng, per_pass, 1, {rows: 1})
    want = {"redas_gemm": sum(per_pass.values())}
    ref = run(Engine(backend="torch-ref"))
    gap = _logit_gap(logits, ref)
    del ref
    prof = _profile(lambda: run(eng), GEMM_KERNELS)
    prof.pop("result")
    prof["gemm"] = gemm_trace_line(prof, 1, "forward")
    print(f"hubert-xlarge forward over {HUBERT_FRAMES} frames: {ms:.2f} ms "
          f"({rows / ms * 1e3:.0f} frames/s); launches {counts} (want "
          f"{want}); plan {eng.plan.stats}; decisions {decision_mix(eng)}; "
          f"logits {tuple(logits.shape)}, hopper vs torch-ref rel-L2 "
          f"{gap['rel_l2']:.4e}, max|diff|/max|ref| {gap['rel_max']:.4e}, "
          f"argmax agreement {gap['argmax_agreement']:.4f} (limit rel-L2 "
          f"{LOGIT_LIMITS['rel_l2']}); traced: wall {prof['wall_ms']:.2f} "
          f"ms, device busy {prof['device_busy_ms']:.2f} ms, idle share "
          f"{prof['idle_share']:.2f}; peak memory above the weights "
          f"{peak:.3f} GiB")
    check(all(counts[k] == v for k, v in want.items())
          and all(v == 0 for k, v in counts.items() if k not in want),
          f"hubert forward launches {counts}, not {want}")
    check(eng.plan.misses == misses, f"hubert: {eng.plan.misses - misses} "
          f"new plan misses on the second forward")
    check(tuple(logits.shape) == (*HUBERT_FRAMES, cfg.vocab)
          and bool(torch.isfinite(logits).all()),
          f"hubert logits {tuple(logits.shape)}")
    check(math.isfinite(gap["rel_l2"])
          and gap["rel_l2"] <= LOGIT_LIMITS["rel_l2"],
          f"hubert logit gap {gap}")
    REPORT[HUBERT] = {
        "frames": list(HUBERT_FRAMES), "forward_ms": ms, "counts": counts,
        "launches": launches, "os_wgmma": wgmma, "reductions": reduces,
        "plan": eng.plan.stats, "decision_mix": decision_mix(eng),
        "logits": gap, "max_memory_gib": peak,
        "weights_gib": tree_bytes(params) / 2**30, "trace_forward": prof}


def phase_internvl() -> None:
    """internvl2-1b at full width in bf16 through `launch.serve` static
    mode: BATCH x (256 prefix rows drawn from SEED + VLM_TEXT tokens +
    GEN), checked as the wide static serves are (7 x 24 x GEN GEMMs at
    the prefill's 4 x 768 rows and decode's 4), its traces' idle shares,
    and its prefill logits against `torch-ref` on the same prefix."""
    cfg = get_config(INTERNVL)
    rows = cfg.prefix_tokens + VLM_TEXT
    serve_lib._ENGINES.clear()
    out, result = static_serve(f"{INTERNVL} static serve", cfg,
                               _launch_static(INTERNVL, VLM_TEXT), rows)
    check(tuple(out["embeds"].shape) == (BATCH, cfg.prefix_tokens,
                                         cfg.d_model),
          f"{INTERNVL}: prefix {tuple(out['embeds'].shape)}")
    result.update(_traces(out, result["prefill_ms"],
                          result["decode_ms_per_step"] * (GEN - 1)))
    result["parity"] = prefill_gaps(f"{INTERNVL} full width", out["params"],
                                    cfg, out["prompt"], rows + GEN + 1,
                                    embeds=out["embeds"])
    REPORT[f"{INTERNVL}_static"] = result


def phase_embeds_smoke_parity() -> None:
    """internvl2-1b and hubert-xlarge SMOKE in f32, the card (`hopper`)
    against the CPU's plain run (`torch-ref`): internvl2's greedy tokens
    after an 8-row prefix, 2 x (8 + 40 + 8), identical; hubert's forward
    logits over 2 x 40 frames within 1e-4 rel-L2; each card run on the
    ReDas GEMM."""
    result = {}
    for arch in (INTERNVL, HUBERT):
        cfg = get_config(arch, smoke=True)
        cpu_params = T.init_params(
            cfg, generator=torch.Generator().manual_seed(SEED),
            dtype=torch.float32)
        gen = torch.Generator().manual_seed(SEED + 1)
        prompt = torch.randint(0, cfg.vocab, (2, 40), generator=gen,
                               dtype=torch.int32)
        rows = 40 if cfg.embed_inputs else cfg.prefix_tokens
        embeds = torch.randn(2, rows, cfg.d_model, generator=gen)
        if not cfg.embed_inputs:
            embeds = 0.02 * embeds
        out = {}
        for device, backend in (("cpu", "torch-ref"), ("cuda", "hopper")):
            params = cpu_params if device == "cpu" else _to(cpu_params,
                                                            "cuda")
            reset_counts()
            if cfg.embed_inputs:
                with torch.inference_mode(), use_engine(Engine(backend=backend)):
                    out[device] = T.forward(params, cfg, None,
                                            embeds=embeds.to(device),
                                            compute_dtype=torch.float32)[0]
            else:
                out[device] = serve_lib.generate(
                    params, cfg, serve_lib.ServeConfig(
                        max_seq=rows + 48 + 1, batch=2,
                        compute_dtype="float32", cache_dtype="float32",
                        kernel_backend=backend, device=device),
                    prompt.to(device), 8, embeds=embeds.to(device))
            if device == "cuda":
                launched = read_counts()["redas_gemm"]
        if cfg.embed_inputs:
            got, want = out["cuda"].cpu(), out["cpu"]
            rel = ((got - want).norm() / want.norm()).item()
            result[arch] = {"logits_rel_l2": rel, "redas_gemm": launched}
            check(rel <= 1e-4, f"{arch} SMOKE logits, card vs CPU: rel-L2 "
                  f"{rel:.3e}")
        else:
            same = torch.equal(out["cuda"].cpu(), out["cpu"])
            result[arch] = {"tokens_identical": same, "redas_gemm": launched}
            check(same, f"{arch} SMOKE tokens differ, card vs CPU")
        check(launched > 0, f"{arch} SMOKE on the card launched no GEMM")
    print(f"embedding-input SMOKE f32, card vs the CPU's plain run: {result}")
    REPORT["embeds_smoke_parity"] = result


def _smoke_cases() -> list[tuple]:
    """(label, cfg, quantize) of the newer archs' SMOKE configurations:
    qwen3-14b, mistral-large-123b, gemma3-12b and recurrentgemma-2b (both
    also under --quantize: int8 rings, recurrentgemma's conv and h bf16),
    mamba2-780m, and mixtral-8x7b under both MoE dispatches."""
    cases = [(a, get_config(a, smoke=True), False)
             for a in (QWEN3, MISTRAL, GEMMA3, MAMBA, RGEMMA)]
    cases += [(f"{a} --quantize", get_config(a, smoke=True), True)
              for a in (GEMMA3, RGEMMA)]
    mix = get_config(MIXTRAL, smoke=True)
    cases += [(f"{MIXTRAL} {impl}", dataclasses.replace(
        mix, moe=dataclasses.replace(mix.moe, impl=impl)), False)
        for impl in ("einsum", "sort")]
    return cases


def phase_new_smoke_parity() -> None:
    """The newer archs' SMOKE configurations in f32: the card's greedy
    tokens (`hopper`) equal the CPU's plain run (`torch-ref`), static
    (`generate`, 2 x (40 + 8): longer than the 16-row windows) and through
    the Scheduler (8 requests of 5-40 tokens over 3 slots), paged and
    contiguous; each card run launches the kernels `smoke_kernels` names;
    a paged ServeConfig builds the paged plane only on an arch with
    "attn" layers."""
    rng = np.random.default_rng(SEED)
    spec = [(uid, rng.integers(0, 128, int(rng.integers(5, 41))).astype(
        np.int32), int(rng.integers(3, 9))) for uid in range(8)]
    prompt = torch.randint(0, 128, (2, 40), generator=torch.Generator()
                           .manual_seed(SEED + 1), dtype=torch.int32)
    result, counts, paths = {}, {}, {}
    for label, cfg, quant in _smoke_cases():
        cpu_params = T.init_params(
            cfg, generator=torch.Generator().manual_seed(SEED),
            dtype=torch.float32)
        if quant:
            cpu_params = quantize_params(cpu_params)
        card_params = _to(cpu_params, "cuda")
        kw = {"compute_dtype": "float32", "quantize": quant,
              "cache_dtype": "int8" if quant else "float32"}
        tokens, counts[label], paths[label] = {}, {}, {}
        for device, backend in (("cpu", "torch-ref"), ("cuda", "hopper")):
            params = cpu_params if device == "cpu" else card_params
            reset_counts()
            tokens[device, "static"] = serve_lib.generate(
                params, cfg, serve_lib.ServeConfig(
                    max_seq=49, batch=2, kernel_backend=backend,
                    device=device, **kw), prompt.to(device), 8).cpu().tolist()
            if device == "cuda":
                counts[label]["static"] = read_counts()
                paths[label]["static"] = dict(quant_gemm.path_launches)
            for layout in ("paged", "contiguous"):
                sched = Scheduler(params, cfg, serve_lib.ServeConfig(
                    max_seq=56, batch=3, kernel_backend=backend,
                    device=device, cache_layout=layout, page_size=8, **kw))
                reset_counts()
                done = sched.run([Request(uid=u, prompt=x, max_new_tokens=g)
                                  for u, x, g in spec])
                if device == "cuda":
                    counts[label][layout] = read_counts()
                    paths[label][layout] = dict(quant_gemm.path_launches)
                tokens[device, layout] = {u: c.tokens.tolist()
                                          for u, c in done.items()}
                if layout == "paged":
                    check((sched.paged is not None)
                          == ("attn" in cfg.layer_pattern),
                          f"{label}: paged plane {sched.paged is not None} "
                          f"for the layer pattern {cfg.layer_pattern}")
        result[label] = {run: tokens["cuda", run] == tokens["cpu", run]
                         for run in ("static", "paged", "contiguous")}
        for run, want in smoke_kernels(cfg, quant).items():
            idle = [k for k in want if counts[label][run][k] == 0]
            check(not idle, f"{label} {run} on the card launched no {idle}: "
                  f"{counts[label][run]}")
    print(f"new archs' SMOKE f32: card tokens identical to the CPU's plain "
          f"run: {result}; the card's launches {counts}")
    REPORT["new_smoke_parity"] = {"tokens_identical": result,
                                  "card_launches": counts,
                                  "card_int8_paths": paths}
    check(all(all(r.values()) for r in result.values()),
          f"new archs' SMOKE tokens differ: {result}")


def smoke_kernels(cfg, quant: bool) -> dict:
    """The kernels each of a SMOKE case's card runs must launch: the GEMM
    (the int8 GEMM under --quantize) on every run of an arch with engine
    GEMMs (mamba2 has none), the grouped kernel on every run of a sorted
    MoE, the paged kernel on the paged run of an arch with "attn" blocks
    (f32 SMOKE: the sync routes)."""
    gemm = ["quant_gemm" if quant else "redas_gemm"] if model_gemms(cfg) else []
    if grouped_calls(cfg):
        gemm.append("grouped_gemm")
    want = {run: list(gemm) for run in ("static", "paged", "contiguous")}
    if "attn" in cfg.layer_pattern:
        want["paged"].append("paged_attention")
    return want


def phase_granite_quantize() -> dict:
    """granite-moe-1b-a400m under --quantize at full width: the launcher's
    static serve (einsum dispatch, SLOTS x (EINSUM_PROMPT + EINSUM_GEN));
    then GRANITE_QUANT_TRACE through the Scheduler, paged, with the sorted
    dispatch (its int8 grouped op loops the int8 GEMM over the experts,
    whose stacks stay float) and with einsum, each tick's ms beside the
    int8 launches by path, and one paged decode tick's logits of each
    dispatch, `hopper-int8` against `torch-ref-int8` from the same
    state (phase 12 holds the int8 kernel bit for bit at granite's
    shapes)."""
    cfg = get_config(GRANITE)
    layers, experts = cfg.n_layers, cfg.moe.n_experts
    serve_lib._ENGINES.clear()
    args = ["--arch", GRANITE, "--quantize", "--batch", str(SLOTS),
            "--prompt-len", str(EINSUM_PROMPT), "--seed", str(SEED)]
    launch_serve.main(args + ["--gen", "1"])             # warm-up
    reset_counts()
    out = launch_serve.main(args + ["--gen", str(EINSUM_GEN)])
    counts, paths = read_counts(), dict(quant_gemm.path_launches)
    want = {"decode": 4 * layers * (EINSUM_GEN - 1), "tiled": 4 * layers}
    print(f"granite --quantize static serve (einsum): {SLOTS} x "
          f"({EINSUM_PROMPT} + {EINSUM_GEN}) in {out['seconds']:.3f} s; int8 "
          f"launches by path {paths} (want {want}); launches {counts}")
    check(paths == want and counts["quant_gemm"] == sum(want.values())
          and all(v == 0 for k, v in counts.items() if k != "quant_gemm"),
          f"granite --quantize static serve: paths {paths}, counts {counts}")
    result = {"static": {"seconds": out["seconds"], "int8_paths": paths,
                         "counts": counts}}
    del out
    trace = launch_serve.parse_trace(GRANITE_QUANT_TRACE)
    scfg = serve_lib.ServeConfig(
        max_seq=max(p + g for p, g in trace) + 1, batch=SLOTS,
        kernel_backend="hopper", quantize=True, cache_dtype="int8",
        cache_layout="paged", page_size=PAGE)
    params = quantize_params(T.init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(SEED), device="cuda", dtype=torch.bfloat16))
    for impl in ("sort", "einsum"):
        icfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                                impl=impl))
        sched = Scheduler(params, icfg, scfg,
                          engine=Engine(backend=scfg.kernel_backend),
                          prefill_bucket=BUCKET)
        reqs = launch_serve.trace_requests(icfg, trace, SEED)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sched.run(reqs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts, paths = read_counts(), dict(quant_gemm.path_launches)
        ticks, calls = (sched.stats["decode_steps"],
                        sched.stats["prefill_calls"])
        grouped = 3 * layers * experts if impl == "sort" else 0
        want = {"decode": 4 * layers * ticks,
                "tiled": 4 * layers * calls + grouped * (ticks + calls)}
        tick_ms = sched.timings["decode_s"] * 1e3 / ticks
        print(f"granite --quantize paged serve ({impl}): {len(trace)} "
              f"requests in {seconds:.3f} s; {ticks} ticks, {tick_ms:.2f} ms "
              f"a tick (mean), {calls} prefill calls "
              f"({sched.timings['prefill_s'] * 1e3:.1f} ms); int8 launches by "
              f"path {paths} (want {want}), {grouped} of them a tick the "
              f"grouped op's per-expert calls; launches {counts}")
        check(paths == want
              and counts["paged_attention"] == layers * ticks
              and counts["quant_gemm"] == sum(want.values())
              and counts["redas_gemm"] == counts["grouped_gemm"] == 0,
              f"granite --quantize paged serve ({impl}): paths {paths}, "
              f"counts {counts}")
        check(len(sched.completions) == len(trace),
              f"granite --quantize paged serve ({impl}) served too few")
        gap = tick_gap(f"granite --quantize ({impl})", params, icfg, scfg,
                       sched.engine, trace,
                       ("torch-ref-int8", "hopper-int8"))
        result[f"paged_{impl}"] = {
            "trace": GRANITE_QUANT_TRACE, "seconds": seconds,
            "decode_ticks": ticks, "decode_ms_per_tick": tick_ms,
            "prefill_calls": calls,
            "prefill_ms": sched.timings["prefill_s"] * 1e3,
            "int8_paths": paths, "counts": counts,
            "grouped_int8_calls_per_tick": grouped, "tick_logits": gap}
        del sched
    REPORT["granite_quantize"] = result
    return result


# --------------------------------------------------------------------------
# speculative decoding, chunked prefill, async serving and sampling
# --------------------------------------------------------------------------

#: the draft's tokens a speculative tick: the verify is k + 1 = 5 wide
SPEC_K = 4
#: qwen2's chunked serve: two 2048-token prompts stream in 8 chunks of
#: 256 beside 8 short requests (6 admitted at once, 2 when they finish)
QWEN_CHUNK, CHUNK_TRACE = 256, "2048x16*2,256x16*8"
#: recurrentgemma-2b's chunked serve: 2560-token prompts in 5 chunks of
#: 512, whose 2048-row rings wrap across the chunks; its speculative
#: serve's trace
RGEMMA_CHUNK, RGEMMA_CHUNK_TRACE = 512, "2560x16*2,256x16*6"
RGEMMA_SPEC_TRACE = "512x16*8"
#: qwen2 under --quantize --speculate 4: a short trace
SPEC_QUANT_TRACE = "256x16*8"
#: the wait for an async serve's futures
ASYNC_WAIT_S = 600


class _VerifySpy:
    """While installed, keeps each `transformer.verify_step` call's
    greedy tokens g (B, W), accepted counts and active mask on the host
    (the Scheduler reads them back anyway)."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        self._orig = T.verify_step

        def spy(*args, **kw):
            g, n_acc, cache = self._orig(*args, **kw)
            self.calls.append((g.cpu(), n_acc.cpu(), kw["active"].cpu()))
            return g, n_acc, cache

        T.verify_step = spy
        return self

    def __exit__(self, *exc):
        T.verify_step = self._orig


def drive(sched, reqs, label: str, spy: _VerifySpy | None = None) -> dict:
    """Serve `reqs` through `sched` tick by tick, checking after every
    tick the paged plane's invariants (when it has one) and, with `spy`,
    that each slot's tokens of the tick are the head of that tick's
    verify argmax (all of the accepted prefix and the correction, unless
    the request ended in it).  Returns the seconds, and the ticks on
    which a slot was ingesting with the decode tokens they emitted."""
    for r in reqs:
        sched.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ticks, ingest_ticks, ingest_decode_tokens, bad = 0, 0, 0, []
    while sched.queue or sched.n_active:
        before = {i: (s.req.uid, len(s.emitted))
                  for i, s in enumerate(sched.slots)
                  if s is not None and not s.ingesting}
        ingesting = any(s is not None and s.ingesting for s in sched.slots)
        decoded = sched.stats["decode_tokens"]
        calls = len(spy.calls) if spy is not None else 0
        sched.step()
        ticks += 1
        # a slot admitted this tick ingests its first chunk in it
        ingesting |= any(s is not None and s.ingesting for s in sched.slots)
        if ingesting:
            ingest_ticks += 1
            ingest_decode_tokens += sched.stats["decode_tokens"] - decoded
        if sched.paged is not None:
            sched.paged.check_invariants()
        if spy is not None and before:
            check(len(spy.calls) == calls + 1, f"{label}: tick {ticks} ran "
                  f"{len(spy.calls) - calls} verify passes")
            g, n_acc, active = spy.calls[-1]
            for i, (uid, n) in before.items():
                s = sched.slots[i]
                toks = (s.emitted if s is not None and s.req.uid == uid
                        else sched.completions[uid].tokens.tolist())[n:]
                done = s is None or s.req.uid != uid
                if not (bool(active[i]) and toks == g[i, :len(toks)].tolist()
                        and (len(toks) == int(n_acc[i]) + 1
                             or (done and len(toks) <= int(n_acc[i]) + 1))):
                    bad.append((ticks, uid, toks, g[i].tolist(),
                                int(n_acc[i])))
        check(ticks < 10_000, f"{label}: the Scheduler did not drain")
    torch.cuda.synchronize()
    check(not bad, f"{label}: ticks whose tokens are not the verify's "
          f"argmax: {bad[:3]}")
    return {"seconds": time.perf_counter() - t0, "ticks": ticks,
            "ingest_ticks": ingest_ticks,
            "ingest_decode_tokens": ingest_decode_tokens}


def _rglru_split(cfg) -> tuple[dict, dict]:
    """An "rglru" layer's engine GEMMs, (K, N) -> calls, split into its
    recurrence's (lin_x, lin_y, w_a, w_x, lin_out: stepped token by token
    in a speculative pass) and its feed-forward's (token-wide)."""
    d, w = cfg.d_model, cfg.rglru_width or cfg.d_model
    rec = collections.Counter()
    for kn, c in (((d, w), 2), ((w, w), 2), ((w, d), 1)):  # d may equal w
        rec[kn] += c
    ffn = collections.Counter(layer_gemms(cfg, "rglru"))
    ffn.subtract(rec)
    return dict(rec), {kn: c for kn, c in ffn.items() if c}


def spec_calls(sched) -> collections.Counter:
    """The engine GEMM calls of a speculative serve, (M, K, N) -> calls:
    every prefill (the target's and the draft's) one pass at M = SLOTS x
    width; the draft's k proposals a tick one pass each at M = SLOTS; the
    verify and the draft's replay a tick each one (k + 1)-wide pass at M
    = SLOTS (k + 1), whose "rglru" recurrences step the k + 1 tokens one
    at a time at M = SLOTS (the decode step's GEMMs, as the JAX
    package's `_spec_block` scans them)."""
    cfg, st, k = sched.cfg, sched.stats, sched.spec_k
    wide, calls = SLOTS * (k + 1), collections.Counter()

    def add(m, gemms, times):
        for (kk, n), c in gemms.items():
            calls[m, kk, n] += c * times

    per_pass = model_gemms(cfg)
    for widths in (sched.prefill_width_calls, sched.draft_prefill_width_calls):
        for w, c in widths.items():
            add(SLOTS * w, per_pass, c)
    add(SLOTS, per_pass, k * st["spec_ticks"])
    rec, ffn = _rglru_split(cfg)
    for i in range(cfg.n_layers):
        kind = cfg.layer_pattern[i % len(cfg.layer_pattern)]
        if kind == "rglru":
            add(SLOTS, rec, (k + 1) * 2 * st["spec_ticks"])
            add(wide, ffn, 2 * st["spec_ticks"])
        else:
            add(wide, layer_gemms(cfg, kind), 2 * st["spec_ticks"])
    return calls


def check_plan_calls(label: str, eng, calls: collections.Counter
                     ) -> tuple[int, int]:
    """`check_reductions` and `check_os_routes` for a serve whose GEMM
    calls are given by (M, K, N): the streaming reductions equal the calls
    at the plan's multi-slab decisions, and the OS GEMMs the calls at its
    OS decisions, every one on the wgmma kernel.  Returns (reductions,
    wgmma OS calls)."""
    shapes = {(req.m, req.k, req.n): dec for req, dec in eng.plan
              if req.op == "gemm"}
    check(set(shapes) == {mkn for mkn, c in calls.items() if c},
          f"{label}: the plan's GEMM shapes {sorted(shapes)} are not the "
          f"serve's {sorted(calls)}")
    want_red = sum(calls[mkn] for mkn, dec in shapes.items()
                   if dec.meta_dict.get("slabs", 1) > 1)
    want_os = sum(calls[mkn] for mkn, dec in shapes.items()
                  if dec.dataflow == "os")
    red, os_, wgmma = (redas_gemm.reduce_launches, redas_gemm.launches["os"],
                       redas_gemm.os_wgmma_launches)
    print(f"{label}: {red} streaming reductions (the plan's multi-slab "
          f"decisions make {want_red}); {os_} OS GEMMs, {wgmma} on the wgmma "
          f"kernel (its OS decisions make {want_os})")
    check(red == want_red and os_ == wgmma == want_os,
          f"{label}: reductions {red} (want {want_red}), OS {os_} on wgmma "
          f"{wgmma} (want {want_os})")
    return red, wgmma


def _spec_serve(label: str, params, cfg, scfg, trace: str, eng,
                paged_kernel: int = 0) -> dict:
    """A speculative serve of `trace` through the Scheduler on `eng`,
    driven with the verify spy: the GEMM kernel exactly `spec_calls`'
    count (on an attention-only arch per_pass x (target prefill calls +
    draft prefill calls + spec ticks x (k + 2))), every OS call of the
    plan on wgmma, the paged kernel `paged_kernel` times (the verify
    takes the plain gather), no other kernel; a second pass through the
    same engine planning nothing new and serving the same tokens."""
    reqs = launch_serve.trace_requests(cfg, launch_serve.parse_trace(trace),
                                       SEED)
    sched = Scheduler(params, cfg, scfg, engine=eng, prefill_bucket=BUCKET)
    reset_counts()
    with _VerifySpy() as spy:
        run = drive(sched, reqs, label, spy)
    counts = read_counts()
    st = sched.stats
    ticks, calls = st["spec_ticks"], st["prefill_calls"]
    dcalls = sum(sched.draft_prefill_width_calls.values())
    gemms = spec_calls(sched)
    reduces, wgmma = check_plan_calls(label, eng, gemms)
    want = {"redas_gemm": sum(gemms.values()),
            "paged_attention": paged_kernel}
    if set(cfg.layer_pattern) <= {"attn", "local"}:
        # 7 a layer a pass: per_pass x (prefills + ticks x (k + 2))
        check(want["redas_gemm"] == sum(model_gemms(cfg).values())
              * (calls + dcalls + ticks * (SPEC_K + 2)),
              f"{label}: the GEMM formula")
    n_tok = sum(len(c.tokens) for c in sched.completions.values())
    accept = st["accepted_draft_tokens"] / max(st["draft_tokens"], 1)
    tick_ms = sched.timings["spec_s"] * 1e3 / max(ticks, 1)
    print(f"{label}: {len(reqs)} requests / {n_tok} tokens in "
          f"{run['seconds']:.3f} s, {n_tok / run['seconds']:.1f} tok/s over "
          f"{SLOTS} slots; {ticks} speculative ticks of k = {SPEC_K}, "
          f"{tick_ms:.3f} ms a tick (mean), {n_tok / ticks:.2f} tokens a tick "
          f"beside the prefills' first tokens; acceptance {accept:.3f} "
          f"({st['accepted_draft_tokens']} of {st['draft_tokens']} drafts); "
          f"{calls} target prefill calls, {dcalls} draft prefill calls; plan "
          f"{eng.plan.stats}; launches {counts} (want {want})")
    check(len(sched.completions) == len(reqs), f"{label}: served too few")
    check(all(counts[k] == v for k, v in want.items())
          and all(v == 0 for k, v in counts.items() if k not in want),
          f"{label} launches {counts}, not {want}")
    tokens = {u: c.tokens.tolist() for u, c in sched.completions.items()}
    for r in reqs:
        check(len(tokens[r.uid]) == r.max_new_tokens
              and all(0 <= t < cfg.vocab for t in tokens[r.uid]),
              f"{label} request {r.uid}")
    misses = eng.plan.misses
    again = Scheduler(params, cfg, scfg, engine=eng, prefill_bucket=BUCKET)
    again.run(launch_serve.trace_requests(cfg, launch_serve.parse_trace(
        trace), SEED))
    new_misses = eng.plan.misses - misses
    same = {u: c.tokens.tolist() for u, c in again.completions.items()} \
        == tokens
    print(f"{label}, second pass through the same engine: {new_misses} new "
          f"plan misses, tokens {'identical' if same else 'DIFFER'}")
    check(new_misses == 0 and same, f"{label}: second pass {new_misses} new "
          f"misses, tokens {'same' if same else 'differ'}")
    del again
    return {"trace": trace, "k": SPEC_K, "seconds": run["seconds"],
            "tokens": n_tok, "tokens_per_s": n_tok / run["seconds"],
            "spec_ticks": ticks, "ms_per_tick": tick_ms,
            "tokens_per_tick": n_tok / ticks, "acceptance": accept,
            "prefill_calls": calls, "draft_prefill_calls": dcalls,
            "prefill_ms": sched.timings["prefill_s"] * 1e3,
            "stats": {k: v for k, v in st.items() if k != "prefill_widths"},
            "plan": eng.plan.stats, "counts": counts, "os_wgmma": wgmma,
            "reductions": reduces, "decision_mix": decision_mix(eng),
            "second_pass_new_misses": new_misses, "sched": sched}


def _plain_serve(label: str, params, cfg, scfg, trace: str) -> dict:
    """The non-speculative serve of the same trace on its own engine, for
    scale: tokens/s and ms a tick (its first pass plans; the second is
    timed)."""
    reqs = lambda: launch_serve.trace_requests(  # noqa: E731
        cfg, launch_serve.parse_trace(trace), SEED)
    eng = Engine(backend=scfg.kernel_backend)
    Scheduler(params, cfg, scfg, engine=eng, prefill_bucket=BUCKET).run(reqs())
    sched = Scheduler(params, cfg, scfg, engine=eng, prefill_bucket=BUCKET)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sched.run(reqs())
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    n_tok = sum(len(c.tokens) for c in sched.completions.values())
    ticks = sched.stats["decode_steps"]
    out = {"seconds": seconds, "tokens_per_s": n_tok / seconds,
           "decode_ticks": ticks,
           "ms_per_tick": sched.timings["decode_s"] * 1e3 / ticks,
           "prefill_ms": sched.timings["prefill_s"] * 1e3,
           "tokens": {u: c.tokens.tolist()
                      for u, c in sched.completions.items()}}
    print(f"{label}, the same trace without speculation (second pass): "
          f"{n_tok} tokens in {seconds:.3f} s, {out['tokens_per_s']:.1f} "
          f"tok/s; {ticks} decode ticks, {out['ms_per_tick']:.3f} ms a tick")
    return out


def verify_gap(label: str, params, cfg, scfg, trace: str,
               backends=("torch-ref", "hopper"), f32_anchor: bool = False
               ) -> dict:
    """One verify pass's (SLOTS, k + 1, V) logits at full width from one
    state, the kernels' backend against its plain twin (`backends` =
    (plain, kernels)): the slots the trace's first Scheduler tick admits,
    after that tick, each scoring its last token and the draft's next k
    proposals.  `spec_commit` with keep 0 after each pass leaves the
    state as it was (rings and recurrent state restored; rows past the
    clock are written alike by every pass).  Held within LOGIT_LIMITS'
    rel-L2, or with `f32_anchor` no farther from the f32 model's pass
    (f32 weights, an f32 copy of the state, the plain versions) than
    F32_ANCHOR_LIMIT x the plain pass is."""
    probe = Scheduler(params, cfg, scfg, engine=Engine(backend=backends[1]),
                      prefill_bucket=BUCKET)
    for r in launch_serve.trace_requests(cfg, launch_serve.parse_trace(
            trace), SEED):
        probe.submit(r)
    probe.step()
    check(all(s is not None for s in probe.slots),
          f"{label}: the first tick did not fill the slots")
    active = torch.ones(SLOTS, dtype=torch.bool, device="cuda")
    last = torch.tensor([s.last_token for s in probe.slots],
                        dtype=torch.int32, device="cuda")
    kw = {}
    if probe.paged is not None:
        for i in range(SLOTS):
            pos = probe._frontier(i)
            for pg in range(pos // PAGE, (pos + SPEC_K) // PAGE + 1):
                probe.paged.ensure_decode_page(i, max(pos, pg * PAGE))
        kw["block_tables"] = torch.from_numpy(probe.paged.tables).cuda()
    with probe._scope():
        toks = torch.cat([last[:, None], T.draft_propose(
            probe.draft_params, probe.draft_cfg, probe.draft_cache, last,
            SPEC_K, compute_dtype=scfg.compute_dtype, active=active)], 1)

    def verify(p, cache, backend, dtype):
        before = read_counts()
        with torch.inference_mode(), use_engine(Engine(backend=backend)):
            logits, cache, undo = T.spec_forward(
                p, cfg, cache, toks, compute_dtype=dtype, active=active, **kw)
            T.spec_commit(cfg, cache, undo, torch.zeros_like(last))
        after = read_counts()
        return logits, {k: after[k] - before[k] for k in after}

    ref, plain_counts = verify(params, probe.cache, backends[0],
                               scfg.compute_dtype)
    got, counts = verify(params, probe.cache, backends[1],
                         scfg.compute_dtype)
    gap = _logit_gap(got, ref)
    gap["launches"] = {backends[0]: plain_counts, backends[1]: counts}
    check(tuple(got.shape) == (SLOTS, SPEC_K + 1, cfg.vocab)
          and bool(torch.isfinite(got).all()), f"{label}: verify logits "
          f"{tuple(got.shape)}")
    check(not any(plain_counts.values()) and any(counts.values())
          and counts["paged_attention"] == 0,
          f"{label}: the verify's launches {gap['launches']}")
    line = (f"{label}: one verify pass's ({SLOTS}, {SPEC_K + 1}, V) logits, "
            f"{backends[1]} vs {backends[0]}: rel-L2 {gap['rel_l2']:.4e}, "
            f"max|diff|/max|ref| {gap['rel_max']:.4e}, argmax agreement "
            f"{gap['argmax_agreement']:.3f}")
    if not f32_anchor:
        print(f"{line} (limit rel-L2 {LOGIT_LIMITS['rel_l2']})")
        check(math.isfinite(gap["rel_l2"])
              and gap["rel_l2"] <= LOGIT_LIMITS["rel_l2"],
              f"{label}: verify logit gap {gap}")
        return gap
    f32 = _to(params, torch.float32)
    cache32 = {"t": probe.cache["t"],
               "slots": _to(probe.cache["slots"], torch.float32),
               "tail": _to(probe.cache["tail"], torch.float32)}
    exact, _ = verify(f32, cache32, backends[0], torch.float32)
    del f32, cache32
    gap["hopper_vs_f32"] = _logit_gap(got, exact)
    gap["plain_vs_f32"] = _logit_gap(ref, exact)
    gap["f32_ratio"] = (gap["hopper_vs_f32"]["rel_l2"]
                        / gap["plain_vs_f32"]["rel_l2"])
    print(f"{line} (not gated); against the f32 model's pass rel-L2 "
          f"{gap['hopper_vs_f32']['rel_l2']:.4e}, the plain versions' "
          f"{gap['plain_vs_f32']['rel_l2']:.4e}: ratio {gap['f32_ratio']:.3f} "
          f"(limit {F32_ANCHOR_LIMIT})")
    check(gap["f32_ratio"] <= F32_ANCHOR_LIMIT, f"{label}: the kernels' "
          f"verify logits are {gap['f32_ratio']:.3f}x as far from the f32 "
          f"model as the plain versions'")
    return gap


def phase_spec_qwen(cfg) -> None:
    """qwen2-1.5b at full width, `--speculate 4 --draft self` on the paged
    layout over POSTURE_TRACE (bf16, `hopper`): `_spec_serve`'s checks
    (the paged kernel 0 times: the verify takes the plain gather, the
    draft's cache is contiguous), one verify pass's logits against
    `torch-ref`, and the acceptance share, tokens/s and ms a tick beside
    the non-speculative paged serve's on the same trace."""
    params = seeded_params(cfg)
    trace = launch_serve.parse_trace(POSTURE_TRACE)
    scfg = serve_lib.ServeConfig(
        max_seq=max(p + g for p, g in trace) + 1 + SPEC_K, batch=SLOTS,
        kernel_backend="hopper", cache_layout="paged", page_size=PAGE,
        speculate_k=SPEC_K, draft="self")
    label = f"{ARCH} --speculate {SPEC_K}"
    spec = _spec_serve(label, params, cfg, scfg, POSTURE_TRACE,
                       Engine(backend="hopper"))
    sched = spec.pop("sched")
    plain = _plain_serve(label, params, cfg, dataclasses.replace(
        scfg, speculate_k=0, draft=None), POSTURE_TRACE)
    agree = sum(plain["tokens"][u] == c.tokens.tolist()
                for u, c in sched.completions.items())
    print(f"{label}: {spec['tokens_per_s']:.1f} tok/s against "
          f"{plain['tokens_per_s']:.1f} without speculation "
          f"({spec['tokens_per_s'] / plain['tokens_per_s']:.2f}x); "
          f"{spec['ms_per_tick']:.3f} ms a speculative tick against "
          f"{plain['ms_per_tick']:.3f} a decode tick; acceptance "
          f"{spec['acceptance']:.3f}; tokens equal to the plain serve's for "
          f"{agree}/{len(trace)} requests (bf16: the verify's and decode's "
          f"GEMMs run at other M)")
    del sched
    spec["verify_logits"] = verify_gap(label, params, cfg, scfg,
                                       POSTURE_TRACE)
    plain.pop("tokens")
    REPORT["spec_qwen"] = {**spec, "plain": plain,
                           "requests_equal_to_plain": agree,
                           "self_int8": _self_int8_serve(params, cfg, scfg)}


def _self_int8_serve(params, cfg, scfg) -> dict:
    """The same trace with `--draft self-int8`: the draft's int8 copy of
    the weights, dequantized to bf16 at every call under the float engine
    (as the reference's `dense` does; slow on purpose, recorded and not
    gated), every GEMM on the ReDas kernel by `spec_calls`, each tick's
    tokens the head of its verify argmax."""
    label = f"{ARCH} --speculate {SPEC_K} --draft self-int8"
    sched = Scheduler(params, cfg, dataclasses.replace(scfg,
                                                       draft="self-int8"),
                      engine=Engine(backend="hopper"), prefill_bucket=BUCKET)
    reset_counts()
    with _VerifySpy() as spy:
        run = drive(sched, launch_serve.trace_requests(
            cfg, launch_serve.parse_trace(POSTURE_TRACE), SEED), label, spy)
    counts, st = read_counts(), sched.stats
    want = sum(spec_calls(sched).values())
    n_tok = sum(len(c.tokens) for c in sched.completions.values())
    out = {"seconds": run["seconds"], "tokens_per_s": n_tok / run["seconds"],
           "spec_ticks": st["spec_ticks"],
           "ms_per_tick": sched.timings["spec_s"] * 1e3 / st["spec_ticks"],
           "acceptance": st["accepted_draft_tokens"] / st["draft_tokens"],
           "counts": counts}
    print(f"{label}: {n_tok} tokens in {run['seconds']:.3f} s, "
          f"{out['tokens_per_s']:.1f} tok/s; {st['spec_ticks']} ticks, "
          f"{out['ms_per_tick']:.3f} ms a tick; acceptance "
          f"{out['acceptance']:.3f}; launches {counts} (want GEMM {want})")
    check(counts["redas_gemm"] == want
          and all(v == 0 for k, v in counts.items() if k != "redas_gemm"),
          f"{label}: launches {counts}, want GEMM {want}")
    return out


def phase_spec_quantize(cfg) -> None:
    """qwen2-1.5b under `--quantize --speculate 4` (int8 weights and KV
    cache, the draft the same int8 params) on SPEC_QUANT_TRACE, paged:
    the int8 kernel's launches by path exact (the draft's k proposals a
    tick at M = 8 on the decode path; the verify, the replay and every
    prefill on the tiled path), the int8-pool paged kernel 0 times, no
    float GEMM; one verify pass's logits against `torch-ref-int8`."""
    trace = launch_serve.parse_trace(SPEC_QUANT_TRACE)
    params = quantize_params(seeded_params(cfg))
    scfg = serve_lib.ServeConfig(
        max_seq=max(p + g for p, g in trace) + 1 + SPEC_K, batch=SLOTS,
        kernel_backend="hopper", quantize=True, cache_dtype="int8",
        cache_layout="paged", page_size=PAGE, speculate_k=SPEC_K,
        draft="self")
    label = f"{ARCH} --quantize --speculate {SPEC_K}"
    eng = Engine(backend=scfg.kernel_backend)
    sched = Scheduler(params, cfg, scfg, engine=eng, prefill_bucket=BUCKET)
    reset_counts()
    with _VerifySpy() as spy:
        run = drive(sched, launch_serve.trace_requests(cfg, trace, SEED),
                    label, spy)
    counts, paths = read_counts(), dict(quant_gemm.path_launches)
    st = sched.stats
    ticks, calls = st["spec_ticks"], st["prefill_calls"]
    dcalls = sum(sched.draft_prefill_width_calls.values())
    per = 7 * cfg.n_layers
    want = {"decode": per * SPEC_K * ticks,
            "tiled": per * (calls + dcalls + 2 * ticks)}
    print(f"{label}: {len(trace)} requests in {run['seconds']:.3f} s; "
          f"{ticks} speculative ticks, "
          f"{sched.timings['spec_s'] * 1e3 / ticks:.2f} ms a tick, acceptance "
          f"{st['accepted_draft_tokens']}/{st['draft_tokens']}; int8 launches "
          f"by path {paths} (want {want}); launches {counts}")
    check(paths == want and counts["quant_gemm"] == sum(want.values())
          and all(v == 0 for k, v in counts.items() if k != "quant_gemm"),
          f"{label}: paths {paths}, counts {counts}")
    check(len(sched.completions) == len(trace), f"{label}: served too few")
    gap = verify_gap(label, params, cfg, scfg, SPEC_QUANT_TRACE,
                     ("torch-ref-int8", "hopper-int8"))
    REPORT["spec_quantize"] = {
        "trace": SPEC_QUANT_TRACE, "seconds": run["seconds"],
        "spec_ticks": ticks,
        "ms_per_tick": sched.timings["spec_s"] * 1e3 / ticks,
        "stats": {k: v for k, v in st.items() if k != "prefill_widths"},
        "int8_paths": paths, "counts": counts, "verify_logits": gap}


def _chunked_prefill(params, cfg, scfg, prompt, chunk: int | None,
                     backend: str = "hopper"):
    """The last-row logits (B, 1, V) of `prompt` (B, S) prefilled into a
    fresh cache of `scfg` on `backend`, in one call or in chunks of
    `chunk` (`prefill(hist_len=...)`), through block tables from a
    `PagedKV` on the paged layout."""
    b, s = prompt.shape
    cache = serve_lib.init_cache(cfg, scfg)
    kw = {}
    if scfg.cache_layout == "paged" and "attn" in cfg.layer_pattern:
        pkv = PagedKV(batch=b, max_seq=scfg.max_seq, page_size=scfg.page_size,
                      n_pages=scfg.resolved_n_pages, prefix_sharing=False)
        for i in range(b):
            pkv.admit(i, prompt[i].tolist())
        kw["block_tables"] = torch.from_numpy(pkv.tables).cuda()
    step = chunk or s
    with torch.inference_mode(), use_engine(Engine(backend=backend)):
        for h in range(0, s, step):
            hist = torch.full((b,), h, dtype=torch.int32, device="cuda")
            part = prompt[:, h:h + step]
            extra = {}
            if chunk is not None or "block_tables" in kw:
                extra = {"hist_len": hist}
                if "block_tables" in kw:
                    extra["hist_pages"] = h // scfg.page_size
            logits, cache = T.prefill(
                params, cfg, part, cache, compute_dtype=scfg.compute_dtype,
                lengths=torch.full((b,), part.shape[1], dtype=torch.int32,
                                   device="cuda"), **kw, **extra)
    return logits


def _chunk_serve(label: str, params, cfg, scfg, trace: str, chunk: int,
                 eng) -> dict:
    """A chunked serve of `trace` through the Scheduler, driven tick by
    tick: the GEMM kernel per_pass x (ticks + prefill calls), the paged
    kernel once a paged layer a decode tick, no other kernel; the prefill
    calls, widths and tokens the trace's schedule gives (the long prompts
    in ceil(S / chunk) calls of width `chunk`, the short ones admitted in
    groups of their bucketed width), decode tokens emitted on ticks where
    a slot was ingesting; a second pass planning nothing new."""
    trace_list = launch_serve.parse_trace(trace)
    reqs = launch_serve.trace_requests(cfg, trace_list, SEED)
    sched = Scheduler(params, cfg, scfg, engine=eng, prefill_bucket=BUCKET)
    reset_counts()
    run = drive(sched, reqs, label)
    counts = read_counts()
    st, per_pass = sched.stats, model_gemms(cfg)
    ticks, calls = st["decode_steps"], st["prefill_calls"]
    passes = _paged_passes(sched)
    reduces = check_reductions(label, eng, per_pass, 1, passes)
    wgmma = check_os_routes(label, eng, per_pass, 1, passes)
    paged = paged_layers(cfg) if sched.paged is not None else 0
    want = {"redas_gemm": sum(per_pass.values()) * (ticks + calls),
            "paged_attention": paged * ticks}
    long = [p for p, _ in trace_list if p > chunk]
    chunk_calls = max(-(-p // chunk) for p in long)
    widths = {chunk} | {-(-p // BUCKET) * BUCKET for p, _ in trace_list
                        if p <= chunk}
    tokens_in = sum(p for p, _ in trace_list)
    n_tok = sum(len(c.tokens) for c in sched.completions.values())
    print(f"{label}: {len(reqs)} requests / {n_tok} tokens in "
          f"{run['seconds']:.3f} s, {n_tok / run['seconds']:.1f} tok/s over "
          f"{SLOTS} slots; {ticks} decode ticks "
          f"({sched.timings['decode_s'] * 1e3 / ticks:.3f} ms a tick), "
          f"{calls} prefill calls ({chunk_calls} chunk calls of {chunk}) of "
          f"widths {sorted(st['prefill_widths'])}, "
          f"{sched.timings['prefill_s'] * 1e3:.2f} ms in all, "
          f"{st['prefill_tokens']} prefill tokens (want {tokens_in}); "
          f"{run['ingest_decode_tokens']} decode tokens emitted on the "
          f"{run['ingest_ticks']} ticks a slot was ingesting; plan "
          f"{eng.plan.stats}; launches {counts} (want {want})")
    check(len(sched.completions) == len(reqs), f"{label}: served too few")
    check(all(counts[k] == v for k, v in want.items())
          and all(v == 0 for k, v in counts.items() if k not in want),
          f"{label} launches {counts}, not {want}")
    check(st["prefill_widths"] == widths and st["prefill_tokens"] == tokens_in
          and sched.prefill_width_calls[chunk] >= chunk_calls
          and run["ingest_ticks"] == chunk_calls,
          f"{label}: prefill widths {st['prefill_widths']} (want {widths}), "
          f"tokens {st['prefill_tokens']} (want {tokens_in}), "
          f"{run['ingest_ticks']} ingesting ticks (want {chunk_calls})")
    check(run["ingest_decode_tokens"] > 0,
          f"{label}: no decode token on a tick where a slot was ingesting")
    tokens = {u: c.tokens.tolist() for u, c in sched.completions.items()}
    for r in reqs:
        check(len(tokens[r.uid]) == r.max_new_tokens
              and all(0 <= t < cfg.vocab for t in tokens[r.uid]),
              f"{label} request {r.uid}")
    misses = eng.plan.misses
    again = Scheduler(params, cfg, scfg, engine=eng, prefill_bucket=BUCKET)
    again.run(launch_serve.trace_requests(cfg, trace_list, SEED))
    new_misses = eng.plan.misses - misses
    same = {u: c.tokens.tolist() for u, c in again.completions.items()} \
        == tokens
    print(f"{label}, second pass through the same engine: {new_misses} new "
          f"plan misses, tokens {'identical' if same else 'DIFFER'}")
    check(new_misses == 0 and same, f"{label}: second pass {new_misses} new "
          f"misses, tokens {'same' if same else 'differ'}")
    return {"trace": trace, "chunk": chunk, "seconds": run["seconds"],
            "tokens_per_s": n_tok / run["seconds"], "decode_ticks": ticks,
            "ms_per_tick": sched.timings["decode_s"] * 1e3 / ticks,
            "prefill_calls": calls, "chunk_calls": chunk_calls,
            "prefill_widths": sorted(st["prefill_widths"]),
            "prefill_ms": sched.timings["prefill_s"] * 1e3,
            "ingest_ticks": run["ingest_ticks"],
            "ingest_decode_tokens": run["ingest_decode_tokens"],
            "stats": {k: v for k, v in st.items() if k != "prefill_widths"},
            "plan": eng.plan.stats, "counts": counts, "os_wgmma": wgmma,
            "reductions": reduces, "second_pass_new_misses": new_misses,
            "tokens_by_uid": tokens}


def phase_chunk_qwen(cfg) -> None:
    """qwen2-1.5b at full width, chunked (`--prefill-chunk 256`) on the
    paged layout over CHUNK_TRACE: a 2048-token prompt's last chunk's
    last-row logits against its unchunked prefill's (both `hopper`,
    within LOGIT_LIMITS); `_chunk_serve`'s checks; then the same trace
    through `serve_async` on the same engine: every future awaited under
    a timeout, the completions equal to `run()`'s per uid, bit for bit."""
    params = seeded_params(cfg)
    trace = launch_serve.parse_trace(CHUNK_TRACE)
    scfg = serve_lib.ServeConfig(
        max_seq=max(p + g for p, g in trace) + 1, batch=SLOTS,
        kernel_backend="hopper", cache_layout="paged", page_size=PAGE,
        prefill_chunk=QWEN_CHUNK)
    label = f"{ARCH} --prefill-chunk {QWEN_CHUNK}"
    prompt = torch.from_numpy(launch_serve.trace_requests(
        cfg, trace, SEED)[0].prompt).cuda()[None].expand(2, -1).contiguous()
    one = dataclasses.replace(scfg, batch=2, prefill_chunk=None)
    whole = _chunked_prefill(params, cfg, one, prompt, None)
    parts = _chunked_prefill(params, cfg, one, prompt, QWEN_CHUNK)
    gap = _logit_gap(parts, whole)
    print(f"{label}: a {prompt.shape[1]}-token prompt's last-row logits "
          f"after {prompt.shape[1] // QWEN_CHUNK} chunks vs one prefill "
          f"(hopper, paged): rel-L2 {gap['rel_l2']:.4e}, max|diff|/max|ref| "
          f"{gap['rel_max']:.4e}, argmax agreement "
          f"{gap['argmax_agreement']:.2f} (limits {LOGIT_LIMITS})")
    check(gap["rel_l2"] <= LOGIT_LIMITS["rel_l2"]
          and gap["rel_max"] <= LOGIT_LIMITS["rel_max"],
          f"{label}: chunked vs unchunked logits {gap}")
    eng = Engine(backend="hopper")
    out = _chunk_serve(label, params, cfg, scfg, CHUNK_TRACE, QWEN_CHUNK, eng)
    sched = Scheduler(params, cfg, scfg, engine=eng, prefill_bucket=BUCKET)
    reqs = launch_serve.trace_requests(cfg, trace, SEED)
    reset_counts()
    t0 = time.perf_counter()
    with sched.serve_async(max_queue=len(reqs)) as srv:
        futs = {r.uid: srv.submit(r) for r in reqs}
        comps = {u: f.result(timeout=ASYNC_WAIT_S) for u, f in futs.items()}
    seconds = time.perf_counter() - t0
    same = {u: c.tokens.tolist() for u, c in comps.items()} \
        == out["tokens_by_uid"]
    print(f"{label} through serve_async: {len(comps)} futures in "
          f"{seconds:.3f} s, completions "
          f"{'identical to' if same else 'DIFFER from'} run()'s; launches "
          f"{read_counts()}")
    check(same, f"{label}: serve_async's completions differ from run()'s")
    check(not sched.n_active and not sched.queue and srv.error is None,
          f"{label}: serve_async left work or died")
    out.pop("tokens_by_uid")
    REPORT["chunk_qwen"] = {**out, "chunk_vs_whole_logits": gap,
                            "async_seconds": seconds,
                            "async_equals_run": same}


def phase_rgemma_spec_chunk() -> None:
    """recurrentgemma-2b at full width (bf16, contiguous; window 2048):
    `--prefill-chunk 512` over RGEMMA_CHUNK_TRACE (rings wrap across the
    chunks, the RG-LRU state continues): the chunked prefill's last-row
    logits of two 2560-token prompts, `hopper` and `torch-ref`, each
    against the f32 model's one-call prefill (PR 33's rule: the kernels
    no farther than F32_ANCHOR_LIMIT x the plain versions), and
    `_chunk_serve`'s checks; then `--speculate 4` over RGEMMA_SPEC_TRACE
    (the ring undo and the recurrent stash): `_spec_serve`'s checks and
    one verify pass's logits by the same rule."""
    cfg = get_config(RGEMMA)
    params = seeded_params(cfg)
    trace = launch_serve.parse_trace(RGEMMA_CHUNK_TRACE)
    scfg = serve_lib.ServeConfig(
        max_seq=max(p + g for p, g in trace) + 1, batch=SLOTS,
        kernel_backend="hopper", prefill_chunk=RGEMMA_CHUNK)
    label = f"{RGEMMA} --prefill-chunk {RGEMMA_CHUNK}"
    reqs = launch_serve.trace_requests(cfg, trace, SEED)
    prompt = torch.from_numpy(np.stack([r.prompt for r in reqs[:2]])).cuda()
    one = dataclasses.replace(scfg, batch=2, prefill_chunk=None)
    got = _chunked_prefill(params, cfg, one, prompt, RGEMMA_CHUNK)
    ref = _chunked_prefill(params, cfg, one, prompt, RGEMMA_CHUNK,
                           "torch-ref")
    with torch.inference_mode(), use_engine(Engine(backend="torch-ref")):
        f32 = _to(params, torch.float32)
        cache = T.init_cache(cfg, T.CacheSpec(one.max_seq, 2),
                             dtype=torch.float32, device="cuda")
        exact = T.prefill(f32, cfg, prompt, cache,
                          compute_dtype=torch.float32)[0]
        del f32, cache
    chunk_gap = {"hopper_vs_f32": _logit_gap(got, exact),
                 "plain_vs_f32": _logit_gap(ref, exact),
                 "hopper_vs_plain": _logit_gap(got, ref)}
    chunk_gap["f32_ratio"] = (chunk_gap["hopper_vs_f32"]["rel_l2"]
                              / chunk_gap["plain_vs_f32"]["rel_l2"])
    print(f"{label}: two {prompt.shape[1]}-token prompts in chunks of "
          f"{RGEMMA_CHUNK}, last-row logits against the f32 model's one-call "
          f"prefill: hopper rel-L2 {chunk_gap['hopper_vs_f32']['rel_l2']:.4e}, "
          f"the plain versions' {chunk_gap['plain_vs_f32']['rel_l2']:.4e}: "
          f"ratio {chunk_gap['f32_ratio']:.3f} (limit {F32_ANCHOR_LIMIT}); "
          f"hopper vs plain {chunk_gap['hopper_vs_plain']['rel_l2']:.4e}")
    check(chunk_gap["f32_ratio"] <= F32_ANCHOR_LIMIT,
          f"{label}: chunked logits {chunk_gap}")
    chunked = _chunk_serve(label, params, cfg, scfg, RGEMMA_CHUNK_TRACE,
                           RGEMMA_CHUNK, Engine(backend="hopper"))
    chunked.pop("tokens_by_uid")
    torch.cuda.empty_cache()
    strace = launch_serve.parse_trace(RGEMMA_SPEC_TRACE)
    sscfg = serve_lib.ServeConfig(
        max_seq=max(p + g for p, g in strace) + 1 + SPEC_K, batch=SLOTS,
        kernel_backend="hopper", speculate_k=SPEC_K, draft="self")
    slabel = f"{RGEMMA} --speculate {SPEC_K}"
    spec = _spec_serve(slabel, params, cfg, sscfg, RGEMMA_SPEC_TRACE,
                       Engine(backend="hopper"))
    spec.pop("sched")
    plain = _plain_serve(slabel, params, cfg, dataclasses.replace(
        sscfg, speculate_k=0, draft=None), RGEMMA_SPEC_TRACE)
    plain.pop("tokens")
    spec["verify_logits"] = verify_gap(slabel, params, cfg, sscfg,
                                       RGEMMA_SPEC_TRACE, f32_anchor=True)
    REPORT["rgemma_chunk_spec"] = {"chunk_logits": chunk_gap,
                                   "chunked": chunked, "spec": spec,
                                   "plain": plain}


def _spec_smoke_cases() -> list[tuple]:
    """(label, arch, cfg, ServeConfig keywords, draft seed or None) of the
    SMOKE speculative and chunked serves."""
    kinds = [ARCH, MIXTRAL, MAMBA, RGEMMA]
    cases = []
    for arch in kinds:
        cfg = get_config(arch, smoke=True)
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=8.0))
        spec = {"speculate_k": SPEC_K, "draft": "self"}
        cases += [(f"{arch} spec self", arch, cfg, spec, None),
                  (f"{arch} spec disagreeing", arch, cfg, spec, SEED + 7),
                  (f"{arch} spec self-int8", arch, cfg,
                   {**spec, "draft": "self-int8"}, None),
                  (f"{arch} chunk", arch, cfg, {"prefill_chunk": 8}, None)]
    granite = _sorted(get_config(GRANITE, smoke=True))
    cases += [(f"{GRANITE} sorted spec self", GRANITE,
               dataclasses.replace(granite, moe=dataclasses.replace(
                   granite.moe, capacity_factor=8.0)),
               {"speculate_k": SPEC_K, "draft": "self"}, None)]
    qwen = get_config(ARCH, smoke=True)
    paged = {"cache_layout": "paged", "page_size": 8}
    cases += [(f"{ARCH} chunk paged", ARCH, qwen,
               {**paged, "prefill_chunk": 8}, None),
              (f"{ARCH} chunk int8", ARCH, qwen,
               {"prefill_chunk": 8, "cache_dtype": "int8"}, None),
              (f"{GEMMA3} chunk paged", GEMMA3, get_config(GEMMA3, smoke=True),
               {**paged, "prefill_chunk": 8}, None),
              (f"{ARCH} chunk paged spec", ARCH, qwen,
               {**paged, "prefill_chunk": 8, "speculate_k": SPEC_K,
                "draft": "self"}, None)]
    return cases


def phase_spec_chunk_smoke() -> None:
    """The SMOKE configurations in f32: speculation (self, disagreeing and
    self-int8 drafts) and chunking on the four cache kinds (qwen2-1.5b,
    mixtral-8x7b, mamba2-780m, recurrentgemma-2b), speculation on granite
    sorted, chunking on qwen paged and under an int8 cache and on gemma3
    paged, chunking with speculation: the card's tokens (`hopper`) equal
    the CPU's plain run (`torch-ref`) per uid, and on the card a
    speculative or chunked serve's tokens equal the plain serve's (a
    float cache: the int8 cache's chunked tokens are held to the CPU's
    chunked run only).  Then `generate(temperature=0.7, key=)` on the
    card repeats its tokens for the same seed."""
    rng = np.random.default_rng(SEED)
    spec = [(uid, rng.integers(0, 128, int(rng.integers(5, 31))).astype(
        np.int32), int(rng.integers(3, 9))) for uid in range(6)]
    base = {"max_seq": 48, "batch": 3, "compute_dtype": "float32",
            "cache_dtype": "float32"}
    weights, plains, result, counts = {}, {}, {}, {}

    def serve_on(device, cfg, arch, kw, draft_seed):
        key = (arch, cfg.moe.impl if cfg.moe else None)
        if key not in weights:
            cpu = T.init_params(cfg, generator=torch.Generator().manual_seed(
                SEED), dtype=torch.float32)
            weights[key] = {"cpu": cpu, "cuda": _to(cpu, "cuda")}
        params = weights[key][device]
        extra = {}
        if draft_seed is not None:
            draft = T.init_params(cfg, generator=torch.Generator().manual_seed(
                draft_seed), dtype=torch.float32)
            extra = {"draft_params": _to(draft, device), "draft_cfg": cfg}
        scfg = serve_lib.ServeConfig(**{**base, **kw}, device=device,
                                     kernel_backend="hopper" if device
                                     == "cuda" else "torch-ref")
        sched = Scheduler(params, cfg, scfg, **extra)
        done = sched.run([Request(uid=u, prompt=x, max_new_tokens=g)
                          for u, x, g in spec], max_steps=500)
        if sched.paged is not None:
            sched.paged.check_invariants()
        return {u: c.tokens.tolist() for u, c in done.items()}, sched.stats

    for label, arch, cfg, kw, draft_seed in _spec_smoke_cases():
        tokens = {}
        for device in ("cpu", "cuda"):
            reset_counts()
            tokens[device], stats = serve_on(device, cfg, arch, kw,
                                             draft_seed)
            if device == "cuda":
                counts[label] = read_counts()
        plain_kw = {k: v for k, v in kw.items()
                    if k not in ("speculate_k", "draft", "prefill_chunk")}
        pkey = (label.split(" ")[0], tuple(sorted(plain_kw.items())))
        if pkey not in plains:
            plains[pkey] = serve_on("cuda", cfg, arch, plain_kw, None)[0]
        result[label] = {
            "card_equals_cpu": tokens["cuda"] == tokens["cpu"],
            "card_equals_card_plain": (tokens["cuda"] == plains[pkey]
                                       if kw.get("cache_dtype") != "int8"
                                       else None),
            "spec_ticks": stats["spec_ticks"],
            "accepted": [stats["accepted_draft_tokens"],
                         stats["draft_tokens"]]}
        check(sum(counts[label].values()) > 0 or not model_gemms(cfg),
              f"{label}: the card serve launched no kernel")
    print("speculative and chunked SMOKE f32, card vs the CPU's plain run "
          "and vs the card's plain serve: "
          + "; ".join(f"{k}: {v}" for k, v in result.items()))
    bad = [k for k, v in result.items()
           if not v["card_equals_cpu"] or v["card_equals_card_plain"] is False]
    check(not bad, f"speculative / chunked SMOKE tokens differ: {bad}")
    cfg = get_config(ARCH, smoke=True)
    params = weights[(ARCH, None)]["cuda"]
    scfg = serve_lib.ServeConfig(**{**base, "batch": 2}, device="cuda",
                                 kernel_backend="hopper")
    prompt = torch.randint(0, cfg.vocab, (2, 12), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(SEED + 1), dtype=torch.int32)
    sampled = [serve_lib.generate(
        params, cfg, scfg, prompt, 8, temperature=0.7,
        key=torch.Generator(device="cuda").manual_seed(seed)).cpu()
        for seed in (SEED, SEED, SEED + 1)]
    repeat = torch.equal(sampled[0], sampled[1])
    print(f"generate(temperature=0.7) on the card: tokens "
          f"{sampled[0].tolist()}; the same seed "
          f"{'repeats them' if repeat else 'DOES NOT repeat them'}, another "
          f"seed gives {sampled[2].tolist()}")
    check(repeat and bool(((sampled[0] >= 0) & (sampled[0] < cfg.vocab))
                          .all()), "sampled generate did not repeat")
    REPORT["spec_chunk_smoke"] = {"cases": result, "card_launches": counts,
                                  "sampled_repeat": repeat}


# --------------------------------------------------------------------------
# Phases 38-39: the accelerator plane and warm-started serving
# --------------------------------------------------------------------------

#: the quickstart's request: TinyYOLO-V2's conv2 as a GEMM (the paper's
#: Fig. 22 case-study layer), at the quickstart's default width
QUICKSTART = KernelRequest("gemm", 43264, 144, 32, name="tinyyolo-v2/conv2")
#: the paper's suite means (Sec. 5.2-5.3), against which the analytical
#: model's modeled ratios are printed
PAPER_SPEEDUP, PAPER_EDP = 4.6, 8.3
#: the simulator against its CPU run, (dataflow, M, K, N, logical shape)
SIM_CASES = (("os", 64, 144, 32, None), ("ws", 512, 144, 32, (384, 32)),
             ("is", 32, 96, 200, None))
SIM_TOL = 1e-6
#: `Engine(AnalyticalCostModel()).matmul` against float64, and the SMOKE
#: forward on the simulator against `torch-ref` (the reference's own
#: tolerance for its simulator engine)
ASIC_TOL = 1e-4


def _close(got: torch.Tensor, want: torch.Tensor, tol: float) -> dict:
    """max |got - want| and whether |got - want| <= tol + tol |want|
    everywhere (rtol = atol = tol)."""
    got, want = got.double().cpu(), want.double().cpu()
    diff = (got - want).abs()
    return {"max_abs_err": diff.max().item(),
            "ok": bool((diff <= tol + tol * want.abs()).all())}


def _geomean(xs) -> float:
    return math.exp(sum(math.log(x) for x in xs) / len(xs))


def phase_plane1() -> None:
    """The paper's accelerator plane on the card's host and the card:
    the mapper's pick for the quickstart request on ReDas and on the
    fixed TPU-like array, the suite's modeled speedups and EDP ratios,
    the simulator on CUDA tensors against its CPU run, the conv2 GEMM
    through `Engine(AnalyticalCostModel())` against float64, and qwen2
    SMOKE's forward with every engine GEMM on the simulator."""
    out = REPORT["plane1"] = {}
    # (a) the quickstart request on both specs
    picks = {}
    for name in ("redas", "tpu"):
        dec = AnalyticalCostModel(SPECS[name]).decide(QUICKSTART)
        meta = dec.meta_dict
        picks[name] = {"dataflow": dec.dataflow,
                       "shape": (meta["shape_rows"], meta["shape_cols"]),
                       "tile": (dec.bm, dec.bk, dec.bn),
                       "modeled_cycles": meta["cycles"],
                       "pe_utilization": meta["pe_utilization"]}
    speedup = picks["tpu"]["modeled_cycles"] / picks["redas"]["modeled_cycles"]
    print(f"plane 1, {QUICKSTART.name} (modeled by the analytical model for "
          f"the paper's 128x128 array, not timed): ReDas picks "
          f"{picks['redas']['dataflow'].upper()} on "
          f"{picks['redas']['shape'][0]}x{picks['redas']['shape'][1]}, tile "
          f"{picks['redas']['tile']}, modeled {speedup:.3f}x the fixed array "
          f"(PE utilization {picks['redas']['pe_utilization']:.4f} against "
          f"{picks['tpu']['pe_utilization']:.4f})")
    out["quickstart"] = {"picks": picks, "modeled_speedup": speedup}
    # (b) the paper's suite on both specs
    t0 = time.perf_counter()
    mapped = {(acc, abbr): ReDasMapper(SPECS[acc]).map_model(
        WORKLOADS[abbr].gemms) for acc in ("redas", "tpu")
        for abbr in WORKLOADS}
    map_s = time.perf_counter() - t0
    suite = {}
    for abbr, w in WORKLOADS.items():
        energy = {acc: model_energy(SPECS[acc], mapped[acc, abbr],
                                    w.vector_elements) for acc in ("redas", "tpu")}
        suite[abbr] = {
            "modeled_speedup": (mapped["tpu", abbr].total_cycles
                                / mapped["redas", abbr].total_cycles),
            "modeled_edp_ratio": energy["tpu"].edp / energy["redas"].edp}
    geo_s = _geomean([s["modeled_speedup"] for s in suite.values()])
    geo_e = _geomean([s["modeled_edp_ratio"] for s in suite.values()])
    print(f"plane 1, the paper's suite (modeled ReDas over the TPU-like "
          f"array; {len(WORKLOADS) * 2} map_model calls in {map_s:.3f} s on "
          f"the host): " + ", ".join(
              f"{a} {s['modeled_speedup']:.3f}x / EDP {s['modeled_edp_ratio']:.3f}x"
              for a, s in suite.items()))
    print(f"  geometric means: modeled speedup {geo_s:.3f}x (paper "
          f"{PAPER_SPEEDUP}x), modeled EDP ratio {geo_e:.3f}x (paper "
          f"{PAPER_EDP}x)")
    check(geo_s > 1.0 and geo_e > 1.0, "the modeled suite shows no gain")
    out["suite"] = {"workloads": suite, "geomean_modeled_speedup": geo_s,
                    "geomean_modeled_edp_ratio": geo_e, "map_host_s": map_s}
    # (c) the simulator on CUDA tensors against its CPU run
    gen = torch.Generator().manual_seed(SEED)
    sims = []
    for df, m, k, n, shape in SIM_CASES:
        a, b = torch.randn(m, k, generator=gen), torch.randn(k, n, generator=gen)
        shape = None if shape is None else LogicalShape(*shape)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, cycles = simulator.simulate_gemm(a.cuda(), b.cuda(),
                                              Dataflow(df), shape)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        want, want_cycles = simulator.simulate_gemm(a, b, Dataflow(df), shape)
        gap = _close(got, want, SIM_TOL)
        exact = _close(got, a.double() @ b.double(), ASIC_TOL)
        sims.append({"case": f"{df} {m}x{k}x{n}", "cycles": cycles,
                     "wall_ms": ms, **gap, "vs_float64": exact["max_abs_err"]})
        check(gap["ok"] and exact["ok"] and cycles == want_cycles,
              f"simulator {df} ({m}, {k}, {n}) on the card: {gap}, cycles "
              f"{cycles} against {want_cycles}")
    a = torch.randn(11, 256, 144, generator=gen)
    b = torch.randn(11, 144, 32, generator=gen)
    got, cycles = simulator.simulate_gemm_batch(
        a.cuda(), b.cuda(), Dataflow.WS, LogicalShape(384, 32))
    want, want_cycles = simulator.simulate_gemm_batch(
        a, b, Dataflow.WS, LogicalShape(384, 32))
    gap = _close(got, want, SIM_TOL)
    sims.append({"case": "ws batch 11 x 256x144x32 on 384x32",
                 "cycles": cycles, **gap})
    check(gap["ok"] and cycles == want_cycles,
          f"simulate_gemm_batch on the card: {gap}, cycles {cycles}")
    for s in sims:
        print(f"  simulator on the card, {s['case']}: {s['cycles']} cycles, "
              f"max |card - CPU| {s['max_abs_err']:.3g} (limit {SIM_TOL})")
    out["simulator"] = sims
    # (d) conv2 through the ASIC engine on the card
    eng = Engine(AnalyticalCostModel())
    a = torch.randn(QUICKSTART.m, QUICKSTART.k, generator=gen)
    b = torch.randn(QUICKSTART.k, QUICKSTART.n, generator=gen)
    ad, bd = a.cuda(), b.cuda()
    redas_gemm.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = eng.matmul(ad, bd)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    eng.matmul(ad, bd)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    prof = _profile(lambda: eng.matmul(ad, bd))
    gap = _close(got, a.double() @ b.double(), ASIC_TOL)
    (req, dec), = eng.plan
    meta = dec.meta_dict
    print(f"conv2 {QUICKSTART.m}x{QUICKSTART.k} @ {QUICKSTART.k}x"
          f"{QUICKSTART.n} f32 on the simulator ({dec.backend}): "
          f"{dec.dataflow.upper()} on {meta['shape_rows']}x"
          f"{meta['shape_cols']}, tile ({dec.bm}, {dec.bk}, {dec.bn}), "
          f"modeled {meta['cycles']:.1f} cycles (the analytical model's); "
          f"wall {wall_ms:.1f} ms (first call, with the mapping, "
          f"{first_ms:.1f}), traced wall {prof['wall_ms']:.1f} ms, device "
          f"busy {prof['device_busy_ms']:.3f} ms, idle share "
          f"{prof['idle_share']:.3f}; max |err| against float64 "
          f"{gap['max_abs_err']:.3g}")
    for k in prof["top"]:
        print(f"    {k['ms']:9.3f} ms {k['count']:6d} x {k['name']}")
    check(gap["ok"], f"conv2 on the simulator off float64: {gap}")
    check(dec.backend == "simulator" and sum(redas_gemm.launches.values()) == 0,
          "conv2 did not run on the simulator")
    out["conv2"] = {"decision": {"dataflow": dec.dataflow,
                                 "shape": (meta["shape_rows"],
                                           meta["shape_cols"]),
                                 "tile": (dec.bm, dec.bk, dec.bn),
                                 "modeled_cycles": meta["cycles"]},
                    "wall_ms": wall_ms, "first_call_ms": first_ms,
                    "traced_wall_ms": prof["wall_ms"],
                    "device_busy_ms": prof["device_busy_ms"],
                    "idle_share": prof["idle_share"],
                    "top_kernels": prof["top"], **gap}
    del ad, bd, got
    # (e) qwen2 SMOKE forward with every engine GEMM on the simulator
    cfg = get_config(ARCH, smoke=True)
    params = T.init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(SEED), device="cuda")
    tokens = torch.randint(0, cfg.vocab, (2, 16), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(SEED + 1))
    redas_gemm.reset_launches()
    t0 = time.perf_counter()
    with torch.inference_mode(), use_engine(Engine(AnalyticalCostModel())) as sim:
        got, _ = T.forward(params, cfg, tokens, compute_dtype=torch.float32)
    torch.cuda.synchronize()
    sim_s = time.perf_counter() - t0
    check(sum(redas_gemm.launches.values()) == 0,
          "the simulator forward launched the GEMM kernel")
    with torch.inference_mode(), use_engine(backend="torch-ref"):
        want, _ = T.forward(params, cfg, tokens, compute_dtype=torch.float32)
    gap = _close(got, want, ASIC_TOL)
    calls = sim.plan.hits + sim.plan.misses
    backends = {d.backend for _, d in sim.plan}
    print(f"{ARCH} SMOKE forward f32 (2 x 16 tokens) on the card, {calls} "
          f"engine GEMMs over {len(sim.plan)} decisions all on "
          f"{sorted(backends)}, in {sim_s:.2f} s: logits max |diff| against "
          f"torch-ref {gap['max_abs_err']:.3g} (rtol/atol {ASIC_TOL})")
    check(gap["ok"] and backends == {"simulator"} and calls == 7 * cfg.n_layers,
          f"the simulator forward: {gap}, {calls} calls on {backends}")
    out["smoke_forward"] = {"engine_calls": calls, "seconds": sim_s, **gap}


#: phase 39's trace, 8 requests over 8 slots on pages of 16
WARM_TRACE = "256x16*8"


def _first_tick_serve(params, cfg, scfg, trace, engine=None) -> dict:
    """Serve `trace` through a Scheduler tick by tick: the host ms of its
    first tick (the admit prefill and, on a cold engine, its planning),
    the serve's seconds, and its tokens per uid."""
    sched = Scheduler(params, cfg, scfg, engine=engine, prefill_bucket=BUCKET)
    for r in launch_serve.trace_requests(cfg, trace, SEED):
        sched.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sched.step()
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    ticks = 1
    while sched.queue or sched.n_active:
        sched.step()
        ticks += 1
        check(ticks < 10_000, "the Scheduler did not drain")
    torch.cuda.synchronize()
    return {"sched": sched, "first_tick_ms": first_ms, "ticks": ticks,
            "seconds": time.perf_counter() - t0,
            "tokens": {u: c.tokens.tolist()
                       for u, c in sched.completions.items()}}


def phase_warm_start(cfg) -> None:
    """qwen2-1.5b at full width, bf16 and under --quantize: `plan_arch`
    for the paged Scheduler posture of WARM_TRACE, saved and loaded
    through `ServeConfig(plan_path=)`; the warm serve plans nothing and
    gives the cold serve's tokens per uid.  An AnalyticalCostModel plan
    loaded into a hopper engine is refused."""
    params = seeded_params(cfg)
    trace = launch_serve.parse_trace(WARM_TRACE)
    max_seq = max(p + g for p, g in trace) + 1
    widths = tuple(sorted({min(-(-n // BUCKET) * BUCKET, max_seq)
                           for n in range(1, max_seq + 1)}))
    out_dir = ROOT / "runs"
    out_dir.mkdir(exist_ok=True)
    out = REPORT["warm_start"] = {}
    for label, quant in (("bf16", False), ("--quantize", True)):
        kw = dict(max_seq=max_seq, batch=SLOTS, compute_dtype=torch.bfloat16,
                  cache_dtype=torch.int8 if quant else torch.bfloat16,
                  kernel_backend="hopper", quantize=quant, device="cuda",
                  cache_layout="paged", page_size=PAGE)
        scfg = serve_lib.ServeConfig(**kw)
        served = quantize_params(params) if quant else params
        t0 = time.perf_counter()
        plan = plan_arch(cfg, backend=scfg.kernel_backend, dtype_bytes=2,
                         decode_batch=SLOTS, admit_widths=widths,
                         quantized_weights=quant,
                         paged_pages=scfg.slot_pages, page_size=PAGE)
        plan_s = time.perf_counter() - t0
        path = out_dir / f"plan_{'int8' if quant else 'bf16'}.json"
        plan.save(path)
        # cold, warm, cold, warm: the first serve also pays the card's and
        # the allocator's first-use costs, which the second pair does not
        wscfg = serve_lib.ServeConfig(**kw, plan_path=str(path))
        serves = []
        for turn in range(4):
            if turn % 2 == 0:
                eng = Engine(backend=scfg.kernel_backend)
                run = _first_tick_serve(served, cfg, scfg, trace, eng)
                check(eng.plan.misses > 0, "the cold serve planned nothing")
            else:
                serve_lib._ENGINES.pop(wscfg, None)   # load the plan anew
                eng = serve_lib.warm_start_engine(wscfg)
                misses = eng.plan.misses
                run = _first_tick_serve(served, cfg, wscfg, trace)
                run["new_misses"] = eng.plan.misses - misses
                check(run["sched"].engine is eng,
                      "the warm serve did not take the warm-start engine")
            serves.append(run)
        cold, warm = serves[0], serves[1]
        new = max(r["new_misses"] for r in serves[1::2])
        same = all(r["tokens"] == cold["tokens"] for r in serves)
        first = [r["first_tick_ms"] for r in serves]
        print(f"{ARCH} {label} paged warm start ({WARM_TRACE}, {SLOTS} slots, "
              f"pages of {PAGE}): plan_arch {len(plan)} decisions in "
              f"{plan_s:.3f} s on the host; warm serves {new} new misses "
              f"({warm['sched'].engine.plan.hits} hits), tokens "
              f"{'identical' if same else 'DIFFERENT'} per uid to the cold "
              f"serves; first tick, in turns cold, warm, cold, warm: "
              + ", ".join(f"{ms:.2f}" for ms in first) + " ms; serve "
              + ", ".join(f"{r['seconds']:.3f}" for r in serves)
              + f" s ({warm['ticks']} ticks)")
        check(new == 0 and same,
              f"{label} warm start: {new} new misses, tokens same {same}")
        out[label] = {"plan_decisions": len(plan), "plan_host_s": plan_s,
                      "new_misses": new, "tokens_identical": same,
                      "first_tick_ms_cold_warm_cold_warm": first,
                      "serve_s_cold_warm_cold_warm": [r["seconds"]
                                                      for r in serves],
                      "ticks": warm["ticks"]}
        del served, serves, cold, warm
        torch.cuda.empty_cache()
    # the ASIC guard: a plan of the paper's mapper on a hopper engine
    t0 = time.perf_counter()
    asic = plan_arch(cfg, cost_model=AnalyticalCostModel(), dtype_bytes=2,
                     decode_batch=SLOTS, admit_widths=widths)
    asic_s = time.perf_counter() - t0
    path = out_dir / "plan_asic.json"
    asic.save(path)
    req, _ = next(iter(asic))
    try:
        Engine(backend="hopper", plan=ExecutionPlan.load(path)).decide(req)
        refused = ""
    except ValueError as e:
        refused = str(e)
    print(f"{ARCH} AnalyticalCostModel plan ({len(asic)} decisions in "
          f"{asic_s:.3f} s) loaded into a hopper engine: "
          f"{refused or 'NOT refused'}")
    check("ASIC cost model" in refused and "re-plan" in refused,
          "an ASIC plan ran on the hopper backend")
    out["asic_refusal"] = refused


# --------------------------------------------------------------------------
# Training: the kernels' VJPs, the train launcher, the train step's
# postures, SMOKE card against CPU (phases 40-43)
# --------------------------------------------------------------------------

#: the train launcher's full-width run: qwen2-1.5b, 8 x 512 tokens a step
#: in 2 microbatches, 6 steps with a checkpoint every 3, then 2 more
#: resumed from the newest checkpoint
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO = 8, 512, 2
TRAIN_ARGS = ["--arch", ARCH, "--kernel-backend", "hopper", "--batch",
              str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--microbatches",
              str(TRAIN_MICRO), "--seed", str(SEED), "--log-every", "1"]
#: tokens a microbatch: the M of every engine GEMM in the step
TRAIN_M = TRAIN_BATCH // TRAIN_MICRO * TRAIN_SEQ
#: granite's sorted dispatch at one microbatch of 4 x 512 tokens: C =
#: 4 x capacity(512) rows an expert
GRANITE_TRAIN_C = 4 * 160
#: the flash scan's VJP shape (B, S, H, KV, D) and chunk: qwen2's heads
#: over 2048 keys, 4 chunks
FLASH_VJP_SHAPE, FLASH_VJP_CHUNK = (2, 2048, 12, 2, 128), 512


def _grad_gap(got, ref) -> float:
    return ((got.float() - ref.float()).norm() / ref.float().norm()
            .clamp_min(1e-30)).item()


def _vjp_rows(label, run, plain, inputs, g, tol, fwd, bwd) -> dict:
    """Cotangents of `run` (a port op, through its Function) against
    autograd of `plain` on the same CUDA operands: each within `tol`
    rel-L2 per output row.  `run`'s forward and backward must make
    exactly the launches `fwd` and `bwd` name by route (`_counts`' keys,
    any other 0): a backward on the plain version, or on another route,
    fails."""
    grads, launches = [], {}
    for fn in (run, plain):
        ts = [t.detach().clone().requires_grad_() for t in inputs]
        before = _counts()
        y = fn(*ts)
        mid = _counts()
        grads.append(torch.autograd.grad(y, ts, grad_outputs=g))
        if fn is run:
            launches = {"forward": {k: mid[k] - before[k] for k in mid},
                        "backward": _delta(mid)}
    torch.cuda.synchronize()
    errs = [row_rel_l2(a, b) for a, b in zip(*grads)]
    print(f"  {label}: cotangents' row rel-L2 "
          + ", ".join(f"{e:.2e}" for e in errs) + f" (limit {tol:.0e}); "
          f"launches {_nonzero(launches['forward'])} forward, "
          f"{_nonzero(launches['backward'])} backward")
    check(all(e <= tol for e in errs), f"{label}: cotangent rows {errs}")
    for part, want in (("forward", fwd), ("backward", bwd)):
        want = {k: want.get(k, 0) for k in launches[part]}
        check(launches[part] == want, f"{label}: {part} launches "
              f"{_nonzero(launches[part])}, expected {_nonzero(want)}")
    return {"row_rel_l2": errs, "launches": launches}


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def _os_launches(n: int, dtype) -> dict:
    """`n` launches of row 1's OS kernel, on the wgmma route in bf16 (the
    sync route takes f32: `redas_gemm.shape_route`)."""
    return {"gemm_os": n,
            "gemm_os_wgmma": n if dtype == torch.bfloat16 else 0}


def _counts() -> dict:
    return {"gemm_os": redas_gemm.launches["os"],
            "gemm_os_wgmma": redas_gemm.os_wgmma_launches,
            "gemm_ws_is": redas_gemm.launches["ws"] + redas_gemm.launches["is"],
            "grouped": grouped_gemm.launches,
            "grouped_wgmma": grouped_gemm.wgmma_launches,
            "int8_decode": quant_gemm.path_launches["decode"],
            "int8_tiled": quant_gemm.path_launches["tiled"],
            "sparse": sparse_gemm.launches,
            "sparse_int8": sparse_gemm.int8_launches}


def _delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in _counts().items()}


def phase_vjps() -> dict:
    """Phase 40: each VJP Function on the kernel backends against autograd
    of the plain version at the model's shapes, with the backward's
    launches by route from the wrappers' counters."""
    from repro_torch.engine.backends import DiffGemm
    from repro_torch.models import layers

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rnd = lambda *s, dtype=torch.bfloat16: torch.randn(
        *s, device="cuda", generator=gen, dtype=dtype)
    plain = lambda dtype: (lambda a, b: (a.float() @ b.float()).to(dtype))
    out = {"gemm": {}}
    eng = Engine(backend="hopper")
    for dtype, tol, shapes in ((torch.bfloat16, BF16_ROW_TOL, LAYER_GEMMS),
                               (torch.float32, F32_ROW_TOL,
                                [(1536, 256), (8960, 1536)])):
        for k, n in shapes:
            a, b, g = (rnd(*s, dtype=dtype) for s in
                       ((TRAIN_M, k), (k, n), (TRAIN_M, n)))
            y = eng.matmul(a.requires_grad_(), b)
            check(type(y.grad_fn) is DiffGemm._backward_cls,
                  "the engine GEMM's output has no DiffGemm grad_fn")
            size = a.element_size()
            dec = eng.decide(KernelRequest("gemm", TRAIN_M, k, n,
                                           in_bytes=size, out_bytes=size))
            fwd = (_os_launches(1, dtype) if dec.dataflow == "os"
                   else {"gemm_ws_is": 1})
            key = f"{TRAIN_M}x{k}x{n} {str(dtype)[6:]}"
            out["gemm"][key] = _vjp_rows(
                f"row 1 DiffGemm {key}", eng.matmul, plain(dtype), (a, b), g,
                tol, fwd, _os_launches(2, dtype))
    x, w, g = (rnd(*s) for s in ((32, GRANITE_TRAIN_C, 1024), (32, 1024, 512),
                                 (32, GRANITE_TRAIN_C, 512)))
    out["grouped"] = _vjp_rows(
        f"row 5 DiffGrouped (32, {GRANITE_TRAIN_C}, 1024) @ (32, 1024, 512)",
        eng.grouped_matmul, plain(torch.bfloat16), (x, w), g, BF16_ROW_TOL,
        {"grouped": 1, "grouped_wgmma": 1},
        {"grouped": 2, "grouped_wgmma": 2})
    a, b, g = (rnd(*s) for s in ((TRAIN_M, 1536), (1536, 8960),
                                 (TRAIN_M, 8960)))
    ek, ep = Engine(backend="hopper-int8"), Engine(backend="torch-ref-int8")
    bf16 = torch.bfloat16
    out["int8"] = _vjp_rows(
        "row 6 int8 GEMM via DiffGemm (float backward on row 1)", ek.matmul,
        ep.matmul, (a, b), g, BF16_ROW_TOL, {"int8_tiled": 1},
        _os_launches(2, bf16))
    qt = quantize(b)
    out["int8_w8"] = _vjp_rows(
        "row 6 DiffQuantGemmW8", lambda x: ek.quant_matmul(x, qt.q, qt.scale),
        lambda x: ep.quant_matmul(x, qt.q, qt.scale), (a,), g, BF16_ROW_TOL,
        {"int8_tiled": 1}, _os_launches(1, bf16))
    sk, sp = Engine(backend="hopper-sparse"), Engine(backend="torch-ref-sparse")
    st = sparsify(b, 2, 4)
    kept = sparse_gemm.scatter_dense(torch.ones_like(st.values), st.indices,
                                     2, 4) != 0

    def on(eng):
        return lambda x, v: eng.sparse_matmul(
            x, SparseTensor(v, st.indices, n=2, m=4, k_dense=st.k_dense))

    out["sparse"] = _vjp_rows("row 7 DiffSparseGemm", on(sk), on(sp),
                              (a, st.values), g, BF16_ROW_TOL, {"sparse": 1},
                              _os_launches(2, bf16))
    # the values' cotangent scattered to dense: zero where pruned
    ts = [a.detach().requires_grad_(), st.values.detach().requires_grad_()]
    dv = torch.autograd.grad(on(sk)(*ts), ts, grad_outputs=g)[1]
    dense = sparse_gemm.scatter_dense(dv.float(), st.indices, 2, 4)
    check(bool((dense[~kept] == 0).all()), "row 7: a pruned position of dV "
          "is nonzero")
    sq = sparsify(b, 2, 4, quantize=True)
    out["sparse_int8"] = _vjp_rows(
        "row 7 DiffSparseGemmQ", lambda x: sk.sparse_matmul(x, sq),
        lambda x: sp.sparse_matmul(x, sq), (a,), g, BF16_ROW_TOL,
        {"sparse_int8": 1}, _os_launches(1, bf16))
    b_, s_, h, kv, d = FLASH_VJP_SHAPE
    q, k, v, do = (rnd(b_, s_, n_, d, dtype=torch.float32)
                   for n_ in (h, kv, kv, h))
    pos = torch.arange(s_, device="cuda", dtype=torch.int32).expand(b_, s_)
    kv_len = torch.tensor([s_, s_ - 301], device="cuda", dtype=torch.int32)
    res = {}
    for name, fn in (("FlashScan", layers.flash_attention),
                     ("autograd of the plain loop", layers._flash_scan)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ts = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        o = fn(*ts, pos, kv_len, True, 0, FLASH_VJP_CHUNK)
        res[name] = torch.autograd.grad(o, ts, grad_outputs=do)
        torch.cuda.synchronize()
        res[name + " peak"] = (torch.cuda.max_memory_allocated() - base) / 2**20
        del o, ts
    gaps = [(x - y).abs().max().item() / max(y.abs().max().item(), 1e-30)
            for x, y in zip(res["FlashScan"], res["autograd of the plain loop"])]
    print(f"  the flash scan's VJP {FLASH_VJP_SHAPE} chunk {FLASH_VJP_CHUNK} "
          f"f32: dq, dk, dv max|diff|/max|ref| "
          + ", ".join(f"{x:.2e}" for x in gaps)
          + f" (limit 1e-5); peak MiB above the inputs: FlashScan "
          f"{res['FlashScan peak']:.1f}, the plain loop under autograd "
          f"{res['autograd of the plain loop peak']:.1f}")
    check(all(x <= 1e-5 for x in gaps), f"the flash scan's VJP: {gaps}")
    out["flash"] = {"max_rel": gaps,
                    "peak_mib": res["FlashScan peak"],
                    "plain_peak_mib": res["autograd of the plain loop peak"]}
    REPORT["vjps"] = out
    return out


def _micro_batch(cfg, step: int, rows: int) -> tuple[dict, torch.Tensor]:
    """The first `rows` rows of the launcher's batch `step` on the card,
    split into (inputs, labels)."""
    batch = make_source(cfg, DataConfig(TRAIN_BATCH, TRAIN_SEQ, SEED)).batch(step)
    inputs, labels = train_lib._split_batch(
        train_lib.device_batch(batch, "cuda"), cfg)
    return {k: v[:rows] for k, v in inputs.items()}, labels[:rows]


def _grads(params, cfg, backend: str, dtype, inputs, labels):
    """(loss, {key path: gradient}) of one microbatch through the train
    step's loss (`make_loss_fn`) on `backend` in `dtype`, the params cast
    to it."""
    tcfg = train_lib.TrainConfig(compute_dtype=dtype, kernel_backend=backend)
    paths, leaves = zip(*flatten_with_path(params))
    live = [t.detach().to(dtype).requires_grad_() for t in leaves]
    eng = Engine(backend=backend)
    with use_engine(eng):
        loss, _ = train_lib.make_loss_fn(cfg, tcfg)(
            tree_unflatten(params, live), inputs, labels)
        grads = torch.autograd.grad(loss, live)
    torch.cuda.synchronize()
    return loss.item(), dict(zip(paths, grads)), eng


def anchor_rule(label: str, params, cfg, kernel: str, plain: str,
                inputs, labels) -> dict:
    """One microbatch's gradients on the kernel backend in bf16, on the
    plain backend in bf16 and on the plain backend in f32 (f32 weights):
    the kernels' bf16 gradients no farther from the f32 ones (rel-L2 over
    every leaf) than F32_ANCHOR_LIMIT x the plain versions' bf16 ones.
    Prints the loss gaps and the leaf with the largest ratio."""
    before = _counts()
    loss_k, g_k, eng = _grads(params, cfg, kernel, torch.bfloat16, inputs,
                              labels)
    launches = _delta(before)
    calls = eng.plan.hits + eng.plan.misses
    loss_p, g_p, _ = _grads(params, cfg, plain, torch.bfloat16, inputs,
                            labels)
    loss_f, g_f, _ = _grads(params, cfg, plain, torch.float32, inputs,
                            labels)
    num_k = num_p = den = 0.0
    worst = (0.0, "")
    for key, ref in g_f.items():
        dk = (g_k[key].float() - ref).square().sum().item()
        dp = (g_p[key].float() - ref).square().sum().item()
        num_k, num_p, den = num_k + dk, num_p + dp, den + ref.square().sum().item()
        worst = max(worst, (math.sqrt(dk / max(dp, 1e-30)), key))
    del g_k, g_p, g_f
    gap_k, gap_p = math.sqrt(num_k / den), math.sqrt(num_p / den)
    ratio = gap_k / gap_p
    print(f"{label}: one microbatch's gradients against the f32 model's: "
          f"{kernel} bf16 rel-L2 {gap_k:.4e}, {plain} bf16 {gap_p:.4e}: ratio "
          f"{ratio:.3f} (limit {F32_ANCHOR_LIMIT}); the largest leaf ratio "
          f"{worst[0]:.3f} at {worst[1]}; loss {loss_k:.5f} ({kernel}), "
          f"{loss_p:.5f} ({plain} bf16), {loss_f:.5f} (f32); engine calls "
          f"{calls}, launches {launches}")
    check(ratio <= F32_ANCHOR_LIMIT and math.isfinite(loss_k),
          f"{label}: the kernels' gradients are {ratio:.3f}x as far from the "
          f"f32 model's as the plain versions'")
    return {"rel_l2_kernel": gap_k, "rel_l2_plain": gap_p, "ratio": ratio,
            "worst_leaf": {"ratio": worst[0], "key": worst[1]},
            "loss": {"kernel": loss_k, "plain_bf16": loss_p, "f32": loss_f},
            "engine_calls": calls, "launches": launches}


def _check_step_launches(label: str, launches: dict, calls: int,
                         grouped: int = 0) -> None:
    """A training run's launches: each engine GEMM call (forward and
    recompute) one launch, its backward two more on row 1's OS wgmma
    kernel: every GEMM launch on the hand-written kernels, 2 x the engine
    calls in all (`grouped` of the calls being grouped ones), no OS call
    on the sync kernel."""
    gemm = launches["gemm_os"] + launches["gemm_ws_is"]
    print(f"{label}: {calls} engine calls (forward and recompute); GEMM "
          f"launches {gemm} ({launches['gemm_os']} OS, "
          f"{launches['gemm_os_wgmma']} of them on wgmma, "
          f"{launches['gemm_ws_is']} WS/IS), grouped {launches['grouped']} "
          f"({launches['grouped_wgmma']} on wgmma)")
    check(gemm + launches["grouped"] == 2 * calls
          and launches["grouped"] == 2 * grouped
          and launches["gemm_os"] == launches["gemm_os_wgmma"]
          and launches["grouped"] == launches["grouped_wgmma"],
          f"{label}: launches {launches} for {calls} engine calls "
          f"({grouped} grouped)")


def _launcher_run(label: str, argv: list, cfg) -> dict:
    """One run of the train launcher: its output, with its ms a step,
    tokens/s, peak memory and launches by route, each engine GEMM's
    launches checked (`_check_step_launches`)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = _counts()
    t0 = time.perf_counter()
    out = launch_train.main(argv)
    wall = time.perf_counter() - t0
    launches = _delta(before)
    eng = out["engine"]
    calls = eng.plan.hits + eng.plan.misses
    ran = out["steps"] - out["start"]
    check(all(math.isfinite(x) for x in out["ce"] + out["grad_norm"]),
          f"{label}: non-finite ce or grad_norm")
    layer_calls = sum(LAYER_GEMMS.values()) * cfg.n_layers
    check(calls == 2 * TRAIN_MICRO * layer_calls * ran,
          f"{label}: {calls} engine calls, want "
          f"{2 * TRAIN_MICRO * layer_calls * ran}")
    _check_step_launches(label, launches, calls)
    step_ms = [1e3 * x for x in out["step_seconds"]]
    steady = statistics.median(step_ms[1:]) if len(step_ms) > 1 else step_ms[0]
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"{label}: steps {out['start']}..{out['steps'] - 1}, ce "
          + ", ".join(f"{x:.4f}" for x in out["ce"]) + "; grad_norm "
          + ", ".join(f"{x:.3f}" for x in out["grad_norm"])
          + "; ms a step " + ", ".join(f"{x:.1f}" for x in step_ms)
          + f" (median after the first {steady:.1f}: "
          f"{TRAIN_BATCH * TRAIN_SEQ / steady * 1e3:.0f} tokens/s); peak "
          f"{peak:.2f} GiB; wall {wall:.1f} s [{card_line()}]")
    out["report"] = {"ce": out["ce"], "grad_norm": out["grad_norm"],
                     "step_ms": step_ms, "median_step_ms": steady,
                     "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / steady * 1e3,
                     "peak_gib": peak, "wall_s": wall, "engine_calls": calls,
                     "launches": launches, "start": out["start"]}
    return out


#: the checkpoint restart's depth: qwen2-1.5b's widths over 4 of its 28
#: layers.  A full-depth checkpoint is 28.4 GB (the bf16 params written
#: as f32, the f32 moments and master) and the restart writes three, 85
#: GB in all; at this depth they are some 10.5 GB each, 31.4 GB in all,
#: written under runs/ in the checkout
RESTART_LAYERS = 4


@contextlib.contextmanager
def _launcher_depth(layers: int):
    """The train launcher's configurations cut to `layers` layers."""
    real = launch_train.get_config
    launch_train.get_config = lambda name, smoke=False: dataclasses.replace(
        real(name, smoke), n_layers=layers)
    try:
        yield
    finally:
        launch_train.get_config = real


def phase_train_qwen(cfg) -> dict:
    """Phase 41: qwen2-1.5b at full width and depth through the train
    launcher, 8 steps (ms a step, tokens/s, peak, launches by route), a
    traced step and the gradients' f32 anchor rule; then the launcher's
    checkpoint restart at RESTART_LAYERS layers: 6 steps with a
    checkpoint every 3, `--resume auto` to 8 from step 6, its steps 6-7
    against an uninterrupted run's."""
    report = {}
    out = _launcher_run("qwen2-1.5b training, 28 layers",
                        TRAIN_ARGS + ["--steps", "8"], cfg)
    report["full"] = out["report"]
    state, step_fn = out["state"], out["train_step"]
    del out
    batch = train_lib.device_batch(
        make_source(cfg, DataConfig(TRAIN_BATCH, TRAIN_SEQ, SEED)).batch(8),
        "cuda")
    before = _counts()
    prof = _profile(lambda: step_fn(state, batch)[1]["ce"].item(),
                    GEMM_KERNELS)
    counted = _delta(before)
    seen = prof["matched"][WGMMA_KERNEL]["count"]
    sync = prof["matched"]["::os_kernel<"]["count"]
    print(f"qwen2-1.5b traced step: wall {prof['wall_ms']:.1f} ms, device "
          f"busy {prof['device_busy_ms']:.1f} ms, idle share "
          f"{prof['idle_share']:.3f}; {counted['gemm_os_wgmma']} wgmma OS "
          f"GEMMs counted, {seen} traced, {sync} os_kernel traced "
          f"[{card_line()}]")
    for k in prof["top"]:
        print(f"    {k['ms']:9.3f} ms {k['count']:5d} x {k['name']}")
    check(counted["gemm_os"] == counted["gemm_os_wgmma"] > 0
          and traced_within(seen, counted["gemm_os_wgmma"]) and sync == 0,
          f"the traced step: {counted} counted, {seen} wgmma and {sync} sync "
          f"traced")
    report["trace"] = {k: prof[k] for k in ("wall_ms", "device_busy_ms",
                                            "idle_share", "top", "matched")}
    params = state["params"]
    del state, step_fn
    torch.cuda.empty_cache()
    inputs, labels = _micro_batch(cfg, 8, TRAIN_BATCH // TRAIN_MICRO)
    report["anchor"] = anchor_rule("qwen2-1.5b", params, cfg, "hopper",
                                   "torch-ref", inputs, labels)
    check(report["anchor"]["engine_calls"]
          == 2 * sum(LAYER_GEMMS.values()) * cfg.n_layers,
          "the gradient run's recompute did not take the engine")
    del params
    torch.cuda.empty_cache()
    runs = ROOT / "runs"
    runs.mkdir(exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="train_ckpt_", dir=runs)
    try:
        report["restart"] = _train_restart(cfg, ckpt_dir)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    REPORT["train_qwen"] = report
    return report


def _train_restart(cfg, ckpt_dir: str) -> dict:
    cut = dataclasses.replace(cfg, n_layers=RESTART_LAYERS)
    label = f"qwen2-1.5b x {RESTART_LAYERS} layers"
    report = {}
    with _launcher_depth(RESTART_LAYERS):
        for name, argv in (
                ("first run", ["--steps", "6", "--ckpt-dir", ckpt_dir,
                               "--ckpt-every", "3"]),
                ("resumed run", ["--steps", "8", "--ckpt-dir", ckpt_dir,
                                 "--resume", "auto"]),
                ("uninterrupted run", ["--steps", "8"])):
            out = _launcher_run(f"{label}, {name}", TRAIN_ARGS + argv, cut)
            report[name] = out["report"]
            if name == "first run":
                sizes = {s_: os.path.getsize(os.path.join(
                    ckpt_dir, f"step_{s_:09d}.npz")) / 1e9
                    for s_ in Checkpointer(ckpt_dir).all_steps()}
                print("  checkpoints written: " + ", ".join(
                    f"step {s_} {gb:.2f} GB" for s_, gb in sizes.items()))
                check(sorted(sizes) == [3, 6], f"checkpoints {sorted(sizes)}")
                report["checkpoint_gb"] = sizes
            del out
            torch.cuda.empty_cache()
    resumed, straight = report["resumed run"], report["uninterrupted run"]
    check(resumed["start"] == 6, f"the resume started at {resumed['start']}")
    pairs = list(zip(resumed["ce"] + resumed["grad_norm"],
                     straight["ce"][6:] + straight["grad_norm"][6:]))
    gap = max(abs(a - b) / abs(b) for a, b in pairs)
    print(f"{label}: steps 6-7 resumed from step 6's checkpoint against the "
          f"uninterrupted run: ce and grad_norm within {gap:.2e} (limit 1e-5)")
    check(gap <= 1e-5, f"the resumed steps differ: {pairs}")
    report["resume_gap"] = gap
    return report


def _posture_step(label: str, cfg, state, tcfg, batch) -> dict:
    """One train step of a posture from `state`: its ms, ce, grad_norm and
    launches by route."""
    step = train_lib.make_train_step(cfg, tcfg)
    torch.cuda.synchronize()
    before = _counts()
    t0 = time.perf_counter()
    _, metrics = step(state, batch)
    ce, gn = float(metrics["ce"]), float(metrics["grad_norm"])
    ms = (time.perf_counter() - t0) * 1e3
    launches = _delta(before)
    calls = step.engine.plan.hits + step.engine.plan.misses
    print(f"{label}: one step {ms:.1f} ms (its first: planning and set-up "
          f"included), ce {ce:.4f}, grad_norm {gn:.3f}; {calls} engine "
          f"calls; launches {launches}")
    check(math.isfinite(ce) and math.isfinite(gn), f"{label}: non-finite")
    return {"ms": ms, "ce": ce, "grad_norm": gn, "engine_calls": calls,
            "launches": launches}


def phase_train_postures(cfg) -> dict:
    """Phase 42: one step each of granite-moe-1b-a400m with the sorted
    dispatch (its experts on row 5's Function), qwen2-1.5b under
    `quantize=True` (int8 forward on row 6, float backward on row 1) and
    under `sparsity="2:4"` (dense weights on the sparse namespace), each
    with the gradients' f32 anchor rule."""
    report = {}
    gcfg = _sorted(get_config(GRANITE))
    tcfg = train_lib.TrainConfig(microbatches=TRAIN_MICRO,
                                 kernel_backend="hopper")
    state = train_lib.init_state(gcfg, tcfg, generator=torch.Generator(
        device="cuda").manual_seed(SEED), device="cuda")
    batch = train_lib.device_batch(make_source(
        gcfg, DataConfig(TRAIN_BATCH, TRAIN_SEQ, SEED)).batch(0), "cuda")
    run = _posture_step("granite sorted", gcfg, state, tcfg, batch)
    grouped = 3 * gcfg.n_layers * 2 * TRAIN_MICRO      # forward + recompute
    _check_step_launches("granite sorted step", run["launches"],
                         run["engine_calls"], grouped)
    params = state["params"]
    del state
    torch.cuda.empty_cache()
    inputs, labels = _micro_batch(gcfg, 0, TRAIN_BATCH // TRAIN_MICRO)
    run["anchor"] = anchor_rule("granite sorted", params, gcfg, "hopper",
                                "torch-ref", inputs, labels)
    report[GRANITE] = run
    del params
    torch.cuda.empty_cache()

    state = train_lib.init_state(cfg, tcfg, generator=torch.Generator(
        device="cuda").manual_seed(SEED), device="cuda")
    batch = train_lib.device_batch(make_source(
        cfg, DataConfig(TRAIN_BATCH, TRAIN_SEQ, SEED)).batch(0), "cuda")
    inputs, labels = _micro_batch(cfg, 0, TRAIN_BATCH // TRAIN_MICRO)
    layer_calls = sum(LAYER_GEMMS.values()) * cfg.n_layers
    for name, kw, kernel, plain in (
            ("quantize", {"quantize": True}, "hopper-int8", "torch-ref-int8"),
            ("sparsity 2:4", {"sparsity": "2:4"}, "hopper-sparse",
             "torch-ref-sparse")):
        ptcfg = train_lib.TrainConfig(microbatches=TRAIN_MICRO,
                                      kernel_backend="hopper", **kw)
        check(ptcfg.kernel_backend == kernel, f"{name}: {ptcfg}")
        run = _posture_step(f"qwen2-1.5b {name}", cfg, state, ptcfg, batch)
        n = run["launches"]
        if name == "quantize":
            # the int8 forward and recompute on row 6 (tiled at M = 2048),
            # the float backward two OS launches a call on row 1
            check(n["int8_tiled"] == run["engine_calls"]
                  and n["int8_decode"] == 0
                  and n["gemm_os"] == n["gemm_os_wgmma"]
                  == run["engine_calls"] and n["gemm_ws_is"] == 0,
                  f"{name}: launches {n}")
        else:
            _check_step_launches(f"qwen2-1.5b {name} step", n,
                                 run["engine_calls"])
            check(n["sparse"] == n["sparse_int8"] == 0,
                  f"{name}: dense weights ran on the sparse kernel")
        check(run["engine_calls"] == 2 * TRAIN_MICRO * layer_calls,
              f"{name}: {run['engine_calls']} engine calls")
        run["anchor"] = anchor_rule(f"qwen2-1.5b {name}", state["params"],
                                    cfg, kernel, plain, inputs, labels)
        report[name] = run
        torch.cuda.empty_cache()
    del state
    torch.cuda.empty_cache()
    REPORT["train_postures"] = report
    return report


def phase_train_smoke() -> dict:
    """Phase 43: one SMOKE f32 step of every arch on "hopper", card against
    the same step on CPU tensors (the params after it within rtol/atol
    2e-4), and the reference's `test_loss_decreases` setting on the card:
    20 steps at lr 1e-2, ce falling by more than 0.3."""
    report = {}
    for arch in ARCH_NAMES:
        cfg = get_config(arch, smoke=True)
        tcfg = train_lib.TrainConfig(compute_dtype=torch.float32,
                                     kernel_backend="hopper")
        batch = make_source(cfg, DataConfig(2, 32)).batch(0)
        new = {}
        for dev in ("cpu", "cuda"):
            state = _to(train_lib.init_state(
                cfg, tcfg, generator=torch.Generator().manual_seed(SEED)), dev)
            new[dev], _ = train_lib.make_train_step(cfg, tcfg)(
                state, train_lib.device_batch(batch, dev))
        worst = 0.0
        for (key, got), (_, want) in zip(flatten_with_path(new["cuda"]),
                                         flatten_with_path(new["cpu"])):
            gap = ((got.cpu().float() - want.float()).abs()
                   - 2e-4 * want.float().abs()).max().item()
            worst = max(worst, gap)
        print(f"  {arch} SMOKE step, card against CPU: max(|diff| - 2e-4 "
              f"|cpu|) = {worst:.2e} (limit 2e-4)")
        check(worst <= 2e-4, f"{arch}: the card's step differs from the CPU's")
        report[arch] = worst
    cfg = get_config(ARCH, smoke=True)
    tcfg = train_lib.TrainConfig(
        microbatches=2, compute_dtype=torch.float32, kernel_backend="hopper",
        optimizer=AdamWConfig(lr=linear_warmup_cosine(1e-2, 5, 100)))
    state = train_lib.init_state(cfg, tcfg, generator=torch.Generator(
        device="cuda").manual_seed(SEED), device="cuda")
    step = train_lib.make_train_step(cfg, tcfg)
    src = make_source(cfg, DataConfig(8, 32))
    ces = []
    for s in range(20):
        state, m = step(state, train_lib.device_batch(src.batch(s), "cuda"))
        ces.append(float(m["ce"]))
    print(f"  qwen2-1.5b SMOKE, 20 steps at lr 1e-2 on the card: ce "
          f"{ces[0]:.4f} -> {ces[-1]:.4f}")
    check(ces[-1] < ces[0] - 0.3, f"the loss did not fall: {ces}")
    report["loss_decreases"] = ces
    REPORT["train_smoke"] = report
    return report


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def gemm_lines(rows: list[dict], static: dict, paged: dict,
               granite: dict) -> list[dict]:
    """The static serve's GEMM work at the engine's decisions, each
    shape's time weighted by the calls that serve makes: OS on the wgmma
    kernel (kernel row 1), the same OS calls on the kept sync kernel
    (timed in phase 2 on operands at a misaligned base; no served path
    launches it), WS/IS (row 2) and the streaming reduction (its time
    alone at each decision with more than one slab), each with the plain
    version, torch.matmul (torch.sum for the reduction) and the bound
    over the same calls; launches from the static serve, the paged
    serve's and granite's sorted serve's beside them."""
    cfg = get_config(ARCH)
    keys = ("ms", "plain_ms", "library_ms", "bound_ms")
    parts = {name: dict.fromkeys(keys, 0.0) for name in ("os", "sync",
                                                          "stream", "reduce")}
    ops = collections.Counter()
    bytes_ = collections.Counter()
    errs = collections.defaultdict(list)
    # each kernel's ms and calls at the prefill's M and at decode's
    by_m = collections.defaultdict(lambda: collections.defaultdict(
        lambda: {"ms": 0.0, "calls": 0}))
    for (k, n), per_layer in LAYER_GEMMS.items():
        for m, steps in ((BATCH * PROMPT, 1), (BATCH, GEN - 1)):
            row = next(r for r in rows if r["main_path"]
                       and (r["m"], r["k"], r["n"]) == (m, k, n))
            calls = per_layer * cfg.n_layers * steps
            names = (("os", "sync") if row["dataflow"] == "os"
                     else ("stream",))
            for name in names:
                timed = row if name != "sync" else next(
                    r for r in rows if r["role"] == "sync route"
                    and (r["m"], r["k"], r["n"]) == (m, k, n))
                for key in keys:
                    parts[name][key] += calls * timed[key]
                by_m[name][m]["ms"] += calls * timed["ms"]
                by_m[name][m]["calls"] += calls
                ops[name] += calls * 2.0 * m * k * n / PEAK_FLOPS_BF16
                bytes_[name] += calls * (m * k + k * n + m * n) * 2 / HBM_BW
                errs[name].append(timed["max_abs_err"])
            if "reduce_ms" in row:
                for key in keys:
                    parts["reduce"][key] += calls * row[f"reduce_{key}"]
                by_m["reduce"][m]["ms"] += calls * row["reduce_ms"]
                by_m["reduce"][m]["calls"] += calls
                slabs = row["reduce_parts"]
                ops["reduce"] += calls * (slabs - 1) * m * n / PEAK_FLOPS_F32
                bytes_["reduce"] += calls * (slabs * 4 + 2) * m * n / HBM_BW
                errs["reduce"].append(row["reduce_max_abs_err"])
    by_df, paged_df = static["launches"], paged["launches"]
    wide = {name: REPORT[key] for name, key in (
        ("qwen3_14b_static_serve", f"{QWEN3}_static"),
        ("qwen3_14b_paged_serve", f"{QWEN3}_paged"),
        ("gemma3_12b_static_serve", f"{GEMMA3}_static"),
        ("gemma3_12b_paged_serve", f"{GEMMA3}_paged"),
        ("mistral_large_123b_4_layers_static_serve", f"{MISTRAL}_static"))}
    wide["mixtral_8x7b_4_layers_static_serve"] = REPORT[MIXTRAL]["static"]
    wide["mixtral_8x7b_4_layers_serve"] = REPORT[MIXTRAL]
    for arch in (MAMBA, RGEMMA):
        name = arch.replace("-", "_").replace(".", "_")
        wide[f"{name}_static_serve"] = REPORT[f"{arch}_static"]
        wide[f"{name}_serve"] = REPORT[arch]
    wide["hubert_xlarge_forward"] = REPORT[HUBERT]
    wide["internvl2_1b_static_serve"] = REPORT[f"{INTERNVL}_static"]
    of_wide = {
        "os": lambda r: r["os_wgmma"],
        "sync": lambda r: r["launches"]["os"] - r["os_wgmma"],
        "stream": lambda r: r["launches"]["ws"] + r["launches"]["is"],
        "reduce": lambda r: r["reductions"]}
    common = {"route": "cuda",
              "source": "src/repro_torch/kernels/csrc/redas_gemm.cu"}
    os_site = "src/repro/kernels/redas_gemm.py:169 (OS, _os_kernel :108)"
    lines = []
    for name, kernel, replaces, launches, by_path, what in (
            ("redas_gemm_os", "os_wgmma_kernel", os_site, static["os_wgmma"],
             {"static_serve": static["os_wgmma"],
              "paged_serve": paged["os_wgmma"],
              "granite_sorted_serve": granite["os_wgmma"]}, "OS calls"),
            ("redas_gemm_os_sync", "os_kernel", os_site,
             by_df["os"] - static["os_wgmma"],
             {"static_serve": by_df["os"] - static["os_wgmma"],
              "paged_serve": paged_df["os"] - paged["os_wgmma"],
              "granite_sorted_serve": granite["launches"]["os"]
              - granite["os_wgmma"]},
             "OS calls on the kept sync kernel (f32 and shapes TMA cannot "
             "describe; timed on operands at a misaligned base)"),
            ("redas_gemm_stream", "stream_kernel",
             "src/repro/kernels/redas_gemm.py:206 (WS/IS, _streaming_kernel "
             ":126)", by_df["ws"] + by_df["is"],
             {"static_serve": by_df["ws"] + by_df["is"],
              "paged_serve": paged_df["ws"] + paged_df["is"]},
             "WS and IS calls"),
            ("redas_gemm_reduce", "stream_reduce_kernel",
             "src/repro/kernels/redas_gemm.py:206 (the WS/IS partial sums "
             "carried across K chunks, split into slabs on the card)",
             static["reductions"],
             {"static_serve": static["reductions"],
              "paged_serve": paged["reductions"]}, "reductions")):
        key = name.split("_")[-1]
        calls = by_df["os"] if key == "sync" else launches
        by_path.update({path: of_wide[key](r) for path, r in wide.items()})
        lines.append({
            "name": name, **common, "kernel": kernel, "replaces": replaces,
            "launches": launches, "launches_by_path": by_path,
            "per": f"the static serve's {calls} {what}, summed",
            "ms_by_m": {str(mm): v for mm, v in sorted(by_m[key].items())},
            "max_abs_err": max(errs[key]), "ms": parts[key]["ms"],
            "plain_ms": parts[key]["plain_ms"],
            "bound_ms": parts[key]["bound_ms"],
            "bound_by": ("operations" if ops[key] >= bytes_[key]
                         else "bytes"),
            "library_ms": parts[key]["library_ms"],
            "library": "torch.sum over the slab dimension"
            if key == "reduce" else "torch.matmul"})
    return lines


def attention_lines(attn: dict, paged: dict) -> list[dict]:
    """Per call at each kernel's main-path shape in bf16; launches from
    the paged serve (flash sits behind Engine.attention, off the path).
    The flash line adds its operations-bound shape and its sync route."""
    def timed(kernel, dtype="bfloat16", shape=None):
        return next(r for r in attn["rows"] if r["kernel"] == kernel
                    and r["dtype"] == dtype and "ms" in r
                    and (shape is None or r["shape"] == list(shape)))

    def err(kernel):
        return max(r["max_abs_err"] for r in attn["rows"]
                   if r["kernel"] == kernel)

    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library")
    p, f = timed("paged_attention"), timed("flash_attention")
    ops = timed("flash_attention", shape=FLASH_OPS_SHAPE)
    sub = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "tflops",
           "peak_share")
    return [
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:195",
         "launches": paged["counts"]["paged_attention"],
         "launches_by_path": {
             "paged_serve": paged["counts"]["paged_attention"],
             "granite_sorted_serve":
                 REPORT["granite_sorted"]["counts"]["paged_attention"],
             "qwen3_14b_paged_serve":
                 REPORT[f"{QWEN3}_paged"]["counts"]["paged_attention"],
             "gemma3_12b_paged_serve":
                 REPORT[f"{GEMMA3}_paged"]["counts"]["paged_attention"]},
         "by_shape": {r["arch"]: {k: r[k] for k in (
             "splits", "ms", "plain_ms", "library_ms", "bound_ms",
             "bound_by", "fastest_split", "pick_over_fastest")}
             for r in attn["rows"] if r["kernel"] == "paged_attention"
             and r["dtype"] == "bfloat16"},
         "per": f"call, bf16, {p['shape']}, kv_len {p['kv_len']}",
         "max_abs_err": err("paged_attention"), **{k: p[k] for k in keys}},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "kernel": "flash_wgmma_kernel (bf16 that TMA can describe, "
                   "D <= 256); flash_sync_kernel (the rest)",
         "replaces": "src/repro/kernels/flash_attention.py:97",
         "launches": paged["counts"]["flash_attention"],
         "entry_point_launches": attn["entry"]["launches"],
         "entry_point_wgmma_launches": attn["entry"]["wgmma_launches"],
         "per": f"call, bf16, {list(FLASH_SHAPE)} causal, wgmma route",
         "max_abs_err": err("flash_attention"), **{k: f[k] for k in keys},
         "ops_bound": {"shape": list(FLASH_OPS_SHAPE),
                       **{k: ops[k] for k in sub}},
         "sync_route": {
             name: {k: timed("flash_attention", name)[k] for k in sub}
             for name in ("float32", "bfloat16 at a misaligned base")}}]


def grouped_line(rows: list[dict], granite: dict) -> dict:
    """Per call at the decode shape of wi/wg in bf16 (two of every three
    grouped launches of a decode tick) on the wgmma route; every shape's
    times on both routes beside it; launches from the sorted serve, by
    route."""
    main = next(r for r in rows if r["dtype"] == "bfloat16"
                and r["shape"] == list(GROUPED_SHAPES[0]))
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library")
    shape_keys = ("route", "tile", "ms", "sync_tile", "sync_ms",
                  "sync_misaligned_ms", "library_ms", "bound_ms", "host_us")
    launches = granite["counts"]["grouped_gemm"]
    return {"name": "grouped_gemm", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/grouped_gemm.cu",
            "kernel": "grouped_wgmma_kernel (bf16 TMA can describe); "
                      "grouped_os_kernel (the rest)",
            "replaces": "src/repro/kernels/grouped_gemm.py:73",
            "launches": launches,
            "launches_by_route": {"wgmma": granite["grouped_wgmma"],
                                  "sync": launches - granite["grouped_wgmma"]},
            "launches_by_path": {
                "granite_sorted_serve": launches,
                "mixtral_8x7b_4_layers_static_serve":
                    REPORT[MIXTRAL]["static"]["counts"]["grouped_gemm"],
                "mixtral_8x7b_4_layers_serve":
                    REPORT[MIXTRAL]["counts"]["grouped_gemm"],
                "mixtral_8x7b_smoke_sort": sum(
                    run["grouped_gemm"] for run in REPORT["new_smoke_parity"][
                        "card_launches"][f"{MIXTRAL} sort"].values())},
            "per": f"call, bf16, (E, C, D, F) = {tuple(main['shape'])}, "
                   f"wgmma tile {tuple(main['tile'])}",
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            **{k: main[k] for k in keys},
            "by_shape": [{"shape": r["shape"], "dtype": r["dtype"],
                          **{k: r[k] for k in shape_keys if k in r}}
                         for r in rows]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:] == ["--sweep"]:
        return sweep()
    if sys.argv[1:] == ["--sweep-int8"]:
        return sweep_int8()
    t0 = time.perf_counter()
    seconds = REPORT["phase_seconds"] = {}

    def run(name, fn, *args):
        """One phase, its seconds kept in REPORT["phase_seconds"]."""
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t
        return out

    run("1 setup", phase_setup)
    rows = run("2 gemm kernels", phase_kernels)
    attn = run("3 attention kernels", phase_attention_kernels)
    grouped_rows = run("8 grouped kernel", phase_grouped_kernel)
    int8_rows = run("12 int8 kernel", phase_int8_kernel)
    paged_int8_rows = run("14 int8-pool paged kernel",
                          phase_paged_int8_kernel)
    sparse_rows = run("17 sparse kernel", phase_sparse_kernel, FLOAT_SPARSE)
    cfg = get_config(ARCH)
    served = run("4 static serve", phase_main_path, cfg)
    run("7 parity", phase_parity, cfg, served)
    del served
    paged = run("5 paged serve", phase_scheduler, cfg)
    run("6 shared prefix", phase_shared_prefix, cfg, paged)
    run("7 parity", phase_paged_parity, cfg, paged)
    del paged                              # free qwen before the int8 serves
    torch.cuda.empty_cache()
    qparams = run("13 int8 serves", phase_int8_static, cfg)
    run("13 int8 serves", phase_int8_paged, cfg, qparams)
    del qparams                            # free qwen before granite
    torch.cuda.empty_cache()
    run("13 int8 serves", phase_int8_smoke_parity)
    run("15 --quantize serves", phase_quantize_static, cfg)
    torch.cuda.empty_cache()
    qpaged = run("15 --quantize serves", phase_quantize_paged, cfg)
    torch.cuda.empty_cache()
    run("16 --quantize SMOKE parity", phase_int8_smoke_parity, "int8")
    run("18-19 --sparsity serves", phase_sparse_serves, cfg, FLOAT_SPARSE)
    sparse_int8_rows = run("20 sparse x int8 kernel", phase_sparse_kernel,
                           INT8_SPARSE)
    run("21-23 sparse x int8 serves", phase_sparse_serves, cfg, INT8_SPARSE)
    granite = run("9 granite sorted serve", phase_granite_sorted)
    run("11 granite parity", phase_granite_parity, granite)
    del granite
    torch.cuda.empty_cache()
    run("10 granite einsum serve", phase_granite_einsum)
    run("11 granite parity", phase_granite_smoke_parity)
    for arch in (QWEN3, GEMMA3):
        run(f"24 {arch}", phase_decisions, arch, get_config(arch), True)
        out = run(f"24 {arch}", phase_wide_static, arch)
        del out
        torch.cuda.empty_cache()
        out = run(f"24 {arch}", paged_serve_phase, arch, WIDE[arch]["trace"],
                  f"{arch}_paged", True)
        del out
        torch.cuda.empty_cache()
    run("25 mistral-large-123b", phase_mistral)
    torch.cuda.empty_cache()
    run("28 mixtral-8x7b", phase_mixtral)
    torch.cuda.empty_cache()
    for number, arch in (("29", MAMBA), ("30", RGEMMA)):
        run(f"{number} {arch}", phase_recurrent, arch)
        torch.cuda.empty_cache()
    run(f"31 {HUBERT}", phase_hubert)
    torch.cuda.empty_cache()
    run(f"32 {INTERNVL}", phase_internvl)
    torch.cuda.empty_cache()
    run("26 new SMOKE parity", phase_new_smoke_parity)
    run("26 new SMOKE parity", phase_embeds_smoke_parity)
    run("27 granite --quantize", phase_granite_quantize)
    torch.cuda.empty_cache()
    run("33 qwen2 --speculate", phase_spec_qwen, cfg)
    torch.cuda.empty_cache()
    run("34 qwen2 --quantize --speculate", phase_spec_quantize, cfg)
    torch.cuda.empty_cache()
    run("35 qwen2 --prefill-chunk", phase_chunk_qwen, cfg)
    torch.cuda.empty_cache()
    run(f"36 {RGEMMA} chunk and spec", phase_rgemma_spec_chunk)
    torch.cuda.empty_cache()
    run("37 spec and chunk SMOKE", phase_spec_chunk_smoke)
    run("38 accelerator plane", phase_plane1)
    torch.cuda.empty_cache()
    run("39 warm start", phase_warm_start, cfg)
    torch.cuda.empty_cache()
    run("40 VJPs", phase_vjps)
    torch.cuda.empty_cache()
    run("41 qwen2 training", phase_train_qwen, cfg)
    torch.cuda.empty_cache()
    run("42 training postures", phase_train_postures, cfg)
    torch.cuda.empty_cache()
    run("43 training SMOKE", phase_train_smoke)
    print("phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                        for k, v in seconds.items()))
    lines = [*gemm_lines(rows, REPORT["main_path"], REPORT["paged_serve"],
                         REPORT["granite_sorted"]),
             *attention_lines(attn, REPORT["paged_serve"]),
             grouped_line(grouped_rows, REPORT["granite_sorted"]),
             *int8_lines(int8_rows),
             paged_int8_line(paged_int8_rows, qpaged),
             sparse_line(sparse_rows, FLOAT_SPARSE),
             sparse_reduce_line(sparse_rows),
             sparse_line(sparse_int8_rows, INT8_SPARSE)]
    REPORT["kernels"] = lines
    REPORT["seconds"] = time.perf_counter() - t0
    out_dir = ROOT / "runs"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(REPORT, indent=1,
                                                        default=str))
    print(f"chip_smoke: all phases passed in {REPORT['seconds']:.1f} s")
    print(json.dumps({"kernels": lines}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

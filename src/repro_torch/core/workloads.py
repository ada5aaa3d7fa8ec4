"""GEMM traces of the paper's eight benchmark DNNs (Table 3).

The port's own copy of `repro/core/workloads.py`: the same numpy
operations in the same order, so every result is bit for bit the
reference's.

Every DNN layer is lowered to GEMMs exactly as Sec. 2.1 describes:
  * CONV2D        -> im2col: M = OH*OW, K = kh*kw*Cin, N = Cout
  * depth-wise    -> diagonalwise refactorization / filter gathering [27]:
                     the k x k filter is vectorized, channels become array
                     columns: M = OH*OW, K = kh*kw, N = C (this is why DW
                     utilization is low on fixed arrays, Sec. 5.5)
  * FC / proj     -> plain GEMM (matrix-vector for batch-1 inference)
  * LSTM          -> 8 matrix-vector products per step (Sec. 2.1); we fold
                     the 4 gates into (1, H_in, 4H) / (1, H, 4H) GEMMs with
                     `count` = timesteps (x2 for bidirectional)
  * MHA           -> QKV/proj GEMMs + per-head score/context GEMMs

Exact proprietary traces from the paper are unavailable; these are
reconstructed from the cited model definitions (ResNet-50 [20],
EfficientNet-B0 [10], TinyYOLO-V2, FasterRCNN, ViT-B/32, BERT-Large,
GNMT, DeepSpeech2) at MLPerf-style inference batch 1.  The headline GEMMs
the paper quotes are reproduced exactly: ResNet-50's (49,2048,512) and
(12544,147,64) with 21 distinct shapes, TinyYOLO-V2 layer 2 =
(43264, 144, 32) [quoted (M,N,K)-ordered as (43264,32,144) in Fig. 22],
ViT FFNs (50,768,3072)/(50,3072,768), BERT (128,1024,4096) family.

`vector_elements` approximates the non-GEMM (ReLU/softmax/pool/norm)
element traffic feeding Fig. 15's activation-time slice.
"""

from __future__ import annotations

import dataclasses

from .analytical_model import GEMM


@dataclasses.dataclass(frozen=True)
class Workload:
    name: str
    abbr: str
    domain: str
    gemms: tuple[GEMM, ...]
    vector_elements: int = 0

    @property
    def total_macs(self) -> int:
        return sum(g.macs for g in self.gemms)

    @property
    def n_layers(self) -> int:
        return len(self.gemms)


def _conv(oh_ow: int, kh_kw_cin: int, cout: int, name: str, count: int = 1) -> GEMM:
    return GEMM(M=oh_ow, K=kh_kw_cin, N=cout, count=count, name=name)


# ---------------------------------------------------------------------------
# ResNet-50 @ 224x224, batch 1  (54 conv/fc layers)
# ---------------------------------------------------------------------------

def _resnet50() -> Workload:
    g: list[GEMM] = [_conv(112 * 112, 7 * 7 * 3, 64, "conv1")]
    # (stage, spatial, in_c, mid_c, out_c, blocks)
    stages = (
        ("conv2", 56 * 56, 64, 64, 256, 3),
        ("conv3", 28 * 28, 256, 128, 512, 4),
        ("conv4", 14 * 14, 512, 256, 1024, 6),
        ("conv5", 7 * 7, 1024, 512, 2048, 3),
    )
    for name, hw, cin, mid, cout, blocks in stages:
        # block 1 (with projection shortcut)
        g.append(_conv(hw, cin, mid, f"{name}_1/1x1a"))
        g.append(_conv(hw, 9 * mid, mid, f"{name}_1/3x3"))
        g.append(_conv(hw, mid, cout, f"{name}_1/1x1b"))
        g.append(_conv(hw, cin, cout, f"{name}_1/proj"))
        for b in range(2, blocks + 1):
            g.append(_conv(hw, cout, mid, f"{name}_{b}/1x1a"))
            g.append(_conv(hw, 9 * mid, mid, f"{name}_{b}/3x3"))
            g.append(_conv(hw, mid, cout, f"{name}_{b}/1x1b"))
    g.append(GEMM(1, 2048, 1000, name="fc"))
    vec = sum(x.M * x.N * x.count for x in g) * 2  # relu + bn per conv output
    return Workload("ResNet-50", "RE", "Image Classification", tuple(g), vec)


# ---------------------------------------------------------------------------
# EfficientNet-B0 @ 224x224 (82 layers incl. SE FCs)
# ---------------------------------------------------------------------------

def _efficientnet_b0() -> Workload:
    g: list[GEMM] = [_conv(112 * 112, 27, 32, "stem")]
    # (blocks, spatial_in, spatial_out, cin, cout, k, expand)
    mb = (
        (1, 112, 112, 32, 16, 3, 1),
        (2, 112, 56, 16, 24, 3, 6),
        (2, 56, 28, 24, 40, 5, 6),
        (3, 28, 14, 40, 80, 3, 6),
        (3, 14, 14, 80, 112, 5, 6),
        (4, 14, 7, 112, 192, 5, 6),
        (1, 7, 7, 192, 320, 3, 6),
    )
    for blocks, s_in, s_out, cin, cout, k, expand in mb:
        for b in range(blocks):
            c_in = cin if b == 0 else cout
            s_i = s_in if b == 0 else s_out
            c_exp = c_in * expand
            if expand != 1:
                g.append(_conv(s_i * s_i, c_in, c_exp, f"mb{cout}_{b}/expand"))
            g.append(_conv(s_out * s_out, k * k, c_exp, f"mb{cout}_{b}/dw{k}x{k}"))
            c_se = max(1, c_in // 4)
            g.append(GEMM(1, c_exp, c_se, name=f"mb{cout}_{b}/se_reduce"))
            g.append(GEMM(1, c_se, c_exp, name=f"mb{cout}_{b}/se_expand"))
            g.append(_conv(s_out * s_out, c_exp, cout, f"mb{cout}_{b}/project"))
    g.append(_conv(7 * 7, 320, 1280, "head"))
    g.append(GEMM(1, 1280, 1000, name="fc"))
    vec = sum(x.M * x.N * x.count for x in g) * 3  # swish + bn + se-mul
    return Workload("EfficientNet-B0", "EF", "Image Classification", tuple(g), vec)


# ---------------------------------------------------------------------------
# TinyYOLO-V2 @ 416x416 (9 conv layers)
# ---------------------------------------------------------------------------

def _tinyyolo_v2() -> Workload:
    g = (
        _conv(416 * 416, 27, 16, "conv1"),
        _conv(208 * 208, 144, 32, "conv2"),       # Fig. 22 case-study layer
        _conv(104 * 104, 288, 64, "conv3"),
        _conv(52 * 52, 576, 128, "conv4"),
        _conv(26 * 26, 1152, 256, "conv5"),
        _conv(13 * 13, 2304, 512, "conv6"),
        _conv(13 * 13, 4608, 1024, "conv7"),
        _conv(13 * 13, 9216, 1024, "conv8"),
        _conv(13 * 13, 1024, 125, "conv9"),
    )
    vec = sum(x.M * x.N for x in g) * 2
    return Workload("TinyYOLO-V2", "TY", "Object Detection", g, vec)


# ---------------------------------------------------------------------------
# FasterRCNN (ResNet-50 C4 backbone + RPN + ROI head, ~600x800 input)
# ---------------------------------------------------------------------------

def _fasterrcnn() -> Workload:
    g: list[GEMM] = [_conv(300 * 400, 7 * 7 * 3, 64, "conv1")]
    stages = (
        ("conv2", 150 * 200, 64, 64, 256, 3),
        ("conv3", 75 * 100, 256, 128, 512, 4),
        ("conv4", 38 * 50, 512, 256, 1024, 6),
    )
    for name, hw, cin, mid, cout, blocks in stages:
        g.append(_conv(hw, cin, mid, f"{name}_1/1x1a"))
        g.append(_conv(hw, 9 * mid, mid, f"{name}_1/3x3"))
        g.append(_conv(hw, mid, cout, f"{name}_1/1x1b"))
        g.append(_conv(hw, cin, cout, f"{name}_1/proj"))
        for b in range(2, blocks + 1):
            g.append(_conv(hw, cout, mid, f"{name}_{b}/1x1a"))
            g.append(_conv(hw, 9 * mid, mid, f"{name}_{b}/3x3"))
            g.append(_conv(hw, mid, cout, f"{name}_{b}/1x1b"))
    # RPN on the 38x50 C4 map
    g.append(_conv(38 * 50, 9 * 1024, 512, "rpn/3x3"))
    g.append(_conv(38 * 50, 512, 18, "rpn/cls"))
    g.append(_conv(38 * 50, 512, 36, "rpn/bbox"))
    # ROI head: stage-5 bottlenecks over 300 ROIs of 7x7
    roi_m = 300 * 7 * 7
    g.append(_conv(roi_m, 1024, 512, "roi/conv5_1_1x1a"))
    g.append(_conv(roi_m, 9 * 512, 512, "roi/conv5_1_3x3"))
    g.append(_conv(roi_m, 512, 2048, "roi/conv5_1_1x1b"))
    g.append(_conv(roi_m, 1024, 2048, "roi/conv5_1_proj"))
    for b in (2, 3):
        g.append(_conv(roi_m, 2048, 512, f"roi/conv5_{b}_1x1a"))
        g.append(_conv(roi_m, 9 * 512, 512, f"roi/conv5_{b}_3x3"))
        g.append(_conv(roi_m, 512, 2048, f"roi/conv5_{b}_1x1b"))
    g.append(GEMM(300, 2048, 81, name="roi/cls"))
    g.append(GEMM(300, 2048, 324, name="roi/bbox"))
    vec = sum(x.M * x.N * x.count for x in g) * 2
    return Workload("FasterRCNN", "FR", "Object Detection", tuple(g), vec)


# ---------------------------------------------------------------------------
# ViT-B/32 @ 224x224: 50 tokens, d=768, 12 layers (FFN = 55% of MACs)
# ---------------------------------------------------------------------------

def _vit() -> Workload:
    seq, d, heads, dh, ffn, layers = 50, 768, 12, 64, 3072, 12
    g: list[GEMM] = [GEMM(49, 32 * 32 * 3, d, name="patch_embed")]
    per_layer = (
        GEMM(seq, d, 3 * d, name="qkv"),
        GEMM(seq, dh, seq, count=heads, name="attn_scores"),
        GEMM(seq, seq, dh, count=heads, name="attn_ctx"),
        GEMM(seq, d, d, name="attn_proj"),
        GEMM(seq, d, ffn, name="ffn1"),
        GEMM(seq, ffn, d, name="ffn2"),
    )
    for i in range(layers):
        g.extend(dataclasses.replace(x, name=f"l{i}/{x.name}") for x in per_layer)
    g.append(GEMM(1, d, 1000, name="head"))
    vec = layers * (seq * seq * heads * 4 + seq * d * 8)  # softmax + LN + gelu
    return Workload("ViT", "VI", "Image Classification", tuple(g), vec)


# ---------------------------------------------------------------------------
# BERT-Large, seq 128: d=1024, 16 heads, FFN 4096, 24 layers
# ---------------------------------------------------------------------------

def _bert_large() -> Workload:
    seq, d, heads, dh, ffn, layers = 128, 1024, 16, 64, 4096, 24
    g: list[GEMM] = []
    per_layer = (
        GEMM(seq, d, d, count=3, name="qkv"),
        GEMM(seq, dh, seq, count=heads, name="attn_scores"),
        GEMM(seq, seq, dh, count=heads, name="attn_ctx"),
        GEMM(seq, d, d, name="attn_proj"),
        GEMM(seq, d, ffn, name="ffn1"),
        GEMM(seq, ffn, d, name="ffn2"),
    )
    for i in range(layers):
        g.extend(dataclasses.replace(x, name=f"l{i}/{x.name}") for x in per_layer)
    vec = layers * (seq * seq * heads * 4 + seq * d * 8)
    return Workload("BERT-Large", "BE", "Machine Translation", tuple(g), vec)


# ---------------------------------------------------------------------------
# GNMT: 8+8 LSTM layers, h=1024, batch-1 decode (matrix-vector GEMMs)
# ---------------------------------------------------------------------------

def _gnmt() -> Workload:
    h, steps, vocab = 1024, 50, 32000
    g: list[GEMM] = []
    for i in range(8):  # encoder (layer 0 bidirectional)
        mult = 2 if i == 0 else 1
        g.append(GEMM(1, h, 4 * h, count=steps * mult, name=f"enc{i}/Wx"))
        g.append(GEMM(1, h, 4 * h, count=steps * mult, name=f"enc{i}/Wh"))
    for i in range(8):  # decoder
        g.append(GEMM(1, h, 4 * h, count=steps, name=f"dec{i}/Wx"))
        g.append(GEMM(1, h, 4 * h, count=steps, name=f"dec{i}/Wh"))
    g.append(GEMM(1, h, h, count=steps, name="attention"))
    g.append(GEMM(1, h, vocab, count=steps, name="softmax_proj"))
    vec = steps * 16 * 8 * h + steps * vocab  # gates + softmax
    return Workload("GNMT", "GN", "Machine Translation", tuple(g), vec)


# ---------------------------------------------------------------------------
# DeepSpeech2: 2 conv + 5 bidirectional LSTM (h=1024) + FC, T=300 frames
# ---------------------------------------------------------------------------

def _deepspeech2() -> Workload:
    t, h = 150, 1024  # frames after stride-2 conv
    g: list[GEMM] = [
        _conv(81 * 150, 41 * 11 * 1, 32, "conv1"),
        _conv(41 * 150, 21 * 11 * 32, 32, "conv2"),
    ]
    in0 = 41 * 32
    g.append(GEMM(1, in0, 4 * h, count=t * 2, name="lstm0/Wx"))
    g.append(GEMM(1, h, 4 * h, count=t * 2, name="lstm0/Wh"))
    for i in range(1, 5):
        g.append(GEMM(1, 2 * h, 4 * h, count=t * 2, name=f"lstm{i}/Wx"))
        g.append(GEMM(1, h, 4 * h, count=t * 2, name=f"lstm{i}/Wh"))
    g.append(GEMM(1, 2 * h, 29, count=t, name="fc_ctc"))
    vec = t * 2 * 5 * 16 * h
    return Workload("DeepSpeech2", "DS", "Automatic Speech Recognition", tuple(g), vec)


def build_workloads() -> dict[str, Workload]:
    ws = (
        _resnet50(), _efficientnet_b0(), _tinyyolo_v2(), _fasterrcnn(),
        _vit(), _bert_large(), _gnmt(), _deepspeech2(),
    )
    return {w.abbr: w for w in ws}


WORKLOADS = build_workloads()


# ---------------------------------------------------------------------------
# Plane-2 bridge: GEMM traces of the assigned LM architectures
# ---------------------------------------------------------------------------

ARCH_TRACE_SEQ = 512  # default prefill length for arch traces


def arch_gemms(cfg, *, seq_len: int = ARCH_TRACE_SEQ, batch: int = 1) -> tuple[GEMM, ...]:
    """Lower a `repro_torch.models.config.ArchConfig` to its GEMM trace.

    The mapper-facing view of one prefill pass at batch x seq_len: every
    projection / attention / FFN / MoE-expert / SSD-chunk matmul becomes
    a GEMM, with repeated layers collapsed via `count` exactly like the
    Table-3 traces above (decision cache stays O(#distinct shapes)).
    This is a *search workload*, not a cycle-exact lowering: elementwise
    ops (norms, gates, convs, rotary) are out of scope like
    `vector_elements` is for the paper suite.
    """
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim_
    nh, nkv = cfg.n_heads, cfg.n_kv
    seq = seq_len + cfg.prefix_tokens  # VLM: image patch embeds prepended
    tokens = seq * batch
    pattern = cfg.layer_pattern
    n_of = {k: sum(1 for i in range(cfg.n_layers)
                   if pattern[i % len(pattern)] == k)
            for k in set(pattern)}
    g: list[GEMM] = []

    def mlp(prefix: str, blocks: int) -> list[GEMM]:
        if cfg.moe is not None:
            e, k = cfg.moe.n_experts, cfg.moe.top_k
            per_exp = max(1, -(-tokens * k // e))  # balanced routing
            n_up = 2 if cfg.gated_mlp else 1
            return [
                GEMM(tokens, d, e, count=blocks, name=f"{prefix}/router"),
                GEMM(per_exp, d, f, count=blocks * e * n_up, name=f"{prefix}/expert_up"),
                GEMM(per_exp, f, d, count=blocks * e, name=f"{prefix}/expert_down"),
            ]
        n_up = 2 if cfg.gated_mlp else 1
        return [
            GEMM(tokens, d, f, count=blocks * n_up, name=f"{prefix}/ffn_up"),
            GEMM(tokens, f, d, count=blocks, name=f"{prefix}/ffn_down"),
        ]

    for kind, blocks in sorted(n_of.items()):
        if blocks == 0:
            continue  # pattern kind unused at this n_layers (truncated config)
        if kind in ("attn", "local"):
            ctx = min(seq, cfg.window) if (kind == "local" and cfg.window) else seq
            g += [
                GEMM(tokens, d, hd * (nh + 2 * nkv), count=blocks, name=f"{kind}/qkv"),
                GEMM(seq, hd, ctx, count=blocks * nh * batch, name=f"{kind}/scores"),
                GEMM(seq, ctx, hd, count=blocks * nh * batch, name=f"{kind}/ctx"),
                GEMM(tokens, nh * hd, d, count=blocks, name=f"{kind}/proj"),
            ]
            g += mlp(kind, blocks)
        elif kind == "ssm":
            s = cfg.ssm
            d_in = s.expand * d
            heads = d_in // s.head_dim
            n_chunks = -(-seq // s.chunk)
            per_chunk = blocks * heads * n_chunks * batch
            g += [
                GEMM(tokens, d, 2 * d_in + 2 * s.n_groups * s.d_state + heads,
                     count=blocks, name="ssm/in_proj"),
                GEMM(s.chunk, s.d_state, s.chunk, count=per_chunk, name="ssm/chunk_scores"),
                GEMM(s.chunk, s.chunk, s.head_dim, count=per_chunk, name="ssm/chunk_ctx"),
                GEMM(s.d_state, s.chunk, s.head_dim, count=per_chunk, name="ssm/chunk_state"),
                GEMM(tokens, d_in, d, count=blocks, name="ssm/out_proj"),
            ]
        elif kind == "rglru":
            w = cfg.rglru_width or d
            g += [
                GEMM(tokens, d, w, count=2 * blocks, name="rglru/in_proj"),
                GEMM(tokens, w, d, count=blocks, name="rglru/out_proj"),
            ]
            g += mlp("rglru", blocks)
        else:  # pragma: no cover - schema guards BlockKind
            raise ValueError(f"unknown block kind {kind!r}")
    g.append(GEMM(tokens, d, cfg.vocab, name="lm_head"))
    return tuple(g)


def arch_traces(*, smoke: bool = False, seq_len: int = ARCH_TRACE_SEQ,
                batch: int = 1) -> dict[str, tuple[GEMM, ...]]:
    """GEMM traces for every registered arch in repro_torch.configs."""
    from ..configs import all_configs  # lazy: keeps core importable alone

    return {name: arch_gemms(c, seq_len=seq_len, batch=batch)
            for name, c in all_configs(smoke=smoke).items()}

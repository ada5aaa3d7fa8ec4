"""Deterministic, stateless data pipeline (the port's own copy of
`repro/data/pipeline.py`, over the port's `ArchConfig`: the same numpy
`SeedSequence` streams, so every batch is bit for bit the reference's).

The batch for global step s is a pure function of (seed, s): a restart
regenerates the identical stream with no iterator state to checkpoint.
Two sources:

  * SyntheticLM  — numpy PRNG tokens over SeedSequence([seed, step]),
    with a planted bigram structure;
  * MemmapCorpus — fixed-length windows over a token file (np.memmap),
    the window starts drawn from SeedSequence([seed, step, 1]).

Both emit {"tokens": (B, S+1) int32} host arrays; `train_lib` shifts
them into (inputs, labels) and `train_lib.train.device_batch` moves them
onto the device.  For embed-input archs (audio) the pipeline emits frame
embeddings instead; for a VLM it adds pixel patch embeddings.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..models.config import ArchConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch: int
    seq_len: int
    seed: int = 0


class SyntheticLM:
    """step -> batch, deterministically.  Vocabulary-uniform tokens with a
    planted bigram structure so tiny-model training loss visibly drops."""

    def __init__(self, cfg: ArchConfig, data: DataConfig):
        self.cfg, self.data = cfg, data

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.data.seed, step]))

    def batch(self, step: int) -> dict:
        cfg, d = self.cfg, self.data
        rng = self._rng(step)
        out: dict = {}
        if cfg.embed_inputs:  # audio frontend stub: frame embeddings
            out["embeds"] = rng.normal(
                size=(d.batch, d.seq_len, cfg.d_model)).astype(np.float32)
            out["labels"] = rng.integers(
                0, cfg.vocab, size=(d.batch, d.seq_len), dtype=np.int32)
            return out
        toks = rng.integers(0, cfg.vocab,
                            size=(d.batch, d.seq_len + 1), dtype=np.int32)
        # plant learnable structure: even positions repeat (token % 97)
        toks[:, 2::2] = (toks[:, 1:-1:2] * 31 + 7) % min(cfg.vocab, 97)
        out["tokens"] = toks
        if cfg.prefix_tokens:  # VLM frontend stub: patch embeddings
            out["pixel_embeds"] = 0.02 * rng.normal(
                size=(d.batch, cfg.prefix_tokens, cfg.d_model)).astype(np.float32)
        return out


class MemmapCorpus:
    """Windows over a flat int32 token file; deterministic per step."""

    def __init__(self, path: str, cfg: ArchConfig, data: DataConfig):
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")
        self.cfg, self.data = cfg, data
        self.n_windows = max(len(self.tokens) - data.seq_len - 1, 1)

    def batch(self, step: int) -> dict:
        d = self.data
        rng = np.random.default_rng(np.random.SeedSequence([d.seed, step, 1]))
        starts = rng.integers(0, self.n_windows, size=d.batch)
        toks = np.stack([
            np.asarray(self.tokens[s:s + d.seq_len + 1]) for s in starts])
        return {"tokens": np.clip(toks, 0, self.cfg.vocab - 1).astype(np.int32)}


def make_source(cfg: ArchConfig, data: DataConfig, path: str | None = None):
    if path:
        return MemmapCorpus(path, cfg, data)
    return SyntheticLM(cfg, data)

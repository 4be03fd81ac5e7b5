"""Batch loader (a copy of ``repro.data.loader``, numpy only, so both
packages see bit-identical batches): shapes batches as the pipeline wants them —
[num_micro, mb_global, seq] token/label arrays (+ stub modality inputs),
deterministically resumable (step-indexed), with next-token labels."""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.data.synthetic import zipf_token_stream


@dataclasses.dataclass
class DataConfig:
    num_micro: int
    mb_global: int
    seq: int
    seed: int = 0


def make_loader(cfg: ModelConfig, dc: DataConfig, start_step: int = 0
                ) -> Iterator[Dict[str, np.ndarray]]:
    """Yields batches; resumable by constructing with start_step."""
    need = dc.num_micro * dc.mb_global * (dc.seq + 1)
    stream = zipf_token_stream(cfg.vocab_size, seed=dc.seed,
                               block=max(1 << 16, need))
    buf = np.empty(0, np.int32)
    step = 0
    for blockarr in stream:
        buf = np.concatenate([buf, blockarr])
        while len(buf) >= need:
            chunk, buf = buf[:need], buf[need:]
            if step >= start_step:
                toks = chunk.reshape(dc.num_micro, dc.mb_global, dc.seq + 1)
                batch = {
                    "tokens": toks[..., :-1],
                    "labels": toks[..., 1:],
                    "label_mask": np.ones(
                        (dc.num_micro, dc.mb_global, dc.seq), np.float32),
                }
                if cfg.family == "vlm":
                    rng = np.random.RandomState(dc.seed * 9973 + step)
                    batch["prefix_emb"] = rng.randn(
                        dc.num_micro, dc.mb_global, cfg.num_patches,
                        cfg.d_model).astype(np.float32) * 0.05
                if cfg.is_encdec:
                    rng = np.random.RandomState(dc.seed * 7919 + step)
                    batch["frames"] = rng.randn(
                        dc.num_micro, dc.mb_global, cfg.encoder_seq,
                        cfg.d_model).astype(np.float32) * 0.05
                yield batch
            step += 1

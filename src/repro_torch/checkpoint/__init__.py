"""Checkpoint-side state reshaping, ported from ``repro.checkpoint``: the
elastic re-split of stage-keyed state onto another stage count (the live
resize's data path).  Checkpoints, safe points and resume wait for ROADMAP
Queue 1 [checkpoint]."""
from repro_torch.checkpoint.elastic import elastic_restore, resplit_indices

__all__ = ["elastic_restore", "resplit_indices"]

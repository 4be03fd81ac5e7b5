"""Checkpoints, safe points and the elastic re-split, ported from
``repro.checkpoint``: stage-sharded npz checkpoints with a checksummed
index, safe points that carry the control-plane state a resume needs, and
the re-split of stage-keyed state onto another stage count (the live
resize's data path)."""
from repro_torch.checkpoint.checkpoint import (CheckpointManager,
                                               latest_index, load_checkpoint,
                                               save_checkpoint)
from repro_torch.checkpoint.elastic import elastic_restore, resplit_indices
from repro_torch.checkpoint.safepoint import SafepointManager

__all__ = ["CheckpointManager", "save_checkpoint", "load_checkpoint",
           "latest_index", "elastic_restore", "resplit_indices",
           "SafepointManager"]

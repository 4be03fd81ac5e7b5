"""Which rows of the state each rank holds — the placement policy of
``repro.launch.sharding`` for a mesh of ranks.

  * stage-keyed trees ``[S, L_max, ...]`` (params["stages"], both Adam
    moments' ``stages``, dyn state, the decode cache): rank (d, s) holds
    row s, as a ``[1, L_max, ...]`` tree;
  * embed, head, ``final_norm`` and ``shared``: replicated over ``model``
    (their gradients are summed over the ring);
  * the batch ``[m, B, ...]``: B split over ``data`` (B / dp lanes per
    replica);
  * the assignment: host-side and whole on every rank.

FSDP (the reference shards stage weights over ``data`` for archs above 8B
parameters) is not in the port yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any

# the reference turns FSDP on above this many parameters
# (``repro.launch.specs``)
FSDP_PARAMS = 8e9


def check_layout(cfg, mesh) -> None:
    """Refuse what this layout cannot hold: FSDP over ``data``."""
    if mesh is not None and mesh.data > 1 and cfg.param_count() > FSDP_PARAMS:
        raise NotImplementedError(
            f"{cfg.name} has {cfg.param_count() / 1e9:.1f}B parameters: the "
            f"reference shards its stage weights over data (FSDP), which "
            f"the port's ranks do not yet (ROADMAP Queue 1 [multi-card])")


def local_rows(tree: Any, mesh) -> Any:
    """This rank's ``[1, L_max, ...]`` row of a stage-keyed tree (a copy:
    the full tree can be freed)."""
    if isinstance(tree, dict):
        return {k: local_rows(v, mesh) for k, v in tree.items()}
    s = mesh.stage
    return tree[s:s + 1].clone()


def gather_rows(tree: Any, mesh) -> Any:
    """The whole ``[S, L_max, ...]`` tree from every rank's row (an
    all-gather over the model ring)."""
    if isinstance(tree, dict):
        return {k: gather_rows(v, mesh) for k, v in tree.items()}
    return mesh.comm.all_gather(tree[0], mesh.model_group)


def gather_opt(opt_state: Any, mesh) -> Any:
    """The optimizer state with each ``stages`` subtree gathered whole
    (moments mirror the param tree)."""
    if isinstance(opt_state, dict):
        return {k: (gather_rows(v, mesh) if k == "stages"
                    else gather_opt(v, mesh)) for k, v in opt_state.items()}
    return opt_state


def local_params(params: Any, mesh) -> Any:
    out = dict(params)
    out["stages"] = local_rows(params["stages"], mesh)
    return out


def gather_params(params: Any, mesh) -> Any:
    out = dict(params)
    out["stages"] = gather_rows(params["stages"], mesh)
    return out


def lanes(mesh, B: int) -> slice:
    """This replica's lanes of a batch of ``B``."""
    dp = 1 if mesh is None else mesh.data
    if B % dp:
        raise ValueError(f"a microbatch of {B} lanes does not split over "
                         f"data={dp}")
    n = B // dp
    d = 0 if mesh is None else mesh.replica
    return slice(d * n, (d + 1) * n)


def split_batch(batch, mesh):
    """The replica's lanes of every ``[m, B, ...]`` leaf of the batch."""
    if mesh is None or mesh.data == 1:
        return batch
    return {k: v[:, lanes(mesh, v.shape[1])] for k, v in batch.items()}


def replica_shapes(shapes, mesh):
    """``PipelineShapes`` of one data replica (``mb_global / dp`` lanes)."""
    if mesh is None or mesh.data == 1:
        return shapes
    sl = lanes(mesh, shapes.mb_global)
    return dataclasses.replace(shapes, mb_global=sl.stop - sl.start)


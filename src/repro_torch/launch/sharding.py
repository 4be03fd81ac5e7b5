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

A resize moves a world onto another set of ranks (a column of ``data``
ranks per worker, ``launch.engine``): a rank outside the new world holds
nothing (``drop_state``), a rank new to it receives its stage rows
(``core.migration.exchange_rows``) and the replicated leaves and their
moments from the new world's stage-0 rank of its data row
(``send_replicated``); ``row_template`` gives the shapes a receive lands
in, ``tree_digest`` the bytes every rank of a world must agree on.

Stage rows stay on their ``model`` rank and are replicated over ``data``
for every arch, as the reference's runtime places them
(``ElasticEngine._place``: stage leaves on ``model``, everything else
replicated).  The reference's FSDP sharding over ``data`` (archs above 8B
parameters) is read only by its AOT dry-run's input specs; its port
belongs with that dry-run (ROADMAP Queue 1 [tpu-mesh]).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Optional, Tuple

import torch


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



# ---------------------------------------------------------------------------
# Resizes across ranks
# ---------------------------------------------------------------------------
def row_template(tree: Any) -> Any:
    """``[1, ...]`` tensors on the ``meta`` device in the shape and dtype of
    a stage-keyed tree's rows (no memory behind them)."""
    if isinstance(tree, dict):
        return {k: row_template(v) for k, v in tree.items()}
    return torch.empty((1,) + tuple(tree.shape[1:]), dtype=tree.dtype,
                       device="meta")


def split_stages(tree: Any) -> Tuple[Any, Any]:
    """(the ``stages`` subtrees of a params or optimizer tree, everything
    else): the rows a rank holds of its stage, and the leaves replicated
    over ``model`` (embed, head, ``final_norm``, ``shared``, their moments
    and the step count)."""
    if not isinstance(tree, dict):
        return None, tree
    rows, rest = {}, {}
    for k, v in tree.items():
        if k == "stages":
            rows[k] = v
            continue
        r, o = split_stages(v)
        if r:
            rows[k] = r
        if not (isinstance(v, dict) and "stages" in v and not o):
            rest[k] = o
    return rows, rest


def merge_trees(a: Any, b: Any) -> Any:
    """The union of two trees of dicts with disjoint leaves."""
    if not isinstance(a, dict) or not isinstance(b, dict):
        return b if a is None else a
    out = dict(a)
    for k, v in b.items():
        out[k] = merge_trees(out.get(k), v)
    return out


def leaves(tree, path=()):
    """(path, leaf) of a tree of dicts, keys in sorted order; None leaves
    are skipped."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (k,))
    elif tree is not None:
        yield path, tree


def rebuild(template, fn, path=()):
    """``template``'s tree with each leaf replaced by ``fn(path, leaf)``."""
    if isinstance(template, dict):
        return {k: rebuild(v, fn, path + (k,)) for k, v in template.items()}
    return fn(path, template)


def zeros(template, device):
    """Zeros of a (``meta``) tree's shapes and dtypes on ``device``."""
    return rebuild(template, lambda _, t: torch.zeros(
        t.shape, dtype=t.dtype, device=device))


def send_replicated(rest: Any, template: Any, src, dst, device) -> Any:
    """The replicated leaves (``split_stages``' second half) of a world
    after a resize from ``src`` to ``dst`` (``launch.mesh.Mesh``): a rank in
    both keeps ``rest``; a rank new to ``dst`` receives them, into tensors
    of ``template``'s shapes, from ``dst``'s stage-0 rank of its data row
    (every transfer in one ``batch_isend_irecv``, in the order of ``dst``'s
    ranks and the leaves' paths); a rank outside ``dst`` gets None."""
    if not dst.member:
        return None
    me, comm = dst.rank, dst.comm
    bound = [r for r in dst.ranks if r not in src.ranks]
    sends, recvs, got = [], [], {}
    for r in bound:
        source = dst.rank_of(0, dst.ranks.index(r) // dst.model)
        if source not in src.ranks:
            raise RuntimeError(f"rank {r} joins the world, but its data "
                               f"row's stage-0 rank {source} holds no "
                               f"replicated leaves")
        if me == source:
            sends += [(t, r) for _, t in leaves(rest)]
        elif me == r:
            for path, t in leaves(template):
                got[path] = torch.empty(t.shape, dtype=t.dtype,
                                        device=device)
                recvs.append((got[path], source))
    comm.exchange(sends, recvs)
    if me not in bound:
        return rest
    return rebuild(template, lambda path, _: got[path])


def state_bytes(*trees) -> int:
    """Bytes of every tensor in ``trees`` (what a rank holds of a state)."""
    return sum(t.numel() * t.element_size()
               for tree in trees for _, t in leaves(tree))


def tree_digest(tree: Any) -> Optional[str]:
    """sha256 of a tree's bytes, leaves in path order (None for None)."""
    if tree is None:
        return None
    h = hashlib.sha256()
    for path, t in leaves(tree):
        h.update("/".join(path).encode())
        h.update(t.detach().contiguous().cpu().reshape(-1)
                 .view(torch.uint8).numpy().tobytes())
    return h.hexdigest()

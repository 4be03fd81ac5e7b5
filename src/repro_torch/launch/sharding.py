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
replicated).

The second half of this module is the reference's placement policy for
its dry run, which holds the FSDP layout (``launch.specs``,
``launch.dryrun``): each input of a step gets a partition tuple over a
``LogicalMesh``'s axis names, one entry a dim (None: not split; an axis
name; or a tuple of names, split over their product), as the reference's
``PartitionSpec``s:

  * stage buffers ``[S, L_max, ...]``: ``model`` on dim 0, and with FSDP
    (archs above 8e9 parameters) ``data`` on the largest dim >= 2 that
    ``data`` divides;
  * embed ``[V, d]`` and head ``[d, V]``: the vocabulary over ``data``;
  * ``shared`` and ``final_norm``: replicated (``dec_pos`` on dim 0);
  * the batch ``[m, B, ...]``: B over every data axis;
  * the decode cache ``[S, L_max, m, B, ...]``: ``model``, then the batch
    dim over ``data`` (else the largest divisible dim from 3 on);
  * optimizer moments: their parameter's tuple; Adafactor's ``vr`` drops
    the last entry, ``vc`` the one before it.

``shard_shape`` / ``shard_bytes`` give what one card holds of a leaf.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, NamedTuple, Optional, Tuple

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



# ---------------------------------------------------------------------------
# The dry run's placement (the reference's partition specs, FSDP included)
# ---------------------------------------------------------------------------
class Placed(NamedTuple):
    """A stand-in for one input of a step: its shape, dtype and partition
    tuple over a logical mesh (``()``: replicated).  Allocates nothing."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    placement: Tuple[Any, ...] = ()


def _is_leaf(x) -> bool:
    return not isinstance(x, dict)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of trees of dicts with one structure."""
    if _is_leaf(tree):
        return fn(tree, *rest)
    return {k: tree_map(fn, v, *(r[k] for r in rest))
            for k, v in tree.items()}


def _fsdp_dim(shape: Tuple[int, ...], start: int, size: int
              ) -> Optional[int]:
    """Largest dim index >= start whose size is divisible by ``size``."""
    best, best_sz = None, 0
    for i in range(start, len(shape)):
        if shape[i] % size == 0 and shape[i] >= size and shape[i] > best_sz:
            best, best_sz = i, shape[i]
    return best


def stage_param_spec(shape: Tuple[int, ...], mesh, fsdp: bool = True
                     ) -> Tuple[Any, ...]:
    entries = ["model"] + [None] * (len(shape) - 1)
    if fsdp and len(shape) > 2:
        d = _fsdp_dim(shape, 2, mesh.shape["data"])
        if d is not None:
            entries[d] = "data"
    return tuple(entries)


def param_shardings(cfg, dcfg, mesh, param_tree_spec: Dict[str, Any]):
    """Partition tuples matching ``model.param_spec(cfg, dcfg)``."""
    dsize = mesh.shape["data"]
    out: Dict[str, Any] = {}
    for k, v in param_tree_spec.items():
        if k == "stages":
            out[k] = {f: stage_param_spec(s.shape, mesh, dcfg.fsdp)
                      for f, s in v.items()}
        elif k == "embed":
            out[k] = (("data", None) if v.shape[0] % dsize == 0
                      else (None, None))
        elif k == "head":
            out[k] = ((None, "data") if v.shape[1] % dsize == 0
                      else (None, None))
        elif k == "shared":
            out[k] = {f: (("data", None) if f == "dec_pos"
                          and s.shape[0] % dsize == 0
                          else (None,) * len(s.shape))
                      for f, s in v.items()}
        else:
            out[k] = (None,) * len(v.shape)
    return out


_MOMENT_KEYS = ("m", "v", "vr", "vc", "f")


def opt_shardings(opt_template, p_shardings, mesh):
    """Each moment takes its parameter's tuple, found by path through the
    moment keys (``m``, ``v``, ``f``, ``vr``, ``vc``); Adafactor's ``vr``
    drops the last entry and ``vc`` the one before it; anything else (the
    step count) is replicated."""
    def find(path):
        node = p_shardings
        for key in path:
            if isinstance(node, dict) and key in node:
                node = node[key]
            elif key in _MOMENT_KEYS:
                continue
            else:
                return None
        return None if isinstance(node, dict) else node

    def one(path, leaf):
        ndim = len(leaf.shape)
        pspec = find(path)
        if pspec is None:
            return (None,) * ndim
        entries = list(pspec)
        last = path[-1] if path else ""
        if last == "vr":
            entries = entries[:-1]
        elif last == "vc":
            entries = entries[:-2] + entries[-1:]
        return tuple((entries + [None] * ndim)[:ndim])

    return rebuild(opt_template, one)


def batch_shardings(batch_spec: Dict[str, Any], mesh):
    from repro_torch.launch.mesh import data_axes, dp_degree
    daxes = data_axes(mesh)
    dp = dp_degree(mesh)

    def one(s):
        entries = [None] * len(s.shape)
        if len(s.shape) >= 2 and s.shape[1] % dp == 0:
            entries[1] = daxes if len(daxes) > 1 else daxes[0]
        return tuple(entries)

    return {k: one(v) for k, v in batch_spec.items()}


def cache_shardings(cache_spec: Dict[str, Any], mesh):
    dsize = mesh.shape["data"]

    def one(s):
        entries = ["model"] + [None] * (len(s.shape) - 1)
        # the batch dim (3) first, else the largest divisible dim >= 3
        if len(s.shape) > 3 and s.shape[3] % dsize == 0:
            entries[3] = "data"
        else:
            d = _fsdp_dim(s.shape, 3, dsize)
            if d is not None:
                entries[d] = "data"
        return tuple(entries)

    return {k: one(v) for k, v in cache_spec.items()}


def stage_tree_shardings(tree_spec: Dict[str, Any], mesh):
    """Assignment and dyn leaves ``[S, ...]``: the stage over ``model``."""
    return tree_map(lambda s: ("model",) + (None,) * (len(s.shape) - 1),
                    tree_spec)


def attach(spec_tree, placement_tree):
    """``Placed`` stand-ins: each spec's shape and dtype with its
    placement."""
    return tree_map(lambda s, p: Placed(tuple(s.shape), s.dtype, tuple(p)),
                    spec_tree, placement_tree)


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def shard_shape(shape: Tuple[int, ...], placement, mesh
                ) -> Tuple[int, ...]:
    """The shape one card holds of a leaf of ``shape`` under
    ``placement`` (dims split over their axes' product, rounded up)."""
    sizes = mesh.shape
    out = list(shape)
    for i, entry in enumerate(placement):
        n = 1
        for a in _axes(entry):
            n *= sizes[a]
        out[i] = -(-shape[i] // n)
    return tuple(out)


def shard_bytes(leaf: Placed, mesh) -> int:
    """Bytes one card holds of a ``Placed`` leaf."""
    n = 1
    for d in shard_shape(leaf.shape, leaf.placement, mesh):
        n *= d
    return n * leaf.dtype.itemsize


def tree_bytes(tree, mesh=None) -> int:
    """Bytes of a tree of ``Placed`` leaves: one card's (``mesh`` given),
    or the whole tree's, each leaf counted once."""
    total = 0
    for _, leaf in leaves(tree):
        if mesh is not None:
            total += shard_bytes(leaf, mesh)
        else:
            n = 1
            for d in leaf.shape:
                n *= d
            total += n * leaf.dtype.itemsize
    return total

"""Optimizers over the param dict, ported from ``repro.optim.optimizers``
(plain functions over nested dicts of tensors, not ``torch.optim``).

AdamW (fp32 moments) and Adafactor (factored second moment), both with
global-norm gradient clipping and the per-slot ``frozen`` mask (frozen
layers get zero updates).  State trees mirror the param tree (``m``, ``v``,
``count`` for AdamW; ``f``, ``count`` for Adafactor) so DynMo migration
moves optimizer moments with their layers (paper §4.1).  As in the
reference, weight decay applies to every leaf with ``ndim >= 2`` — in the
stacked ``[S, L_max, ...]`` layout that includes the norm scales and the PAD
slots.  The update is applied in place on the param tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterator, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"            # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    adafactor_min_dim: int = 128   # factor moments only for big matrices


def _leaves(tree, path=()) -> Iterator[Tuple[tuple, Any]]:
    """(path, leaf) in sorted-key order (jax's dict flattening order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _map(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _sq(x) -> torch.Tensor:
    return x.float().square().sum()


def global_norm(tree, mesh=None) -> torch.Tensor:
    """The L2 norm over every leaf.  A ``stages`` leaf adds one sum of
    squares per stage row, in row order; with a ``mesh`` (each rank holding
    its row ``[1, L_max, ...]``) the rows' sums are all-gathered over the
    model ring and added in that same order, so every rank's norm is
    bitwise the one process's."""
    leaves = list(_leaves(tree))
    gathered = None
    if mesh is not None and mesh.model > 1:
        mine = [_sq(x[0]) for p, x in leaves if p[0] == "stages"]
        if mine:
            gathered = mesh.comm.all_gather(torch.stack(mine),
                                            mesh.model_group)    # [S, n]
    sq, j = [], 0
    for path, x in leaves:
        if path[0] != "stages":
            sq.append(_sq(x))
        elif gathered is not None:
            sq += list(gathered[:, j].unbind())
            j += 1
        else:
            sq += [_sq(x[s]) for s in range(x.shape[0])]
    return torch.stack(sq).sum().sqrt()


def clip_scale(grads, max_norm, mesh=None):
    """(the factor that clips ``grads`` to ``max_norm`` global norm, the
    norm); the update applies it leaf by leaf, so no clipped copy of the
    whole gradient tree is ever held (one fp32 leaf at a time)."""
    n = global_norm(grads, mesh)
    return torch.clamp(max_norm / torch.clamp(n, min=1e-12), max=1.0), n


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def adamw_init(params):
    zeros = lambda _, p: torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)
    dev = next(p for _, p in _leaves(params)).device
    return {"m": _map(zeros, params), "v": _map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def _adamw_update(cfg: OptConfig, g, m, v, p, t):
    """Updates m, v in place; returns the update."""
    m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
    v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
    bc1 = 1 - torch.tensor(cfg.b1, dtype=torch.float32,
                           device=t.device) ** t
    bc2 = 1 - torch.tensor(cfg.b2, dtype=torch.float32,
                           device=t.device) ** t
    # in place on fresh temporaries: the same values with fewer full-size
    # fp32 buffers alive at once (an expert leaf is ~1e9 entries)
    upd = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
    if p.dim() >= 2:
        upd.add_(p.float() * cfg.weight_decay)   # p.float() may alias p
    return upd


# ---------------------------------------------------------------------------
# Adafactor (factored v for matrices; full v for small / 1-D leaves)
# ---------------------------------------------------------------------------
def adafactor_init(params, min_dim: int = 128):
    def init(_, p):
        z = dict(dtype=torch.float32, device=p.device)
        if p.dim() >= 2 and p.shape[-1] >= min_dim and p.shape[-2] >= min_dim:
            return {"vr": torch.zeros(p.shape[:-1], **z),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **z)}
        return {"v": torch.zeros(p.shape, **z)}
    dev = next(p for _, p in _leaves(params)).device
    return {"f": _map(init, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def _adafactor_update(cfg: OptConfig, g, st, p, t):
    """Updates ``st`` in place; returns the update."""
    decay = 1.0 - t.float() ** -0.8
    g2 = g * g + 1e-30
    if "vr" in st:
        st["vr"].copy_(decay * st["vr"] + (1 - decay) * g2.mean(-1))
        st["vc"].copy_(decay * st["vc"] + (1 - decay) * g2.mean(-2))
        vr, vc = st["vr"], st["vc"]
        denom = torch.clamp(vr.mean(-1, keepdim=True), min=1e-30)
        vhat = (vr[..., None] * vc[..., None, :]) / denom[..., None]
        upd = g / torch.sqrt(vhat + 1e-30)
    else:
        st["v"].copy_(decay * st["v"] + (1 - decay) * g2)
        upd = g / torch.sqrt(st["v"] + 1e-30)
    rms = torch.sqrt((upd * upd).mean() + 1e-30)
    upd = upd / torch.clamp(rms, min=1.0)
    if p.dim() >= 2:
        upd = upd + cfg.weight_decay * p.float()
    return upd


# ---------------------------------------------------------------------------
# Unified interface
# ---------------------------------------------------------------------------
def make_optimizer(cfg: OptConfig, mesh=None):
    """Returns (init_fn, update_fn).  ``mesh``: the ranks' mesh, over which
    the clip norm is taken (``global_norm``).

    update_fn(grads, state, params, lr, frozen=None) -> (params, state,
    gnorm): ``params`` and ``state`` are updated in place and returned;
    ``frozen`` is an optional [S, L_max] mask zeroing the updates of stage
    params."""
    def init_fn(params):
        if cfg.name == "adamw":
            return adamw_init(params)
        if cfg.name == "adafactor":
            return adafactor_init(params, cfg.adafactor_min_dim)
        raise ValueError(cfg.name)

    @torch.no_grad()
    def update_fn(grads, state, params, lr, frozen=None):
        scale, gnorm = clip_scale(grads, cfg.clip_norm, mesh)
        t = state["count"] + 1
        flat_g = dict(_leaves(grads))
        for path, p in _leaves(params):
            g = flat_g[path].float() * scale
            if cfg.name == "adamw":
                upd = _adamw_update(cfg, g, _get(state["m"], path),
                                    _get(state["v"], path), p, t)
            else:
                upd = _adafactor_update(cfg, g, _get(state["f"], path), p, t)
            if frozen is not None and "stages" in path:
                keep = (1.0 - frozen).reshape(
                    frozen.shape + (1,) * (upd.dim() - 2))
                upd.mul_(keep)
            p.copy_((p.float() - upd.mul_(lr)).to(p.dtype))
        state["count"] = t
        return params, state, gnorm

    return init_fn, update_fn


def opt_spec(cfg: OptConfig, param_spec) -> Any:
    """The optimizer state's template for a tree of ``TensorSpec``s
    (shape, dtype) without allocating it: ``init_fn`` run on ``meta``
    tensors, its leaves turned back into specs — the reference's
    ``jax.eval_shape(init_fn, pspec)``.  Adafactor's factored ``vr`` /
    ``vc`` moments come out as its init makes them."""
    spec_type = type(next(p for _, p in _leaves(param_spec)))
    meta = _map(lambda _, s: torch.empty(s.shape, dtype=s.dtype,
                                         device="meta"), param_spec)
    init_fn, _ = make_optimizer(cfg)
    return _map(lambda _, t: spec_type(tuple(t.shape), t.dtype),
                init_fn(meta))


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree

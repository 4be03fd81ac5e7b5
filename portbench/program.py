"""The benchmark's one door into the program under test, ``repro_torch``
(the PyTorch and CUDA port): resolve a cell's RunSpec through the train
CLI, hand the program the benchmark's weights, run the training loop
(``repro_torch.launch.train.run``, which drives ``Session.train``), and
read what it produces.

The harness records its own spans around the calls into the loop's
layers by wrapping, for the length of one run, ``ElasticEngine.step``
(a step: forward, backward, AdamW) and the control plane's ``publish``
(a decision) and ``apply`` (a migration).  The step wrapper also sees the
engine state each step runs on, which is how the harness reads the
program's parameters, moments and masks between steps.  The migration
wrapper holds every logical layer's parameters, AdamW moments and prune
mask, and the step count, before a migration to what it hands back:
bit for bit, by exact checksums of the bits (``checksums``), so that the
check holds no second copy of the state.  Nothing is imported from the
program until a run asks for it."""
from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict, List, Optional

import torch

TOP = ("embed", "head", "final_norm")


def resolve_spec(argv: List[str], arch: Optional[Dict[str, Any]] = None):
    """The RunSpec the port's train CLI resolves from ``argv``.  ``arch``
    (a configuration file's ``"arch"``: ``name``, ``from``, ``set``)
    first registers, under a name of its own, the program's architecture
    ``from`` with the fields ``set`` changed: the model as its source
    publishes it, where the program's registry differs."""
    if arch is not None:
        import dataclasses
        from repro_torch.configs import get_config, register
        register(dataclasses.replace(get_config(arch["from"]),
                                     name=arch["name"], **arch["set"]))
    from repro_torch.api.cli import (TRAIN_ALIASES, TRAIN_CLI_DEFAULTS,
                                     build_spec)
    from repro_torch.launch.train import build_parser
    return build_spec(build_parser().parse_args(argv), TRAIN_ALIASES,
                      cli_defaults=TRAIN_CLI_DEFAULTS)


def model_shapes(spec, device) -> Dict[str, Any]:
    """The model as the program resolved it (its widths, to be held to
    the configuration's file), its parameter template (stacked
    [S, L_max, ...] specs), the stage buffers and the FFN's prune blocks
    a layer."""
    from repro_torch.api.session import Session
    from repro_torch.models import model as M
    s = Session(spec, device=device)
    cfg, dcfg = s._model_config(), s._dist_config()
    tmpl = M.param_spec(cfg, dcfg)
    if cfg.family != "dense":
        raise ValueError(f"{cfg.name}: the harness knows dense decoders "
                         f"only")
    widths = {"layers": cfg.total_blocks(), "d": cfg.d_model,
              "hq": cfg.num_heads, "hkv": cfg.num_kv_heads,
              "hd": cfg.resolved_head_dim, "ff": cfg.d_ff,
              "vocab": cfg.vocab_size, "theta": float(cfg.rope_theta),
              "eps": float(cfg.norm_eps), "tied": bool(cfg.tie_embeddings)}
    from repro_torch.models.blocks import n_prune_blocks
    return {"widths": widths, "template": tmpl, "stages": dcfg.num_stages,
            "npb": n_prune_blocks(cfg)}


def pack(W: Dict[str, torch.Tensor], shapes, lps: List[int]):
    """The program's parameter tree holding the benchmark's weights: the
    per-layer fields stacked [S, L_max, ...] by the contiguous split
    ``lps`` (empty slots zero), embed / head / final_norm as they are."""
    tmpl = shapes["template"]
    out = {k: W[k] for k in TOP if k in W}
    out.update(shared={}, stages={})
    for f, spec in tmpl["stages"].items():
        t = torch.zeros(spec.shape, dtype=spec.dtype,
                        device=W["embed"].device)
        i = 0
        for s, n in enumerate(lps):
            t[s, :n] = W[f][i:i + n]
            i += n
        out["stages"][f] = t
    return out


def layer_leaves(tree, lps: List[int]) -> Dict[str, torch.Tensor]:
    """{leaf: view} of a stacked tree (params or a moment) by the split
    ``lps``: ``embed``, ``head`` (untied only), ``final_norm``,
    ``layers.<i>.<field>``."""
    out = {k: tree[k] for k in TOP if k in tree}
    for f, t in tree["stages"].items():
        i = 0
        for s, n in enumerate(lps):
            for l in range(n):
                out[f"layers.{i}.{f}"] = t[s, l]
                i += 1
    return out


def layer_masks(dyn, lps: List[int]) -> torch.Tensor:
    """The FFN block mask by layer, [L, npb]."""
    m = dyn["ff_mask"]
    return torch.cat([m[s, :n] for s, n in enumerate(lps)])


BITS = {4: torch.int32, 2: torch.int16, 1: torch.int8}


def checksums(t: torch.Tensor, rows: int, chunk: int = 1 << 22
              ) -> torch.Tensor:
    """[rows, 2] int64: for each of ``t``'s ``rows`` (leading dims first),
    its elements' bits read as integers, summed and summed weighted by
    position (1, 2, ...), modulo 2**64.  A changed bit changes the first;
    two unequal elements swapped change the second.  Worked in chunks of
    ``chunk`` elements, so that it costs ~100 MB beside the state."""
    b = t.detach().contiguous().view(BITS[t.element_size()])
    b = b.reshape(rows, -1)
    n = b.shape[1]
    out = torch.zeros(rows, 2, dtype=torch.int64, device=t.device)
    by_r, by_c = max(1, chunk // n), min(n, chunk)
    for r in range(0, rows, by_r):
        for c0 in range(0, n, by_c):
            x = b[r:r + by_r, c0:c0 + by_c].to(torch.int64)
            w = torch.arange(c0 + 1, c0 + 1 + x.shape[1], device=t.device,
                             dtype=torch.int64)
            out[r:r + by_r, 0] += x.sum(1)
            out[r:r + by_r, 1] += (x * w).sum(1)
    return out


def carried(cp, params, opt_state, dyn) -> Dict[str, torch.Tensor]:
    """What a migration has to carry over unchanged, by logical layer
    (the controller's split): the parameters', AdamW's ``m``'s and
    ``v``'s ``checksums``, the prune mask and the step count."""
    lps = cp.with_ctrl(lambda c: list(c.lps))
    out = {"count": torch.as_tensor(opt_state["count"]).clone()}
    for name, tree in (("params", params), ("m", opt_state["m"]),
                       ("v", opt_state["v"])):
        sums = {k: checksums(tree[k], 1)[0] for k in TOP if k in tree}
        sums["stages"] = {}
        for f, t in tree["stages"].items():
            S, L_max = t.shape[:2]
            sums["stages"][f] = checksums(t, S * L_max).view(S, L_max, 2)
        for k, t in layer_leaves(sums, lps).items():
            out[f"{name}.{k}"] = t
        for k, t in tree.get("shared", {}).items():
            out[f"{name}.shared.{k}"] = checksums(t, 1)[0]
    if dyn is not None and "ff_mask" in dyn:
        for i, row in enumerate(layer_masks(dyn, lps).clone()):
            out[f"mask.{i}"] = row
    return out


class Recorder:
    """What the harness's spans saw in one run: per step the call's start
    and end on the host clock, its loss tensor, batch and the state it ran
    on; per decision its host seconds; per migration the entries of
    ``carried`` it changed, the split before and after and its seconds
    alone and with the check; in the traced
    steps every span on the wall clock."""

    def __init__(self, sync_steps: bool = False):
        self.sync_steps = sync_steps
        self.steps: List[Dict[str, Any]] = []
        # (host start, seconds) of each decision
        self.decides: List[tuple] = []
        # (entries changed, split before, split after, host seconds of
        # the migration alone and with its check) of each migration
        self.migrations: List[tuple] = []
        self.state = None
        # (start, end, name) on the wall clock (ns), while ``spans_on``
        self.spans_ns: List[tuple] = []
        self.spans_on = False

    def _span(self, start_ns: int, name: str) -> None:
        if self.spans_on:
            self.spans_ns.append((start_ns, time.time_ns(), name))

    @contextlib.contextmanager
    def installed(self):
        from repro_torch.cluster.service import ControlPlane
        from repro_torch.launch.engine import ElasticEngine
        rec = self
        step0, pub0, app0 = (ElasticEngine.step, ControlPlane.publish,
                             ControlPlane.apply)

        def step(engine, state, batch, lr):
            t0, n0 = time.perf_counter(), time.time_ns()
            out = step0(engine, state, batch, lr)
            if rec.sync_steps and torch.cuda.is_available():
                torch.cuda.synchronize()
            rec._span(n0, "step")
            rec.state = state
            rec.steps.append({"t0": t0, "t1": time.perf_counter(),
                              "loss": out[0] if out else None,
                              "tokens": batch["tokens"]})
            return out

        def publish(cp, snap):
            t0, n0 = time.perf_counter(), time.time_ns()
            out = pub0(cp, snap)
            rec.decides.append((t0, time.perf_counter() - t0))
            rec._span(n0, "decide")
            return out

        def apply(cp, plan, params, opt_state, dyn, *a, **kw):
            t_check = time.perf_counter()
            before = carried(cp, params, opt_state, dyn)
            lps0 = cp.with_ctrl(lambda c: list(c.lps))
            n0, t_apply = time.time_ns(), time.perf_counter()
            out = app0(cp, plan, params, opt_state, dyn, *a, **kw)
            t_apply = time.perf_counter() - t_apply
            rec._span(n0, "migrate")
            after = carried(cp, *out[:3])
            changed = sorted(set(before) ^ set(after)) + [
                k for k in before
                if k in after and not torch.equal(before[k], after[k])]
            rec.migrations.append((len(changed), lps0,
                                   cp.with_ctrl(lambda c: list(c.lps)),
                                   t_apply, time.perf_counter() - t_check))
            return out

        ElasticEngine.step, ControlPlane.publish, ControlPlane.apply = (
            step, publish, apply)
        try:
            yield self
        finally:
            ElasticEngine.step, ControlPlane.publish, ControlPlane.apply = (
                step0, pub0, app0)


def train(argv: List[str], params, on_step: Callable[[int, Any], None]):
    """The program's training entry, as its CLI runs it."""
    from repro_torch.launch.train import run
    return run(argv, params=params, on_step=on_step)

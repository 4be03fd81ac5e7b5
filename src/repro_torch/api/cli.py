"""Shared CLI adapter: one flag-builder for every entry point (the port's
copy of ``repro.api.cli``).

Both launchers (``repro_torch.launch.train``, ``repro_torch.launch.serve``)
build their argument surface from the same three ingredients, so the flag
set can never drift between them again:

  1. ``--config run.json`` / ``--set path=value`` / ``--dump-config`` —
     the spec-native interface (``add_config_args``);
  2. **auto-generated dotted flags**, one per ``RunSpec`` leaf field
     (``--controller.repack.policy first_fit``), derived from the spec
     dataclasses by reflection (``add_spec_flags``) — new spec fields
     become flags for free;
  3. a small per-CLI table of **legacy aliases** (``--stages`` ->
     ``parallel.stages``) kept for back-compat (``add_alias_flags``).

Precedence, lowest to highest: spec defaults < ``--config`` file <
per-CLI defaults for unset alias flags (only when no ``--config`` is
given, preserving each CLI's historical defaults) < explicitly passed
alias/dotted flags < ``--set`` overrides.

The alias tables and the per-CLI defaults are the reference's, so
``--dump-config`` prints the same JSON in both packages for every argv
both accept.  Two differences widen what the port accepts: the port's
own earlier flags (``--num-heads``, ``--slot-slack``, ``--in-step-timing``,
...) are one more alias list (``PORT_ALIASES``) appended to both tables,
and a dotted bool flag given bare (``--dynamics.expert_relayout``) means
true.  Like the reference's, both CLIs cut the arch to 8 layers unless
``--layers`` or ``--set model.layers=null`` (the full model) is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.api.specs import RunSpec, SpecError, leaf_fields

_SPEC_DEST_PREFIX = "spec__"


@dataclasses.dataclass(frozen=True)
class Alias:
    """One legacy flag mapped onto a spec leaf.  ``flag=True`` renders it
    as an argparse store_true switch; ``deprecated`` prints a warning on
    use."""
    opt: str                 # e.g. "--stages"
    path: str                # e.g. "parallel.stages"
    help: str = ""
    flag: bool = False
    choices: Optional[Sequence[str]] = None
    deprecated: Optional[str] = None   # replacement hint


def add_config_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--config", default=None, metavar="RUN.JSON",
                    help="load a RunSpec config file (see "
                         "configs/scenarios/ for presets)")
    ap.add_argument("--set", action="append", default=[], metavar="K=V",
                    dest="set_overrides",
                    help="dotted spec override, e.g. "
                         "--set controller.repack.policy=first_fit "
                         "(repeatable; highest precedence)")
    ap.add_argument("--dump-config", action="store_true",
                    help="print the resolved RunSpec JSON and exit "
                         "without running")


def add_spec_flags(ap: argparse.ArgumentParser) -> None:
    """One auto-generated option per spec leaf: ``--parallel.stages 8``.
    Values are strings here; typed coercion happens in ``RunSpec.override``
    so bools/Optionals parse the same as in ``--set``."""
    grp = ap.add_argument_group(
        "spec fields", "dotted overrides generated from RunSpec "
                       "(same semantics as --set PATH=VALUE)")
    for path, f in leaf_fields():
        if path == "schema_version":
            continue
        # a bare bool flag means true (``--dynamics.expert_relayout``)
        bare = {"nargs": "?", "const": "true"} if f.type is bool else {}
        try:
            grp.add_argument(
                f"--{path}", default=None, metavar="V",
                dest=_SPEC_DEST_PREFIX + path.replace(".", "__"),
                help=f"[{_type_name(f.type)}] default: {f.default}", **bare)
        except argparse.ArgumentError:
            # a dotless top-level leaf ("--seed") already covered by an
            # alias flag with the same spelling — the alias wins
            pass


def add_alias_flags(ap: argparse.ArgumentParser,
                    aliases: Sequence[Alias]) -> None:
    for a in aliases:
        kw: Dict[str, Any] = {"default": None, "help": a.help,
                              "dest": _alias_dest(a)}
        if a.flag:
            kw["action"] = "store_true"
            kw["default"] = None
        if a.choices:
            kw["choices"] = list(a.choices)
        ap.add_argument(a.opt, **kw)


def _alias_dest(a: Alias) -> str:
    return "alias__" + a.path.replace(".", "__")


def _type_name(t) -> str:
    return getattr(t, "__name__", None) or str(t).replace("typing.", "")


def build_spec(args: argparse.Namespace, aliases: Sequence[Alias],
               base: Optional[RunSpec] = None,
               cli_defaults: Optional[Dict[str, Any]] = None) -> RunSpec:
    """Resolve the final ``RunSpec`` from parsed args (see module docstring
    for precedence).  ``cli_defaults`` are this CLI's historical defaults
    where they differ from the spec's (e.g. the train CLI always ran a
    reduced 8-layer model); they apply only when no ``--config`` is given —
    a config file is the complete source of truth."""
    spec = base or RunSpec()
    if args.config:
        spec = RunSpec.load(args.config)
    overrides: Dict[str, Any] = {}
    if not args.config:
        overrides.update(cli_defaults or {})
    for a in aliases:
        v = getattr(args, _alias_dest(a), None)
        if v is not None:
            if a.deprecated:
                print(f"warning: {a.opt} is deprecated; {a.deprecated}",
                      file=sys.stderr)
            overrides[a.path] = v
    for path, f in leaf_fields():
        v = getattr(args, _SPEC_DEST_PREFIX + path.replace(".", "__"), None)
        if v is not None:
            overrides[path] = v
    for item in args.set_overrides:
        if "=" not in item:
            raise SpecError(f"--set expects PATH=VALUE, got {item!r}")
        path, _, value = item.partition("=")
        overrides[path.strip()] = value
    return spec.override(overrides) if overrides else spec


def maybe_dump(args: argparse.Namespace, spec: RunSpec) -> bool:
    if getattr(args, "dump_config", False):
        print(spec.to_json())
        return True
    return False


# ---------------------------------------------------------------------------
# Alias tables: the historical flag surfaces of the two CLIs.  Shared
# entries live in _COMMON so train/serve can't drift on them again.
# ---------------------------------------------------------------------------
_COMMON: List[Alias] = [
    Alias("--arch", "model.arch"),
    Alias("--layers", "model.layers",
          help="reduce the arch to this many layers (none = full size)"),
    Alias("--d-model", "model.d_model"),
    Alias("--stages", "parallel.stages"),
    Alias("--mb-global", "parallel.mb_global"),
    Alias("--dynamism", "dynamics.kind",
          help="dynamism scheme (spec field dynamics.kind)"),
    Alias("--kernel-impl", "parallel.kernel_impl",
          choices=["reference", "scan", "pallas"]),
    Alias("--measure-stage-times", "controller.measure_stage_times",
          flag=True,
          help="feed MEASURED per-stage wall times (engine stage probe) "
               "into the straggler detector / serve report"),
    Alias("--job-manager", "cluster.job_manager",
          choices=["inproc", "file", "http"],
          help="'file' puts the WorkerPool behind a file-RPC server in a "
               "separate process; 'http' behind the multi-tenant cluster "
               "scheduler's HTTP job manager"),
    Alias("--job-manager-dir", "cluster.job_manager_dir"),
    Alias("--tenant-id", "cluster.tenant_id",
          help="register this run as a cluster tenant (multi-tenant "
               "scheduling; requires --job-manager file|http)"),
    Alias("--priority", "cluster.priority",
          help="tenant priority — higher-priority tenants can steal "
               "workers from lower ones at their next safe point"),
    Alias("--manager-url", "cluster.manager_url",
          help="attach to an already-running HTTP job manager "
               "(http://host:port) instead of spawning one"),
    Alias("--chaos", "faults.enabled", flag=True,
          help="inject a seeded fault schedule (worker crashes, manager "
               "kills, RPC loss) — see faults.* fields and DESIGN.md §12"),
    Alias("--chaos-seed", "faults.seed",
          help="fault-schedule seed; same seed => byte-identical faults"),
    Alias("--spares", "cluster.spares",
          help="spare workers the job manager can grant beyond the "
               "initial pool (crash recovery headroom)"),
    Alias("--seed", "seed"),
    Alias("--log-every", "log_every"),
]

TRAIN_ALIASES: List[Alias] = _COMMON + [
    Alias("--steps", "steps"),
    Alias("--seq", "parallel.seq"),
    Alias("--num-micro", "parallel.num_micro"),
    Alias("--balancer", "controller.balancer",
          choices=["diffusion", "partition"]),
    Alias("--rebalance-every", "controller.rebalance_every"),
    Alias("--ckpt-dir", "ckpt_dir"),
    Alias("--ckpt-every", "ckpt_every",
          help="take a crash-safe safe point every N steps (resumable "
               "with Session.resume / --resume); needs --ckpt-dir"),
    Alias("--repack", "controller.repack.enabled", flag=True,
          help="enable live worker consolidation (paper Alg. 2)"),
    Alias("--repack-policy", "controller.repack.policy",
          choices=["adjacent", "first_fit"]),
    Alias("--repack-mem-cap", "controller.repack.mem_cap",
          help="per-worker memory budget as a multiple of the unpruned "
               "per-stage footprint"),
    Alias("--repack-target", "controller.repack.target",
          help="never consolidate below this many workers"),
    Alias("--grow-back", "cluster.grow_back",
          deprecated="use --autoscale (signal-driven re-expansion)",
          help="DEPRECATED: re-expand N steps after a shrink"),
    Alias("--async-controller", "controller.async_decide", flag=True,
          help="run profile->decide on a background thread "
               "(double-buffered stats mailbox, epoch-fenced plans)"),
    Alias("--async-drain", "controller.async_drain", flag=True,
          help="deterministic async mode: block for each decision "
               "(parity testing)"),
    Alias("--autoscale", "cluster.autoscale", flag=True,
          help="signal-driven shrink/grow: heartbeat failures/recoveries "
               "(+ throughput watermark with --autoscale-watermark)"),
    Alias("--autoscale-watermark", "cluster.autoscale_watermark", flag=True,
          help="also scale on the per-worker throughput watermark "
               "(wall-clock based — leave off on noisy shared machines)"),
    Alias("--heartbeat-timeout", "cluster.heartbeat_timeout",
          help="missed-beat timeout in steps (simulated clock)"),
    Alias("--simulate-recover", "cluster.simulate_recover",
          help="revive all non-active workers at this step "
               "(heartbeat-recovery demo)"),
    Alias("--straggler", "controller.straggler",
          help="simulate slow workers, e.g. '2:1.5' (worker 2 runs 1.5x "
               "slow); the detector feeds the balancer"),
]

# the train CLI's historical defaults where they differ from the spec's
TRAIN_CLI_DEFAULTS: Dict[str, Any] = {"model.layers": 8}

# the port's own earlier flags (its CLIs built their flag sets by hand
# before this module), kept so no argv of the port stops parsing
PORT_ALIASES: List[Alias] = [
    Alias("--num-heads", "model.num_heads"),
    Alias("--num-kv-heads", "model.num_kv_heads"),
    Alias("--d-ff", "model.d_ff", help="default 2 * d_model"),
    Alias("--vocab-size", "model.vocab_size"),
    Alias("--slot-slack", "parallel.slot_slack"),
    Alias("--remat", "parallel.remat", choices=["none", "block", "full"]),
    Alias("--param-dtype", "parallel.param_dtype",
          choices=["float32", "bfloat16"]),
    Alias("--in-step-timing", "obs.in_step_timing", flag=True,
          help="time each stage inside the live step (CUDA events on the "
               "card)"),
    Alias("--rpc-timeout-s", "cluster.rpc_timeout_s",
          help="file / HTTP job-manager client: total retry budget per "
               "call"),
]
TRAIN_ALIASES += PORT_ALIASES


def add_dist_args(ap: argparse.ArgumentParser) -> None:
    """The port's process-layout flags (not spec fields: ``--dump-config``
    prints the same RunSpec with or without them)."""
    ap.add_argument("--procs", type=int, default=1,
                    help="run as N processes, one per cell of the "
                         "parallel.data x parallel.stages mesh of ranks "
                         "(torch.distributed); N must equal data x stages")
    ap.add_argument("--dist-backend", default=None,
                    choices=["gloo", "nccl"],
                    help="force the ranks' backend (default: nccl when "
                         "every rank has a card of its own, else gloo "
                         "through host copies); nccl on a shared card "
                         "raises")

SERVE_ALIASES: List[Alias] = _COMMON + [
    Alias("--micro", "parallel.num_micro"),
    Alias("--prompt-len", "serve.prompt_len"),
    Alias("--gen", "serve.gen"),
    Alias("--requests", "serve.requests"),
    Alias("--min-prompt", "serve.min_prompt"),
    Alias("--burst-period", "serve.burst_period"),
    Alias("--burst-len", "serve.burst_len"),
    Alias("--burst-rate", "serve.burst_rate"),
    Alias("--lull-rate", "serve.lull_rate"),
    Alias("--early-exit-frac", "serve.early_exit_frac"),
    Alias("--defrag-every", "serve.defrag_every"),
    Alias("--autoscale", "cluster.autoscale", flag=True,
          help="queue-depth/occupancy watermark scaling"),
    Alias("--min-stages", "serve.min_stages"),
    Alias("--queue-high", "serve.queue_high"),
    Alias("--occupancy-low", "serve.occupancy_low"),
    Alias("--patience", "serve.patience"),
    Alias("--cooldown", "serve.cooldown"),
    Alias("--latency-slo-s", "serve.latency_slo_s"),
    Alias("--max-ticks", "serve.max_ticks"),
    Alias("--kv-page-size", "serve.kv_page_size",
          help="tokens per KV block; >0 switches serving to the paged KV "
               "subsystem (0 = dense contiguous lanes)"),
    Alias("--kv-pool-pages", "serve.kv_pool_pages",
          help="physical KV blocks in the pool (0 = dense-equivalent "
               "auto-size)"),
    Alias("--prefix-cache", "serve.prefix_cache", flag=True,
          help="share full prompt pages across requests with a common "
               "prefix (copy-on-write; requires --kv-page-size)"),
    Alias("--temperature", "serve.temperature",
          help="per-lane decode sampling temperature (0 = argmax)"),
]

SERVE_ALIASES += PORT_ALIASES

# the serve CLI's historical defaults where they differ from the spec's
SERVE_CLI_DEFAULTS: Dict[str, Any] = {"model.layers": 8,
                                      "parallel.num_micro": 2}

"""Serving CLI of the port — ``repro.launch.serve --elastic`` and
``Session.serve``.

  python -m repro_torch.launch.serve --elastic --stages 1 --micro 2 \\
      --mb-global 4 --prompt-len 1024 --gen 32 --requests 12 \\
      --kv-page-size 16 --prefix-cache --dynamism sparse_attention \\
      --kernel-impl pallas

Flag names are the reference's (``repro.api.cli``).  The model is built as
``Session._model_config`` builds it: the registry config at full size, or
``reduced_config`` when ``--layers`` is given (the reference's serve CLI
reduces to 8 layers by default; this one serves the full model unless
asked).  The KV pool is sized as ``Session.serve`` sizes it.  The run is on
the CUDA card unless ``--device cpu``.  Flags of features outside the port
so far raise ``NotImplementedError`` naming their ROADMAP item.

``--temperature T`` samples every lane (a counter-based sampler seeded per
request and position); ``--autoscale`` lets the load signals (queue depth,
lane and page occupancy) shrink and grow the stage
buffers between ticks; ``--job-manager file|http`` puts the worker pool
behind a manager process, and ``--tenant-id`` / ``--priority`` register
the server as a tenant of a shared HTTP manager (``--manager-url``): it
starts on ``--min-stages`` workers, an urgent grow steals from a
lower-priority tenant, a shrink yields workers back.

  python -m repro_torch.launch.serve --elastic --stages 4 --autoscale \
      --min-stages 2 --requests 24 --burst-period 16 --burst-len 4
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, List, Optional

from repro_torch.cluster.autoscaler import Autoscaler, AutoscalerConfig
from repro_torch.configs.base import DistConfig, get_config, reduced_config
from repro_torch.dynamics.config import DynamicsConfig
from repro_torch.launch import cluster
from repro_torch.pipeline.pipeline import PipelineShapes
from repro_torch.serve.kv import PagedKVConfig
from repro_torch.serve.requests import make_trace
from repro_torch.serve.server import ElasticServer


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="DynMo continuous-batching serving on the PyTorch/CUDA "
                    "port")
    a = ap.add_argument
    a("--elastic", action="store_true",
      help="serve a request trace through the continuous-batching "
           "scheduler (the only serving path of the port)")
    # model (spec fields model.*)
    a("--arch", default="smollm-360m")
    a("--layers", type=int, default=None,
      help="reduce the arch to this many layers (default: full size)")
    a("--d-model", type=int, default=128)
    a("--num-heads", type=int, default=4)
    a("--num-kv-heads", type=int, default=2)
    a("--d-ff", type=int, default=None, help="default 2 * d_model")
    a("--vocab-size", type=int, default=512)
    # parallel.*
    a("--stages", type=int, default=4)
    a("--micro", type=int, default=2, dest="num_micro")
    a("--mb-global", type=int, default=4)
    a("--slot-slack", type=int, default=2)
    a("--param-dtype", default="float32", choices=["float32", "bfloat16"])
    a("--kernel-impl", default="scan",
      choices=["reference", "scan", "pallas"])
    a("--dynamism", default="none",
      help="dynamism scheme (none | moe | pruning | freezing | "
           "sparse_attention | early_exit | mod)")
    a("--dynamics.ee_threshold", dest="ee_threshold", type=float,
      default=0.98, help="early exit: cosine of a block's input and "
                         "output above which a token exits")
    # serve.*
    a("--requests", type=int, default=16)
    a("--prompt-len", type=int, default=32)
    a("--gen", type=int, default=8)
    a("--min-prompt", type=int, default=None)
    a("--burst-period", type=int, default=0)
    a("--burst-len", type=int, default=0)
    a("--burst-rate", type=int, default=4)
    a("--lull-rate", type=int, default=1)
    a("--early-exit-frac", type=float, default=0.0)
    a("--defrag-every", type=int, default=0)
    a("--max-ticks", type=int, default=100000)
    a("--kv-page-size", type=int, default=0,
      help="tokens per KV block; >0 switches to the paged KV pool")
    a("--kv-pool-pages", type=int, default=0,
      help="physical KV blocks (0 = dense-equivalent auto-size)")
    a("--prefix-cache", action="store_true",
      help="share full prompt pages across requests (copy-on-write)")
    a("--temperature", type=float, default=0.0,
      help="per-lane decode sampling temperature (0 = argmax)")
    a("--seed", type=int, default=0)
    # serve.* autoscaling (the reference's serve spec fields)
    a("--autoscale", action="store_true",
      help="queue-depth / occupancy watermark scaling")
    a("--min-stages", type=int, default=1)
    a("--queue-high", type=int, default=8)
    a("--occupancy-low", type=float, default=0.35)
    a("--patience", type=int, default=2)
    a("--cooldown", type=int, default=4)
    cluster.add_cluster_flags(ap)
    # outside the port so far: accepted so it fails loudly, never ignored
    a("--chaos", action="store_true")
    # port-only
    a("--device", default=None, help="cuda (default) or cpu")
    return ap


def _reject_unported(args) -> None:
    if not args.elastic:
        raise NotImplementedError(
            "the port serves through --elastic only; the legacy one-shot "
            "generator is not ported (ROADMAP Queue 1 [faults-obs])")
    if args.chaos:
        raise NotImplementedError(
            "fault injection is not in repro_torch yet (ROADMAP Queue 1 "
            "[faults-obs])")


def model_config(args):
    """The model as ``Session._model_config`` builds it."""
    cfg = get_config(args.arch)
    if args.layers is not None:
        cfg = reduced_config(cfg, num_layers=args.layers,
                             d_model=args.d_model, num_heads=args.num_heads,
                             num_kv_heads=args.num_kv_heads,
                             d_ff=args.d_ff or 2 * args.d_model,
                             vocab_size=args.vocab_size)
    return cfg


def build_server(args, params=None, job_manager=None,
                 initial_workers=None) -> (ElasticServer, list):
    """(server, trace) for parsed args, as ``Session.serve`` assembles
    them; ``params`` (a converted reference tree) replaces the engine's own
    init; ``job_manager`` (a client) and ``initial_workers`` (a tenant's
    grant) come from ``run``'s connection."""
    _reject_unported(args)
    if args.temperature < 0:
        raise ValueError(f"--temperature must be >= 0, got "
                         f"{args.temperature}")
    cfg = model_config(args)
    dcfg = DistConfig(num_stages=args.stages, slot_slack=args.slot_slack,
                      remat="none", param_dtype=args.param_dtype,
                      kernel_impl=args.kernel_impl)
    dyncfg = DynamicsConfig(kind=args.dynamism,
                            ee_threshold=args.ee_threshold)
    shapes = PipelineShapes(args.num_micro, args.mb_global, args.prompt_len,
                            cache_len=args.prompt_len + args.gen)
    paged = None
    if args.kv_page_size > 0:
        # 0 auto-sizes the pool to the dense-equivalent footprint
        lanes = args.num_micro * args.mb_global
        pool = args.kv_pool_pages or lanes * (shapes.cache_len
                                              // args.kv_page_size)
        paged = PagedKVConfig(page_size=args.kv_page_size, pool_pages=pool,
                              prefix_cache=args.prefix_cache)
    trace = make_trace(args.requests, prompt_len=args.prompt_len,
                       max_gen=args.gen, vocab_size=cfg.vocab_size,
                       seed=args.seed,
                       min_prompt=args.min_prompt or max(
                           1, args.prompt_len // 2),
                       burst_period=args.burst_period,
                       burst_len=args.burst_len, burst_rate=args.burst_rate,
                       lull_rate=args.lull_rate,
                       early_exit_frac=args.early_exit_frac)
    scaler = None
    if args.autoscale:
        scaler = Autoscaler(AutoscalerConfig(
            min_stages=max(1, args.min_stages), max_stages=args.stages,
            patience=args.patience, cooldown=args.cooldown,
            queue_high=args.queue_high, occupancy_low=args.occupancy_low))
    srv = ElasticServer(cfg, dcfg, dyncfg, shapes, seed=args.seed,
                        job_manager=job_manager, scaler=scaler,
                        min_stages=args.min_stages,
                        initial_workers=initial_workers,
                        defrag_every=args.defrag_every, paged=paged,
                        temperature=args.temperature, device=args.device,
                        params=params)
    return srv, trace


def run(argv: Optional[List[str]] = None, *, params=None,
        resize_at: Optional[Dict[int, int]] = None) -> Dict[str, Any]:
    """Parse ``argv``, serve the trace, return the server's report (with
    the reference's ``degraded_events`` and ``rpc`` keys and the
    ``session_events`` stream).  ``params`` (a converted reference tree) replaces
    the engine's own init; ``resize_at`` scripts {tick: stages} resizes."""
    args = build_parser().parse_args(argv)
    _reject_unported(args)
    cluster.check_cluster_flags(args)
    log = cluster.EventLog()
    jm = cluster.connect(args.job_manager, workers=args.stages,
                         spares=args.spares,
                         job_manager_dir=args.job_manager_dir,
                         manager_url=args.manager_url,
                         rpc_timeout_s=args.rpc_timeout_s)
    srv = None
    try:
        # multi-tenant: start on the scheduler's grant (min_stages: serve
        # small, steal under load) instead of the maximum
        granted = cluster.register_tenant(
            jm, args.tenant_id, priority=args.priority, kind="serve",
            workers=args.min_stages, max_workers=args.stages,
            min_workers=args.min_stages, log=log)
        srv, trace = build_server(args, params, jm.client, granted)
        report = srv.serve(trace, max_ticks=args.max_ticks,
                           resize_at=resize_at, autoscale=args.autoscale)
    finally:
        jm.close(srv.engine if srv is not None else None)
    report["degraded_events"] = list(srv.engine.degraded_events)
    report["rpc"] = ({"stats": dict(jm.client.rpc_stats),
                      "breaker": jm.client.breaker.state_dict()}
                     if jm.client is not None else None)
    for rz in report["resizes"]:
        log.emit("resize", rz["step"], resize_kind=rz["kind"],
                 from_stages=rz["from_stages"], to_stages=rz["to_stages"],
                 workers=list(rz["workers"]))
        if granted is not None and rz["kind"] == "shrink":
            # a tenant-scoped release is a yield: the freed workers go
            # back through the scheduler to whoever is owed or offered
            log.emit("yield", rz["step"], workers=list(rz["workers"]),
                     tenant=args.tenant_id)
    for d in report["autoscale_decisions"]:
        log.emit("autoscale", d["step"], action=d["action"],
                 workers=d["workers"], reason=d["reason"], ids=list(d["ids"]))
        if granted is not None and d["action"] == "grow" and d["urgent"]:
            log.emit("steal", d["step"], workers=d["workers"],
                     reason=d["reason"], tenant=args.tenant_id)
    log.emit("serve_summary", report["ticks"],
             completions=len(report["completions"]),
             total_tokens=report["total_tokens"],
             tokens_per_s=report["tokens_per_s"],
             latency_p95_s=report["latency_p95_s"])
    report["session_events"] = log.events
    if args.events_out:
        log.write(args.events_out)
    report["args"] = vars(args)
    return report


def main(argv: Optional[List[str]] = None) -> None:
    rep = run(argv)
    print(f"served {len(rep['completions'])} requests / "
          f"{rep['total_tokens']} tokens in {rep['wall_s']:.1f}s "
          f"({rep['tokens_per_s']:.1f} tok/s); p50/p95 token latency "
          f"{rep['latency_p50_s'] * 1e3:.0f}/"
          f"{rep['latency_p95_s'] * 1e3:.0f}ms; "
          f"stages {rep['stages_history'][0]}; resizes "
          f"{[r['kind'] for r in rep['resizes']]}")


if __name__ == "__main__":
    main()

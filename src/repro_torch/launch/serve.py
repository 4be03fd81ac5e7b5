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
the CUDA card unless ``--device cpu``.  Flags of features outside this
slice raise ``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, List, Optional

from repro_torch.configs.base import DistConfig, get_config, reduced_config
from repro_torch.dynamics.config import DynamicsConfig
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
    a("--temperature", type=float, default=0.0)
    a("--seed", type=int, default=0)
    # outside this slice: accepted so they fail loudly, never ignored
    a("--autoscale", action="store_true")
    a("--job-manager", default="inproc")
    a("--chaos", action="store_true")
    # port-only
    a("--device", default=None, help="cuda (default) or cpu")
    return ap


def _reject_unported(args) -> None:
    if not args.elastic:
        raise NotImplementedError(
            "the port serves through --elastic only; the legacy one-shot "
            "generator is not ported (ROADMAP Queue 1 [faults-obs])")
    if args.autoscale or args.job_manager != "inproc":
        raise NotImplementedError(
            "autoscaling and job managers are not in repro_torch yet "
            "(ROADMAP Queue 1 [cluster])")
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


def build_server(args, params=None) -> (ElasticServer, list):
    """(server, trace) for parsed args, as ``Session.serve`` assembles
    them; ``params`` (a converted reference tree) replaces the engine's own
    init."""
    _reject_unported(args)
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
    srv = ElasticServer(cfg, dcfg, dyncfg, shapes, seed=args.seed,
                        defrag_every=args.defrag_every, paged=paged,
                        temperature=args.temperature, device=args.device,
                        params=params)
    return srv, trace


def run(argv: Optional[List[str]] = None, *, params=None) -> Dict[str, Any]:
    """Parse ``argv``, serve the trace, return the server's report.
    ``params`` (a converted reference tree) replaces the engine's own
    init."""
    args = build_parser().parse_args(argv)
    srv, trace = build_server(args, params)
    report = srv.serve(trace, max_ticks=args.max_ticks)
    report["args"] = vars(args)
    return report


def main(argv: Optional[List[str]] = None) -> None:
    rep = run(argv)
    print(f"served {len(rep['completions'])} requests / "
          f"{rep['total_tokens']} tokens in {rep['wall_s']:.1f}s "
          f"({rep['tokens_per_s']:.1f} tok/s); p50/p95 token latency "
          f"{rep['latency_p50_s'] * 1e3:.0f}/"
          f"{rep['latency_p95_s'] * 1e3:.0f}ms; "
          f"stages {rep['stages_history'][0]}")


if __name__ == "__main__":
    main()

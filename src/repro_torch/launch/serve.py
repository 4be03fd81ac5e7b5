"""Serving CLI of the port — a thin adapter over ``repro_torch.api`` plus
the legacy oracle, as ``repro.launch.serve`` is over ``repro.api``:

  * ``run_elastic_serving`` / ``--elastic`` (or ``--config``) — the
    continuous-batching server on elastic engine worlds.  The lifecycle
    lives in ``Session.serve``; the kwarg entry point is the reference's
    deprecation shim that builds the equivalent ``RunSpec``
    (``serve_spec``), so flag path, config path and Python API produce
    identical runs.
  * ``run_serving`` — the legacy one-shot generator (one fixed batch,
    prefill + ``gen`` decode rounds, an optional DynMo rebalance between
    rounds); kept as the parity oracle of the continuous scheduler: a full
    batch arriving at once through ``ElasticServer`` gives its tokens.
    With ``procs`` (``--procs N``) it runs as N ranks of a ``data x
    stages`` mesh (``launch.dist``): each rank holds its stage's rows of
    the params and of the KV cache, and every rank gets the tokens.

Like the reference's, the CLI cuts the arch to 8 layers unless
``--layers N`` or ``--set model.layers=null`` (the full model) is given.
It runs on the CUDA card unless ``--device cpu``.

  python -m repro_torch.launch.serve --elastic --set model.layers=null \\
      --stages 1 --micro 2 --mb-global 4 --prompt-len 1024 --gen 32 \\
      --requests 12 --kv-page-size 16 --prefix-cache \\
      --dynamism sparse_attention --kernel-impl pallas
  python -m repro_torch.launch.serve --elastic --device cpu --stages 4 \\
      --autoscale --min-stages 2 --requests 24 --burst-period 16 \\
      --burst-len 4
  python -m repro_torch.launch.serve --device cpu --layers 8 --gen 16
  python -m repro_torch.launch.serve --device cpu --procs 4 --stages 4 \\
      --layers 8 --gen 16
  python -m repro_torch.launch.serve --elastic --device cpu --procs 4 \\
      --stages 4 --kv-page-size 4 --requests 8

With ``--elastic``, ``--procs N`` runs the elastic server as N ranks, one
per stage (``--stages N``, data 1): each rank holds its stage's rows of
the paged KV pool and runs its layers' decode attention.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.api.cli import (SERVE_ALIASES, SERVE_CLI_DEFAULTS,
                                 add_alias_flags, add_config_args,
                                 add_dist_args, add_spec_flags, build_spec,
                                 maybe_dump)
from repro_torch.api.session import Session
from repro_torch.api.specs import (ClusterSpec, ControllerSpec, DynamicsSpec,
                                   ModelSpec, ParallelSpec, RunSpec,
                                   ServeSpec)


def run_serving(arch: str, *, stages: int = 4, micro: int = 2,
                mb_global: int = 4, prompt_len: int = 32, gen: int = 8,
                layers: Optional[int] = 8, d_model: int = 128,
                dynamism: str = "none", rebalance_every: int = 0,
                seed: int = 0, kernel_impl: str = "scan",
                param_dtype: str = "float32", device=None,
                params=None, procs: int = 1, data: int = 1,
                dist_backend: Optional[str] = None,
                mesh=None) -> Dict[str, Any]:
    """One fixed batch of ``micro`` x ``mb_global`` prompts (drawn from
    ``np.random.RandomState(seed)``): a prefill, then ``gen - 1`` decode
    rounds at one shared position, with a serving-time rebalance every
    ``rebalance_every`` rounds (the survival-curve cost vector through
    ``DynMoController.decide / apply``, which migrates the cache too).
    ``params`` (a converted reference tree) replaces the init, which
    draws from a torch generator seeded with ``seed`` as the engine's
    does.  Returns the tokens [micro, mb_global, gen], the wall seconds,
    tokens/s, the final split and, for an MoE arch, ``moe_drop_sum``: the
    capacity-drop fractions summed over the prefill's and every decode's
    stage calls (None otherwise).

    ``procs`` > 1 runs it as that many ranks (``data x stages`` of them;
    ``dist_backend`` forces the backend) and returns rank 0's result with
    every rank's counters under ``ranks``; ``mesh`` is a rank's own call."""
    import torch
    if procs > 1 and mesh is None:
        if data * stages != procs:
            raise ValueError(
                f"data x stages = {data} x {stages} = {data * stages} "
                f"ranks, but procs={procs}")
        from repro_torch.configs import get_config
        from repro_torch.launch.dist import launch
        kw = dict(arch=arch, arch_config=get_config(arch), stages=stages,
                  micro=micro, mb_global=mb_global, prompt_len=prompt_len,
                  gen=gen,
                  layers=layers, d_model=d_model, dynamism=dynamism,
                  rebalance_every=rebalance_every, seed=seed,
                  kernel_impl=kernel_impl, param_dtype=param_dtype,
                  params=params)
        res = launch("repro_torch.launch.serve:rank_serve", procs,
                     data=data, device=torch.device(
                         "cuda" if device is None else device).type,
                     backend=dist_backend, kwargs=kw)
        out = dict(res[0])
        out["ranks"] = [r["rank"] for r in res]
        return out

    from repro_torch.configs import DistConfig, get_config, reduced_config
    from repro_torch.core.controller import ControllerConfig, DynMoController
    from repro_torch.core.cost_model import LayerDynState, cost_vector
    from repro_torch.core.profiler import LayerProfile
    from repro_torch.device import resolve_device
    from repro_torch.dynamics.config import DynamicsConfig
    from repro_torch.launch.engine import _check_tree, _to
    from repro_torch.models import blocks as B
    from repro_torch.models import model as M
    from repro_torch.pipeline.pipeline import (PipelineShapes,
                                               build_decode_fn,
                                               build_prefill_fn)

    dev = resolve_device(device) if mesh is None else mesh.device
    cfg = get_config(arch)
    if layers is not None:
        cfg = reduced_config(cfg, num_layers=layers, d_model=d_model,
                             num_heads=4, num_kv_heads=2, d_ff=2 * d_model,
                             vocab_size=512)
    dcfg = DistConfig(num_stages=stages, slot_slack=2, remat="none",
                      param_dtype=param_dtype, kernel_impl=kernel_impl)
    dyncfg = DynamicsConfig(kind=dynamism)
    M.check_ported(cfg, dyncfg)
    cache_len = prompt_len + gen
    shapes = PipelineShapes(micro, mb_global, prompt_len,
                            cache_len=cache_len)
    if params is None:
        params = M.init_params(torch.Generator(device=dev).manual_seed(seed),
                               cfg, dcfg, dev)
    else:
        _check_tree(params, M.param_spec(cfg, dcfg))
        params = _to(params, dev)
    lanes_mb = mb_global
    if mesh is not None:
        from repro_torch.launch.sharding import (lanes, local_params,
                                                 local_rows)
        params = local_params(params, mesh)
        sl = lanes(mesh, mb_global)
        lanes_mb = sl.stop - sl.start
    hash_proj = (B.default_hash_projection(cfg.d_model,
                                           dyncfg.sparse_nbuckets, dev)
                 if dyncfg.uses_sparse_attention else None)
    assignment = M.make_assignment(cfg, dcfg)
    dyn = M.init_dyn(cfg, dcfg, dyncfg, dev)
    if mesh is None:
        cache = M.init_cache(cfg, dcfg, micro, mb_global, cache_len, dev)
    else:
        # this rank's row of its replica's lanes only
        dyn = local_rows(dyn, mesh)
        cache = {k: torch.zeros((1,) + tuple(sp.shape[1:]), dtype=sp.dtype,
                                device=dev)
                 for k, sp in M.cache_spec(cfg, dcfg, micro, lanes_mb,
                                           cache_len).items()}
    prefill = build_prefill_fn(cfg, dcfg, dyncfg, shapes,
                               hash_proj=hash_proj, mesh=mesh)
    decode = build_decode_fn(cfg, dcfg, dyncfg, shapes, hash_proj=hash_proj,
                             mesh=mesh)
    ctrl = DynMoController(
        cfg, dcfg, dyncfg,
        ControllerConfig(method="partition", cost_by="time",
                         rebalance_every=max(1, rebalance_every)),
        mesh=mesh)

    rng = np.random.RandomState(seed)
    tokens = torch.as_tensor(
        rng.randint(0, cfg.vocab_size, (micro, mb_global, prompt_len)),
        dtype=torch.int32, device=dev)
    outs = []
    t0 = time.perf_counter()
    with torch.no_grad():
        ids, cache, drop = prefill(params, assignment, dyn, cache,
                                   {"tokens": tokens})
        outs.append(ids.cpu().numpy())
        for g in range(1, gen):
            pos = torch.tensor(prompt_len + g - 1, device=dev)
            ids, _, cache, d = decode(params, assignment, dyn, cache, ids,
                                      pos)
            drop = drop + d
            outs.append(ids.cpu().numpy())
            if rebalance_every and g % rebalance_every == 0:
                # serving-time profile: the survival-curve cost vector
                L = cfg.total_blocks()
                states = [LayerDynState() for _ in range(L)]
                t = cost_vector(cfg, mb_global, prompt_len + g, states,
                                by="time")
                prof = LayerProfile(
                    t, cost_vector(cfg, mb_global, prompt_len + g, states,
                                   by="param") * dcfg.bytes_per_param,
                    np.zeros(stages), states)
                new_lps, ev = ctrl.decide(prof, g)
                if new_lps is not None:
                    params, _, dyn, assignment, cache = ctrl.apply(
                        new_lps, params, None, dyn, cache)
    wall = time.perf_counter() - t0
    gen_tokens = np.stack(outs, axis=-1)
    tps = micro * mb_global * gen / wall
    return {"tokens": gen_tokens, "wall_s": wall, "tokens_per_s": tps,
            "final_lps": ctrl.lps,
            "moe_drop_sum": float(drop) if cfg.num_experts else None}


def rank_serve(mesh, arch_config=None, **kw) -> Dict[str, Any]:
    """One rank of ``run_serving(procs=N)`` (run by ``launch.dist``);
    ``arch_config`` as ``rank_train``'s ``arch``."""
    import torch

    from repro_torch.launch.dist import (ensure_arch, foreign_modules,
                                         launch_counts)
    ensure_arch(arch_config)
    cuda = mesh.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(mesh.device)
    out = run_serving(mesh=mesh, **kw)
    out["rank"] = {"rank": mesh.rank, "stage": mesh.stage,
                   "replica": mesh.replica, "device": str(mesh.device),
                   "backend": mesh.backend, "launches": launch_counts(),
                   "peak_allocated": (torch.cuda.max_memory_allocated(
                       mesh.device) if cuda else None),
                   "comm": dict(mesh.comm.stats),
                   "foreign_modules": foreign_modules()}
    return out


def serve_spec(arch: str, *, stages: int = 4, micro: int = 2,
               mb_global: int = 4, prompt_len: int = 32,
               gen: int = 8, layers: Optional[int] = 8,
               d_model: int = 128, dynamism: str = "none",
               requests: int = 16, min_prompt: Optional[int] = None,
               burst_period: int = 0, burst_len: int = 0,
               burst_rate: int = 4, lull_rate: int = 1,
               early_exit_frac: float = 0.0, seed: int = 0,
               autoscale: bool = False, min_stages: int = 1,
               queue_high: int = 8, occupancy_low: float = 0.35,
               patience: int = 2, cooldown: int = 4,
               defrag_every: int = 0, job_manager: str = "inproc",
               job_manager_dir: Optional[str] = None,
               tenant_id: Optional[str] = None, priority: int = 0,
               manager_url: Optional[str] = None,
               latency_slo_s: float = 0.0,
               kernel_impl: str = "scan",
               measure_stage_times: bool = False,
               max_ticks: int = 100000,
               kv_page_size: int = 0, kv_pool_pages: int = 0,
               prefix_cache: bool = False,
               temperature: float = 0.0) -> RunSpec:
    """The ``RunSpec`` equivalent of the legacy ``run_elastic_serving``
    kwargs — the single place the old vocabulary maps onto the schema."""
    return RunSpec(
        model=ModelSpec(arch=arch, layers=layers, d_model=d_model),
        parallel=ParallelSpec(stages=stages, num_micro=micro,
                              mb_global=mb_global,
                              kernel_impl=kernel_impl),
        dynamics=DynamicsSpec(kind=dynamism),
        controller=ControllerSpec(measure_stage_times=measure_stage_times),
        cluster=ClusterSpec(job_manager=job_manager,
                            job_manager_dir=job_manager_dir,
                            autoscale=autoscale, tenant_id=tenant_id,
                            priority=priority, manager_url=manager_url),
        serve=ServeSpec(requests=requests, prompt_len=prompt_len, gen=gen,
                        min_prompt=min_prompt, burst_period=burst_period,
                        burst_len=burst_len, burst_rate=burst_rate,
                        lull_rate=lull_rate,
                        early_exit_frac=early_exit_frac,
                        defrag_every=defrag_every,
                        min_stages=max(1, min_stages),
                        queue_high=queue_high,
                        occupancy_low=occupancy_low, patience=patience,
                        cooldown=cooldown, latency_slo_s=latency_slo_s,
                        max_ticks=max_ticks, kv_page_size=kv_page_size,
                        kv_pool_pages=kv_pool_pages,
                        prefix_cache=prefix_cache, temperature=temperature),
        seed=seed)


def run_elastic_serving(arch: str, *, resize_at=None, device=None,
                        params=None, **kwargs) -> Dict[str, Any]:
    """Legacy kwarg entry point (deprecation shim).

    Builds the equivalent ``RunSpec`` and serves it through a ``Session``
    — new code should do that directly:

        with Session(serve_spec(arch, ...), device=device) as s:
            report = s.serve()
    """
    spec = serve_spec(arch, **kwargs)
    with Session(spec, device=device, params=params) as s:
        return s.serve(resize_at=resize_at)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="DynMo serving on the PyTorch/CUDA port (config-first: "
                    "--config RUN.JSON; flags below override spec fields)")
    ap.add_argument("--elastic", action="store_true",
                    help="serve a request trace through the continuous-"
                         "batching scheduler on elastic engine worlds")
    ap.add_argument("--rebalance-every", type=int, default=0,
                    help="legacy one-shot path only: DynMo rebalance "
                         "between decode rounds")
    ap.add_argument("--events-out", default=None, metavar="PATH",
                    help="write the session's structured telemetry stream "
                         "(one JSON record per resize / autoscale / "
                         "tenant_register / steal / yield event) to this "
                         "file")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    add_dist_args(ap)
    add_config_args(ap)
    add_alias_flags(ap, SERVE_ALIASES)
    add_spec_flags(ap)
    return ap


def run(argv: Optional[List[str]] = None, *, params=None,
        resize_at: Optional[Dict[int, int]] = None
        ) -> Optional[Dict[str, Any]]:
    """Resolve the spec of ``argv`` and serve it: through ``Session.serve``
    with ``--elastic`` or ``--config`` (the report gains the event stream
    as ``session_events``; ``resize_at`` scripts {tick: stages} resizes),
    else through the one-shot ``run_serving``.  ``params`` (a converted
    reference tree) replaces the init.  None after ``--dump-config``."""
    args = build_parser().parse_args(argv)
    spec = build_spec(args, SERVE_ALIASES, cli_defaults=SERVE_CLI_DEFAULTS)
    if maybe_dump(args, spec):
        return None
    if args.elastic or args.config:
        with Session(spec, device=args.device, params=params,
                     procs=args.procs, dist_backend=args.dist_backend) as s:
            rep = s.serve(resize_at=resize_at)
        rep["session_events"] = [dataclasses.asdict(e) for e in s.events]
        if args.events_out:
            s.write_events(args.events_out)
            print(f"wrote {len(s.events)} events to {args.events_out}")
        return rep
    if spec.faults.enabled:
        # the reference's one-shot path ignores ``faults``; refusing keeps a
        # run's meaning visible (a worker crash needs the elastic server)
        raise ValueError(
            "fault injection needs the elastic server: pass --elastic or "
            "--config (the one-shot generator has no workers to crash)")
    return run_serving(
        spec.model.arch, stages=spec.parallel.stages,
        micro=spec.parallel.num_micro, mb_global=spec.parallel.mb_global,
        prompt_len=spec.serve.prompt_len, gen=spec.serve.gen,
        layers=spec.model.layers, d_model=spec.model.d_model,
        dynamism=spec.dynamics.kind, rebalance_every=args.rebalance_every,
        seed=spec.seed, kernel_impl=spec.parallel.kernel_impl,
        param_dtype=spec.parallel.param_dtype, device=args.device,
        params=params, procs=args.procs, data=spec.parallel.data,
        dist_backend=args.dist_backend)


def main(argv: Optional[List[str]] = None) -> None:
    rep = run(argv)
    if rep is None:
        return
    if "completions" not in rep:
        print(f"generated {rep['tokens'].shape} in {rep['wall_s']:.1f}s "
              f"({rep['tokens_per_s']:.1f} tok/s); "
              f"final lps={rep['final_lps']}")
        for r in rep.get("ranks", []):
            launched = {k: v["launches"] for k, v in r["launches"].items()
                        if v["launches"]}
            print(f"  rank {r['rank']} (stage {r['stage']}, replica "
                  f"{r['replica']}, {r['device']}, {r['backend']}): "
                  f"launches {launched}; hand-offs {r['comm']['handoffs']}")
        return
    kinds = [r["kind"] for r in rep["resizes"]]
    print(f"served {len(rep['completions'])} requests / "
          f"{rep['total_tokens']} tokens in {rep['wall_s']:.1f}s "
          f"({rep['tokens_per_s']:.1f} tok/s); p50/p95 token latency "
          f"{rep['latency_p50_s'] * 1e3:.0f}/"
          f"{rep['latency_p95_s'] * 1e3:.0f}ms; resizes={kinds}; "
          f"stages {rep['stages_history'][0]}->"
          f"{rep['stages_history'][-1]}")
    if rep.get("measured_stage_times") is not None:
        print(f"  measured stage times "
              f"{[f'{t * 1e3:.1f}ms' for t in rep['measured_stage_times']]}")
    for d in rep["autoscale_decisions"]:
        print(f"  autoscale @tick {d['step']}: {d['action']} "
              f"({d['reason']})")


if __name__ == "__main__":
    main()

"""Serve a small model with batched requests through the PyTorch/CUDA
port's pipelined decode path — with CALM-style early exit and DynMo
rebalancing between generation rounds.

    PYTHONPATH=src python examples/torch_serve_early_exit.py [--device cpu]

Flow: prefill the request batch -> decode tokens through the pipeline ->
between generation rounds the controller rebalances the stages from the
token-survival profile (later layers see fewer live tokens, so they are
cheap; DynMo packs more of them per stage).  The migration moves the
layers' params and their KV cache together, so decode continues on the
migrated cache: the tokens are those of the same run without the
rebalance.  At this width (d_model 128, random weights) a cosine threshold
of 0.93 lets about two fifths of the prompt tokens exit.  The run is on
the CUDA card unless ``--device cpu``.
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def generate(rebalance: bool, device=None, gen: int = 12):
    """(tokens [micro, mbg, gen], the controller's events, the exited
    share of the prompts' tokens after the last stage)."""
    import torch

    from repro_torch.configs import DistConfig, get_config, reduced_config
    from repro_torch.core.controller import ControllerConfig, DynMoController
    from repro_torch.core.cost_model import (PEAK_FLOPS, LayerDynState,
                                             cost_vector, layer_flops)
    from repro_torch.core.profiler import LayerProfile
    from repro_torch.device import resolve_device
    from repro_torch.dynamics.config import DynamicsConfig
    from repro_torch.models import model as M
    from repro_torch.pipeline.pipeline import (PipelineShapes, build_loss_fn,
                                               build_decode_fn,
                                               build_prefill_fn)

    dev = resolve_device(device)
    stages, micro, mbg, seq = 4, 2, 4, 32
    cfg = reduced_config(get_config("smollm-360m"), num_layers=8,
                         d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
                         vocab_size=512)
    dcfg = DistConfig(num_stages=stages, slot_slack=3, remat="none",
                      param_dtype="float32")
    dyncfg = DynamicsConfig(kind="early_exit", ee_threshold=0.93,
                            ee_min_layer_frac=0.25)
    shapes = PipelineShapes(micro, mbg, seq, cache_len=seq + gen)

    params = M.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                           dcfg, dev)
    assignment = M.make_assignment(cfg, dcfg)
    dyn = M.init_dyn(cfg, dcfg, dyncfg, dev)
    cache = M.init_cache(cfg, dcfg, micro, mbg, seq + gen, dev)
    prefill = build_prefill_fn(cfg, dcfg, dyncfg, shapes)
    decode = build_decode_fn(cfg, dcfg, dyncfg, shapes)
    rng = np.random.RandomState(0)
    tokens = torch.tensor(rng.randint(0, cfg.vocab_size, (micro, mbg, seq)),
                          dtype=torch.int32, device=dev)

    # the early-exit share of the prompt tokens (the same stage loop in
    # evaluation): later layers see fewer live tokens
    with torch.no_grad():
        _, stats = build_loss_fn(cfg, dcfg, dyncfg, shapes)(
            params, assignment, dyn,
            {"tokens": tokens, "labels": tokens,
             "label_mask": torch.ones(tokens.shape, device=dev)})
    exited = float(stats["exited_frac"])

    ctrl = DynMoController(cfg, dcfg, dyncfg,
                           ControllerConfig(method="partition",
                                            cost_by="time",
                                            rebalance_every=1))
    print(f"prefill {micro * mbg} requests of {seq} tokens ...")
    with torch.no_grad():
        ids, cache, _ = prefill(params, assignment, dyn, cache,
                                {"tokens": tokens})
        outs = [ids.cpu().numpy()]
        for g in range(1, gen):
            ids, _, cache, _ = decode(
                params, assignment, dyn, cache, ids,
                torch.tensor(seq + g - 1, device=dev))
            outs.append(ids.cpu().numpy())
            if rebalance and g == gen // 2:
                # serving-time rebalance from the early-exit survival curve
                L = cfg.total_blocks()
                states = [LayerDynState(
                    token_frac=max(0.05, float(np.exp(-0.25 * max(
                        0, i - L * dyncfg.ee_min_layer_frac)))))
                    for i in range(L)]
                # each layer's time is its FLOPs at its live tokens over
                # the peak (a 4-lane decode step of this small model is
                # bound by the weights' bytes, and would look uniform)
                t = np.array([layer_flops(cfg, bt, mbg, seq + g, st)
                              for bt, st in zip(cfg.block_pattern(),
                                                states)]) / PEAK_FLOPS
                prof = LayerProfile(t, cost_vector(
                    cfg, mbg, seq + g, states, "param")
                    * dcfg.bytes_per_param, np.zeros(stages), states)
                new_lps, ev = ctrl.decide(prof, g)
                if new_lps:
                    params, _, dyn, assignment, cache = ctrl.apply(
                        new_lps, params, None, dyn, cache)
                    print(f"  [dynmo] mid-serving rebalance -> {ctrl.lps} "
                          f"(imbalance {ev.imbalance_before:.2f} -> "
                          f"{ev.imbalance_after:.2f}) - decode continues on "
                          f"the migrated cache")
    return np.stack(outs, axis=-1), ctrl, exited


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--gen", type=int, default=12)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    toks, ctrl, exited = generate(True, args.device, args.gen)
    print(f"generated {toks.shape} tokens; sample row: "
          f"{toks[0, 0].tolist()}; {exited:.1%} of the prompt tokens exited "
          f"early")
    plain, _, _ = generate(False, args.device, args.gen)
    same = bool(np.array_equal(toks, plain))
    print(f"tokens identical to the run without the rebalance: {same}")
    assert same
    return {"tokens": toks, "plain_tokens": plain, "lps": list(ctrl.lps),
            "rebalances": [e for e in ctrl.events if e.rebalanced],
            "exited_frac": exited}


if __name__ == "__main__":
    main()

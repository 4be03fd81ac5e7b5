"""Registry of the paper's six dynamism scenarios as runnable ``RunSpec``s
(the port's copy of ``repro.api.scenarios``).

Each preset is the §2 example case at CPU integration scale (reduced
arch, 4 stage buffers) so ``python -m repro_torch.launch.train --config
configs/scenarios/<name>.json --device cpu`` demonstrates the scheme end
to end.  The checked-in JSON files under ``configs/scenarios/`` are
exactly these specs serialized (``scripts/torch_gen_scenarios.py`` writes
the port's; ``scripts/torch_check_configs.py`` validates every config with
the port's ``RunSpec``).

``moe`` runs a real MoE family arch (routing imbalance is intrinsic — no
dynamism events needed); the other five run the reduced dense GPT with the
scheme's dyn-state mutations driven by the training loop.
"""
import dataclasses
from typing import Dict, List

from repro_torch.api.specs import (DYNAMICS_PRESETS, ControllerSpec,
                                   ModelSpec, ParallelSpec, RepackSpec,
                                   RunSpec)

# one shared integration scale: big enough that rebalancing has layers to
# move (8 blocks over 4 stages), small enough for a CI matrix job
_PARALLEL = ParallelSpec(stages=4, num_micro=2, mb_global=2, seq=32)
_MODEL = ModelSpec(arch="smollm-360m", layers=8, d_model=64)
_CONTROLLER = ControllerSpec(rebalance_every=5)


def _spec(**kw) -> RunSpec:
    base = dict(model=_MODEL, parallel=_PARALLEL, controller=_CONTROLLER,
                steps=16, log_every=5)
    base.update(kw)
    return RunSpec(**base)


SCENARIOS: Dict[str, RunSpec] = {
    # MoE: routing imbalance is intrinsic to the arch; the controller sees
    # it through the per-slot stats like any other cost skew
    "moe": _spec(model=ModelSpec(arch="mixtral-8x7b", layers=4, d_model=64),
                 dynamics=DYNAMICS_PRESETS["moe"]),
    # gradual block pruning (Zhu–Gupta) + live repack: the model shrinks
    # until the controller consolidates 4 workers onto fewer (Alg. 2)
    "pruning": _spec(
        dynamics=DYNAMICS_PRESETS["pruning"],
        controller=dataclasses.replace(
            _CONTROLLER, repack=RepackSpec(enabled=True)),
        steps=26),
    # Egeria-style front-to-back freezing: frozen layers drop their
    # backward cost and the balancer shifts layers toward them
    "freezing": _spec(dynamics=DYNAMICS_PRESETS["freezing"], steps=26),
    # dynamic sparse flash attention; bucket/block sizes shrunk so the
    # hash mask actually fires at integration seq length
    "sparse_attention": _spec(dynamics=dataclasses.replace(
        DYNAMICS_PRESETS["sparse_attention"],
        sparse_block=16, sparse_nbuckets=4)),
    # CALM-style early exit: confident tokens stop flowing through the
    # deeper stages
    "early_exit": _spec(dynamics=DYNAMICS_PRESETS["early_exit"]),
    # mixture-of-depths routing around every block
    "mod": _spec(dynamics=DYNAMICS_PRESETS["mod"]),
}


def scenario_names() -> List[str]:
    return sorted(SCENARIOS)


def scenario(name: str) -> RunSpec:
    if name not in SCENARIOS:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"have {scenario_names()}")
    return SCENARIOS[name]

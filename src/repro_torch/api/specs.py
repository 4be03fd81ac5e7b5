"""Typed, serializable run specification — the single front door (the
port's copy of ``repro.api.specs``: the same schema, validation messages
and upgraders, so a config file means the same run in both packages).

A ``RunSpec`` is the complete description of one run of the system: model
shape, parallelism layout, dynamism scheme, controller policy, cluster
elasticity, and serving trace.  It is the unit that crosses every
boundary — CLI flags build one, ``--config run.json`` loads one, the
``Session`` executes one, scenario presets ship as checked-in ones, and
benchmark snapshots embed the one that produced each number.

Design rules (DESIGN.md §11):

  * **Frozen** — specs are values.  Derive variants with
    ``dataclasses.replace`` (or ``RunSpec.override`` for dotted paths).
  * **Validated at construction** — choice fields, ranges, and cross-field
    constraints (e.g. ``controller.repack.target < parallel.stages``) fail
    here with the dotted path in the message, not deep inside the engine.
  * **Strict deserialization** — unknown keys are errors, so a typo in a
    config file can never silently fall back to a default.
  * **Schema-versioned** — ``schema_version`` gates ``from_dict``; bumping
    it is a deliberate act covered by the golden-file test.

No torch imports here: loading or validating a spec never touches device
state.
"""

import dataclasses
import json
from typing import Any, Dict, List, Optional

from repro_torch.configs.base import DTYPE_BYTES
from repro_torch.dynamics.config import DynamicsConfig

SCHEMA_VERSION = 5

DYNAMISM_KINDS = ("none", "moe", "pruning", "freezing", "sparse_attention",
                  "early_exit", "mod")
KERNEL_IMPLS = ("reference", "scan", "pallas")
BALANCERS = ("diffusion", "partition")
REPACK_POLICIES = ("adjacent", "first_fit")
JOB_MANAGERS = ("inproc", "file", "http")


class SpecError(ValueError):
    """A spec failed validation; the message carries the dotted field path."""


def _check(cond: bool, path: str, msg: str) -> None:
    if not cond:
        raise SpecError(f"{path}: {msg}")


def _check_choice(value: str, choices, path: str) -> None:
    _check(value in choices, path,
           f"got {value!r}, expected one of {list(choices)}")


def _check_pos(value, path: str) -> None:
    _check(isinstance(value, int) and value >= 1, path,
           f"must be a positive int, got {value!r}")


def _check_frac(value, path: str) -> None:
    _check(0.0 <= float(value) <= 1.0, path,
           f"must be in [0, 1], got {value!r}")


# ---------------------------------------------------------------------------
# Leaf specs
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Which architecture, optionally reduced to integration scale.

    ``layers=None`` runs the registry config at full size; setting it
    shrinks the arch via ``configs.base.reduced_config`` (family shape —
    MoE/SSM/enc-dec structure — is preserved)."""
    arch: str = "smollm-360m"
    layers: Optional[int] = None
    d_model: int = 128
    num_heads: int = 4
    num_kv_heads: int = 2
    d_ff: Optional[int] = None        # None -> 2 * d_model
    vocab_size: int = 512

    def __post_init__(self):
        _check(isinstance(self.arch, str) and self.arch, "model.arch",
               f"must be a non-empty arch name, got {self.arch!r}")
        if self.layers is not None:
            _check_pos(self.layers, "model.layers")
        _check_pos(self.d_model, "model.d_model")
        _check_pos(self.num_heads, "model.num_heads")
        _check_pos(self.num_kv_heads, "model.num_kv_heads")
        if self.d_ff is not None:
            _check_pos(self.d_ff, "model.d_ff")
        _check_pos(self.vocab_size, "model.vocab_size")


@dataclasses.dataclass(frozen=True)
class ParallelSpec:
    """Pipeline / batch layout and kernel dispatch."""
    stages: int = 4
    num_micro: int = 4
    mb_global: int = 4
    seq: int = 64
    slot_slack: int = 2
    remat: str = "none"
    param_dtype: str = "float32"
    kernel_impl: str = "scan"
    data: int = 1

    def __post_init__(self):
        for name in ("stages", "num_micro", "mb_global", "seq", "data"):
            _check_pos(getattr(self, name), f"parallel.{name}")
        _check(isinstance(self.slot_slack, int) and self.slot_slack >= 0,
               "parallel.slot_slack",
               f"must be a non-negative int, got {self.slot_slack!r}")
        _check_choice(self.remat, ("none", "block", "full"), "parallel.remat")
        _check_choice(self.param_dtype, tuple(DTYPE_BYTES),
                      "parallel.param_dtype")
        _check_choice(self.kernel_impl, KERNEL_IMPLS, "parallel.kernel_impl")


@dataclasses.dataclass(frozen=True)
class DynamicsSpec:
    """Which dynamism scheme runs, wrapping ``dynamics.config.DynamicsConfig``
    field-for-field (same defaults) so the spec serializes what the jitted
    step will actually see."""
    kind: str = "none"
    # gradual pruning (Zhu–Gupta schedule, paper Eq. 3)
    prune_initial_sparsity: float = 0.0
    prune_final_sparsity: float = 0.9
    prune_start_iter: int = 3000
    prune_end_iter: int = 7000
    prune_frequency: int = 1000
    # layer freezing (Egeria-style)
    freeze_check_every: int = 50
    freeze_loss_slope_threshold: float = 0.02
    # dynamic sparse flash attention
    sparse_nbuckets: int = 8
    sparse_block: int = 512
    # early exit (CALM-style confidence)
    ee_threshold: float = 0.98
    ee_min_layer_frac: float = 0.25
    # mixture of depths
    mod_capacity: float = 0.5
    mod_every: int = 1
    # live expert re-layout (MoE archs, kernel_impl="pallas")
    expert_relayout: bool = False
    expert_watermark: float = 2.0
    expert_min_tokens: int = 16

    def __post_init__(self):
        _check_choice(self.kind, DYNAMISM_KINDS, "dynamics.kind")
        _check_frac(self.prune_initial_sparsity,
                    "dynamics.prune_initial_sparsity")
        _check_frac(self.prune_final_sparsity,
                    "dynamics.prune_final_sparsity")
        _check(self.prune_start_iter <= self.prune_end_iter,
               "dynamics.prune_start_iter",
               f"must be <= prune_end_iter ({self.prune_end_iter}), "
               f"got {self.prune_start_iter}")
        _check_frac(self.ee_threshold, "dynamics.ee_threshold")
        _check_frac(self.ee_min_layer_frac, "dynamics.ee_min_layer_frac")
        _check_frac(self.mod_capacity, "dynamics.mod_capacity")
        _check_pos(self.mod_every, "dynamics.mod_every")
        _check(float(self.expert_watermark) >= 1.0,
               "dynamics.expert_watermark",
               f"must be >= 1.0 (it is a max/mean load ratio), "
               f"got {self.expert_watermark!r}")
        _check(isinstance(self.expert_min_tokens, int)
               and self.expert_min_tokens >= 0,
               "dynamics.expert_min_tokens",
               f"must be a non-negative int, got {self.expert_min_tokens!r}")

    def to_config(self) -> DynamicsConfig:
        return DynamicsConfig(**{f.name: getattr(self, f.name)
                                 for f in dataclasses.fields(self)})


# Paper scenario presets at the DynamicsSpec level: the six example cases
# of §2 with their scheme-specific knobs at the paper's defaults.
# ``repro_torch.api.scenarios`` composes these into full CI-runnable RunSpecs
# (arch + scale + controller); the JSON files under configs/scenarios/
# are their serialized form.
DYNAMICS_PRESETS: Dict[str, DynamicsSpec] = {
    kind: DynamicsSpec(kind=kind)
    for kind in DYNAMISM_KINDS if kind != "none"
}


@dataclasses.dataclass(frozen=True)
class RepackSpec:
    """Live worker consolidation (paper Alg. 2)."""
    enabled: bool = False
    policy: str = "adjacent"
    mem_cap: float = 1.1     # capacity factor x unpruned per-stage footprint
    target: int = 1          # never consolidate below this many workers

    def __post_init__(self):
        _check_choice(self.policy, REPACK_POLICIES, "controller.repack.policy")
        _check(self.mem_cap > 0, "controller.repack.mem_cap",
               f"must be > 0, got {self.mem_cap!r}")
        _check_pos(self.target, "controller.repack.target")


@dataclasses.dataclass(frozen=True)
class ControllerSpec:
    """DynMo control loop: balancing policy, cadence, repack, stragglers."""
    balancer: str = "diffusion"
    rebalance_every: int = 10
    repack: RepackSpec = dataclasses.field(default_factory=RepackSpec)
    async_decide: bool = False    # profile->decide on a background thread
    async_drain: bool = False     # block per decision (deterministic async)
    straggler: Optional[Dict[int, float]] = None   # worker id -> slowdown
    measure_stage_times: bool = False

    def __post_init__(self):
        _check_choice(self.balancer, BALANCERS, "controller.balancer")
        _check_pos(self.rebalance_every, "controller.rebalance_every")
        if self.straggler is not None:
            for k, v in self.straggler.items():
                _check(isinstance(k, int) and k >= 0,
                       "controller.straggler",
                       f"worker ids must be ints >= 0, got {k!r}")
                _check(float(v) > 0, "controller.straggler",
                       f"multiplier for worker {k} must be > 0, got {v!r}")


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """Elasticity across the job-manager boundary."""
    job_manager: str = "inproc"
    job_manager_dir: Optional[str] = None
    autoscale: bool = False
    autoscale_watermark: bool = False
    watermark_clock: str = "wall"   # "logical": schedule-derived step times
    #   (GPipe tick counts) feed the throughput watermark instead of
    #   wall-clock — deterministic, so --autoscale-watermark runs in CI
    heartbeat_timeout: float = 3.0
    rpc_timeout_s: float = 60.0   # file job-manager client: TOTAL retry
    #   budget per call — chaos/CI runs shrink it so degraded-mode paths
    #   (manager down, breaker open) don't stall a test for a minute
    simulate_recover: Optional[int] = None
    spares: int = 0   # fresh worker ids the pool may provision beyond the
    #   initial set — a post-crash grow can be granted a NEVER-seen process
    #   id instead of waiting for the dead machine to revive
    grow_back: Optional[int] = None   # DEPRECATED: fixed-step re-expansion
    # ---- multi-tenant scheduling (schema v3; DESIGN.md §14) ----
    tenant_id: Optional[str] = None   # register this Session as a tenant
    #   of a shared cluster scheduler; unset = legacy single-Session pool
    priority: int = 0   # steal arbitration rank: a steal only preempts
    #   STRICTLY lower-priority tenants
    manager_url: Optional[str] = None   # connect to an existing HTTP job
    #   manager instead of spawning one (two Sessions contending over one
    #   pool each point here); requires job_manager='http'

    def __post_init__(self):
        _check_choice(self.job_manager, JOB_MANAGERS, "cluster.job_manager")
        if self.tenant_id is not None:
            _check(isinstance(self.tenant_id, str) and self.tenant_id,
                   "cluster.tenant_id",
                   f"must be a non-empty string, got {self.tenant_id!r}")
        _check(isinstance(self.priority, int), "cluster.priority",
               f"must be an int, got {self.priority!r}")
        _check_choice(self.watermark_clock, ("wall", "logical"),
                      "cluster.watermark_clock")
        _check(self.heartbeat_timeout > 0, "cluster.heartbeat_timeout",
               f"must be > 0, got {self.heartbeat_timeout!r}")
        _check(self.spares >= 0, "cluster.spares",
               f"must be >= 0, got {self.spares!r}")
        _check(self.rpc_timeout_s > 0, "cluster.rpc_timeout_s",
               f"must be > 0, got {self.rpc_timeout_s!r}")
        if self.simulate_recover is not None:
            _check(self.simulate_recover >= 0, "cluster.simulate_recover",
                   f"must be >= 0, got {self.simulate_recover!r}")
        if self.grow_back is not None:
            _check_pos(self.grow_back, "cluster.grow_back")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Deterministic chaos schedule (new in schema v2; DESIGN.md §12).

    ``enabled`` turns the ``faults.ChaosInjector`` on; ``auto`` derives a
    seeded random schedule from ``seed`` (``faults.plan.resolve_plan``) and
    merges it under any explicitly pinned fields below.  Steps are trainer
    steps (train) or scheduler ticks (serve); probabilities are per-RPC.
    """
    enabled: bool = False
    seed: int = 0
    auto: bool = False
    worker_crash: Optional[Dict[int, int]] = None   # step/tick -> worker id
    manager_kill: Optional[int] = None              # kill -9 the jm server
    manager_respawn: Optional[int] = None           # restart it on same dir
    kill_at: Optional[int] = None                   # SIGKILL the trainer
    rpc_loss: float = 0.0                           # drop a request write
    rpc_dup: float = 0.0                            # duplicate a delivery
    rpc_delay_s: float = 0.0                        # per-message max delay
    straggler_spike: Optional[Dict[int, float]] = None  # step -> multiplier

    def __post_init__(self):
        _check(isinstance(self.seed, int), "faults.seed",
               f"must be an int, got {self.seed!r}")
        for name in ("rpc_loss", "rpc_dup"):
            _check_frac(getattr(self, name), f"faults.{name}")
        _check(self.rpc_delay_s >= 0, "faults.rpc_delay_s",
               f"must be >= 0, got {self.rpc_delay_s!r}")
        for name in ("manager_kill", "manager_respawn", "kill_at"):
            v = getattr(self, name)
            if v is not None:
                _check(isinstance(v, int) and v >= 0, f"faults.{name}",
                       f"must be a step index >= 0, got {v!r}")
        if self.worker_crash is not None:
            for k, v in self.worker_crash.items():
                _check(isinstance(k, int) and k >= 0, "faults.worker_crash",
                       f"keys must be steps >= 0, got {k!r}")
                _check(isinstance(v, int) and v >= 0, "faults.worker_crash",
                       f"values must be worker ids >= 0, got {v!r}")
        if self.straggler_spike is not None:
            for k, v in self.straggler_spike.items():
                _check(isinstance(k, int) and k >= 0,
                       "faults.straggler_spike",
                       f"keys must be steps >= 0, got {k!r}")
                _check(float(v) > 0, "faults.straggler_spike",
                       f"multiplier at step {k} must be > 0, got {v!r}")

    @property
    def any_rpc(self) -> bool:
        return bool(self.rpc_loss or self.rpc_dup or self.rpc_delay_s)


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    """Request trace, KV-slot shapes, and load-signal SLOs for serving."""
    requests: int = 16
    prompt_len: int = 32
    gen: int = 8
    min_prompt: Optional[int] = None
    burst_period: int = 0
    burst_len: int = 0
    burst_rate: int = 4
    lull_rate: int = 1
    early_exit_frac: float = 0.0
    defrag_every: int = 0
    min_stages: int = 1
    queue_high: int = 8
    occupancy_low: float = 0.35
    patience: int = 2
    cooldown: int = 4
    latency_slo_s: float = 0.0
    max_ticks: int = 100000
    # ---- paged KV memory (schema v5; DESIGN.md §16) ----
    kv_page_size: int = 0     # tokens per KV block; 0 = dense contiguous
    #   lanes (the paged subsystem entirely off)
    kv_pool_pages: int = 0    # physical blocks in the pool; 0 = auto-size
    #   to the dense-equivalent footprint (lanes x pages-per-lane)
    prefix_cache: bool = False   # refcounted copy-on-write sharing of full
    #   prompt pages across requests with a common prefix
    temperature: float = 0.0     # per-lane decode sampling; 0 = argmax
    #   (bit-exact with every pre-v5 run)

    def __post_init__(self):
        for name in ("requests", "prompt_len", "gen", "min_stages",
                     "max_ticks"):
            _check_pos(getattr(self, name), f"serve.{name}")
        if self.min_prompt is not None:
            _check_pos(self.min_prompt, "serve.min_prompt")
            _check(self.min_prompt <= self.prompt_len, "serve.min_prompt",
                   f"must be <= prompt_len ({self.prompt_len}), "
                   f"got {self.min_prompt}")
        for name in ("burst_period", "burst_len", "burst_rate", "lull_rate",
                     "defrag_every", "queue_high", "patience", "cooldown",
                     "kv_page_size", "kv_pool_pages"):
            v = getattr(self, name)
            _check(isinstance(v, int) and v >= 0, f"serve.{name}",
                   f"must be a non-negative int, got {v!r}")
        _check_frac(self.early_exit_frac, "serve.early_exit_frac")
        _check_frac(self.occupancy_low, "serve.occupancy_low")
        _check(self.latency_slo_s >= 0, "serve.latency_slo_s",
               f"must be >= 0, got {self.latency_slo_s!r}")
        _check(self.temperature >= 0, "serve.temperature",
               f"must be >= 0, got {self.temperature!r}")
        if self.kv_page_size > 0:
            # the cache line (prompt_len + gen positions, what the session
            # sizes cache_len to) must tile exactly into pages: a paged
            # lane row then has the same logical length as the dense line,
            # which is what keeps the attention reduction bit-exact
            _check((self.prompt_len + self.gen) % self.kv_page_size == 0,
                   "serve.kv_page_size",
                   f"must divide prompt_len + gen "
                   f"({self.prompt_len + self.gen}), got {self.kv_page_size}")
        else:
            _check(not self.prefix_cache, "serve.prefix_cache",
                   "requires the paged KV subsystem (serve.kv_page_size > 0)")
            _check(self.kv_pool_pages == 0, "serve.kv_pool_pages",
                   "requires serve.kv_page_size > 0")


@dataclasses.dataclass(frozen=True)
class ObsSpec:
    """Observability (new in schema v4; DESIGN.md §15).

    Everything here is inert by default: no tracer, no metrics endpoint,
    stage timings still come from the probe.  ``in_step_timing`` switches
    ``StatsSnapshot.stage_times`` to the live in-step stamps (the probe
    stays available behind ``controller.measure_stage_times`` as a parity
    oracle)."""
    trace: bool = False               # record spans (Tracer) for this run
    trace_out: Optional[str] = None   # export Chrome trace-event JSON here
    metrics_port: Optional[int] = None   # serve GET /metrics on this port
    metrics_out: Optional[str] = None    # write a JSON metrics snapshot
    in_step_timing: bool = False      # stage times from the live step

    def __post_init__(self):
        if self.metrics_port is not None:
            _check(isinstance(self.metrics_port, int)
                   and 0 < self.metrics_port < 65536,
                   "obs.metrics_port",
                   f"must be a port in (0, 65536), got {self.metrics_port!r}")
        if self.trace_out is not None:
            _check(isinstance(self.trace_out, str) and self.trace_out,
                   "obs.trace_out",
                   f"must be a non-empty path, got {self.trace_out!r}")
        if self.metrics_out is not None:
            _check(isinstance(self.metrics_out, str) and self.metrics_out,
                   "obs.metrics_out",
                   f"must be a non-empty path, got {self.metrics_out!r}")


# ---------------------------------------------------------------------------
# The composed spec
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RunSpec:
    """One run of the system, end to end."""
    schema_version: int = SCHEMA_VERSION
    model: ModelSpec = dataclasses.field(default_factory=ModelSpec)
    parallel: ParallelSpec = dataclasses.field(default_factory=ParallelSpec)
    dynamics: DynamicsSpec = dataclasses.field(default_factory=DynamicsSpec)
    controller: ControllerSpec = dataclasses.field(
        default_factory=ControllerSpec)
    cluster: ClusterSpec = dataclasses.field(default_factory=ClusterSpec)
    serve: ServeSpec = dataclasses.field(default_factory=ServeSpec)
    faults: FaultSpec = dataclasses.field(default_factory=FaultSpec)
    obs: ObsSpec = dataclasses.field(default_factory=ObsSpec)
    steps: int = 50
    seed: int = 0
    log_every: int = 10
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 0       # >0: safe-point checkpoint cadence (steps)

    # -- validation --------------------------------------------------------
    def __post_init__(self):
        _check(self.schema_version == SCHEMA_VERSION, "schema_version",
               f"this build reads schema v{SCHEMA_VERSION}, the spec says "
               f"v{self.schema_version}; migrate the config (DESIGN.md §11)")
        _check_pos(self.steps, "steps")
        _check(isinstance(self.seed, int), "seed",
               f"must be an int, got {self.seed!r}")
        _check_pos(self.log_every, "log_every")
        # cross-field constraints: fail at construction, not in the engine
        if self.controller.repack.enabled:
            _check(self.controller.repack.target < self.parallel.stages,
                   "controller.repack.target",
                   f"must be < parallel.stages ({self.parallel.stages}) "
                   f"when repack is enabled, got "
                   f"{self.controller.repack.target}")
        _check(self.serve.min_stages <= self.parallel.stages,
               "serve.min_stages",
               f"must be <= parallel.stages ({self.parallel.stages}), "
               f"got {self.serve.min_stages}")
        if self.cluster.simulate_recover is not None:
            _check(self.cluster.autoscale, "cluster.simulate_recover",
                   "requires cluster.autoscale=true (heartbeat recovery is "
                   "an autoscaler signal)")
        if self.cluster.manager_url is not None:
            _check(self.cluster.job_manager == "http",
                   "cluster.manager_url",
                   "connecting to an existing manager requires "
                   "cluster.job_manager='http'")
        if self.cluster.tenant_id is not None:
            _check(self.cluster.job_manager != "inproc",
                   "cluster.tenant_id",
                   "tenant registration needs a shared manager process; "
                   "cluster.job_manager must be 'file' or 'http'")
        if self.cluster.autoscale_watermark:
            _check(self.cluster.autoscale, "cluster.autoscale_watermark",
                   "requires cluster.autoscale=true")
        if self.controller.straggler:
            for k in self.controller.straggler:
                _check(k < self.parallel.stages, "controller.straggler",
                       f"worker id {k} out of range for parallel.stages="
                       f"{self.parallel.stages}")
        _check(isinstance(self.ckpt_every, int) and self.ckpt_every >= 0,
               "ckpt_every",
               f"must be a non-negative int, got {self.ckpt_every!r}")
        if self.ckpt_every:
            _check(bool(self.ckpt_dir), "ckpt_every",
                   "requires ckpt_dir (safe-point checkpoints need a "
                   "directory to land in)")
        if self.faults.enabled:
            f = self.faults
            if f.manager_kill is not None or f.manager_respawn is not None:
                _check(self.cluster.job_manager == "file",
                       "faults.manager_kill",
                       "killing the job-manager process requires "
                       "cluster.job_manager='file' (inproc has no process "
                       "to kill)")
            if f.manager_kill is not None and f.manager_respawn is not None:
                _check(f.manager_respawn > f.manager_kill,
                       "faults.manager_respawn",
                       f"must be > manager_kill ({f.manager_kill}), got "
                       f"{f.manager_respawn}")
            if f.any_rpc:
                _check(self.cluster.job_manager == "file", "faults.rpc_loss",
                       "RPC loss/dup/delay faults act on the file "
                       "transport; cluster.job_manager must be 'file'")
            if f.kill_at is not None:
                _check(self.ckpt_every > 0, "faults.kill_at",
                       "killing the trainer without ckpt_every > 0 loses "
                       "the run — enable safe-point checkpoints")

    # -- serialization -----------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return _to_dict(self)

    def to_json(self, indent: int = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=False)

    @classmethod
    def from_dict(cls, d: Dict[str, Any], source: str = "spec") -> "RunSpec":
        _check(isinstance(d, dict), source,
               f"expected a JSON object, got {type(d).__name__}")
        ver = d.get("schema_version", SCHEMA_VERSION)
        _check(isinstance(ver, int), f"{source}.schema_version",
               f"must be an int, got {ver!r}")
        _check(ver <= SCHEMA_VERSION, f"{source}.schema_version",
               f"this build reads schema v{SCHEMA_VERSION}, the file says "
               f"v{ver}; migrate the config (DESIGN.md §11)")
        while ver < SCHEMA_VERSION:
            _check(ver in _UPGRADERS, f"{source}.schema_version",
                   f"no upgrader registered for schema v{ver}")
            d = _UPGRADERS[ver](dict(d))
            _check(d.get("schema_version") == ver + 1,
                   f"{source}.schema_version",
                   f"upgrader v{ver} did not bump the version")
            ver += 1
        return _from_dict(cls, d, source)

    @classmethod
    def from_json(cls, text: str, source: str = "spec") -> "RunSpec":
        try:
            d = json.loads(text)
        except json.JSONDecodeError as e:
            raise SpecError(f"{source}: not valid JSON: {e}") from None
        return cls.from_dict(d, source)

    @classmethod
    def load(cls, path: str) -> "RunSpec":
        with open(path) as f:
            return cls.from_json(f.read(), source=path)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    # -- dotted-path access (CLI --set, flag builder) ----------------------
    def get(self, path: str) -> Any:
        node: Any = self
        for part in path.split("."):
            _check(dataclasses.is_dataclass(node)
                   and part in {f.name for f in dataclasses.fields(node)},
                   path, f"unknown field {part!r}")
            node = getattr(node, part)
        return node

    def override(self, assignments: Dict[str, Any]) -> "RunSpec":
        """Return a new spec with dotted-path overrides applied, e.g.
        ``{"controller.repack.policy": "first_fit"}`` — the typed engine
        behind CLI ``--set``.  Values are coerced to the field type."""
        d = self.to_dict()
        for path, value in assignments.items():
            parts = path.split(".")
            ftype = leaf_field_type(path)   # raises SpecError on bad path
            node = d
            for part in parts[:-1]:
                node = node[part]
            node[parts[-1]] = coerce_value(value, ftype, path)
        return RunSpec.from_dict(d, source="override")


# ---------------------------------------------------------------------------
# Schema migrations: one pure dict->dict upgrader per historical version.
# ``from_dict`` chains them, so a v1 config keeps loading forever and the
# golden-fixture test pins each frozen version's file byte-for-byte.
# ---------------------------------------------------------------------------
def _upgrade_v1(d: Dict[str, Any]) -> Dict[str, Any]:
    """v1 -> v2: adds ``faults`` (FaultSpec) and ``ckpt_every``.  Both are
    new knobs with inert defaults, so the upgrade is purely additive —
    a v1 run means exactly the same v2 run."""
    d["schema_version"] = 2
    d.setdefault("faults", {})
    d.setdefault("ckpt_every", 0)
    return d


def _upgrade_v2(d: Dict[str, Any]) -> Dict[str, Any]:
    """v2 -> v3: multi-tenant cluster scheduling (DESIGN.md §14) — adds
    ``cluster.tenant_id`` / ``cluster.priority`` / ``cluster.manager_url``
    and the 'http' job-manager choice.  All inert by default (no tenant id
    = legacy single-Session pool), so the upgrade is purely additive."""
    d["schema_version"] = 3
    c = d.setdefault("cluster", {})
    if isinstance(c, dict):
        c.setdefault("tenant_id", None)
        c.setdefault("priority", 0)
        c.setdefault("manager_url", None)
    return d


def _upgrade_v3(d: Dict[str, Any]) -> Dict[str, Any]:
    """v3 -> v4: the observability layer (DESIGN.md §15) — adds the
    ``obs`` block (tracing, metrics endpoint, in-step stage timing).  All
    off by default, so the upgrade is purely additive."""
    d["schema_version"] = 4
    d.setdefault("obs", {})
    return d


def _upgrade_v4(d: Dict[str, Any]) -> Dict[str, Any]:
    """v4 -> v5: the paged KV memory subsystem (DESIGN.md §16) — adds
    ``serve.kv_page_size`` / ``serve.kv_pool_pages`` / ``serve.prefix_cache``
    and per-lane ``serve.temperature``.  Defaults keep serving dense and
    argmax, so a v4 run means exactly the same (bit-exact) v5 run."""
    d["schema_version"] = 5
    s = d.setdefault("serve", {})
    if isinstance(s, dict):
        s.setdefault("kv_page_size", 0)
        s.setdefault("kv_pool_pages", 0)
        s.setdefault("prefix_cache", False)
        s.setdefault("temperature", 0.0)
    return d


_UPGRADERS = {1: _upgrade_v1, 2: _upgrade_v2, 3: _upgrade_v3,
              4: _upgrade_v4}


# ---------------------------------------------------------------------------
# dict <-> dataclass plumbing (strict: unknown keys are errors)
# ---------------------------------------------------------------------------
def _to_dict(spec) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for f in dataclasses.fields(spec):
        v = getattr(spec, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = _to_dict(v)
        elif isinstance(v, dict):
            # JSON object keys are strings; from_dict coerces them back
            out[f.name] = {str(k): vv for k, vv in v.items()}
        else:
            out[f.name] = v
    return out


# int-keyed dict fields (JSON stringifies keys; from_dict coerces back):
# (owner class, field name) -> value coercion
_INT_KEY_DICTS = {
    ("ControllerSpec", "straggler"): float,
    ("FaultSpec", "worker_crash"): int,
    ("FaultSpec", "straggler_spike"): float,
}


def _from_dict(cls, d: Dict[str, Any], path: str):
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = sorted(set(d) - set(fields))
    if unknown:
        raise SpecError(
            f"{path}: unknown key{'s' if len(unknown) > 1 else ''} "
            f"{unknown}; known keys: {sorted(fields)}")
    kwargs: Dict[str, Any] = {}
    for name, f in fields.items():
        if name not in d:
            continue
        v = d[name]
        val_t = _INT_KEY_DICTS.get((cls.__name__, name))
        if dataclasses.is_dataclass(f.type):
            _check(isinstance(v, dict), f"{path}.{name}",
                   f"expected a JSON object, got {type(v).__name__}")
            v = _from_dict(f.type, v, f"{path}.{name}")
        elif val_t is not None and v is not None:
            _check(isinstance(v, dict), f"{path}.{name}",
                   f"expected a JSON object, got {type(v).__name__}")
            try:
                v = {int(k): val_t(vv) for k, vv in v.items()}
            except (TypeError, ValueError):
                raise SpecError(
                    f"{path}.{name}: keys must be ints, values "
                    f"{val_t.__name__}s; got {v!r}") from None
        kwargs[name] = v
    return cls(**kwargs)


# ---------------------------------------------------------------------------
# Field reflection for the CLI flag builder
# ---------------------------------------------------------------------------
def leaf_fields(cls=RunSpec, prefix: str = "") -> List[Any]:
    """Yield (dotted_path, field) for every scalar leaf of the spec tree."""
    out = []
    for f in dataclasses.fields(cls):
        path = f"{prefix}{f.name}"
        if dataclasses.is_dataclass(f.type):
            out.extend(leaf_fields(f.type, prefix=f"{path}."))
        else:
            out.append((path, f))
    return out


_LEAF_TYPES = {path: f for path, f in leaf_fields()}


def leaf_field_type(path: str):
    if path not in _LEAF_TYPES:
        near = sorted(p for p in _LEAF_TYPES
                      if p.split(".")[-1] == path.split(".")[-1])
        hint = f"; did you mean {near}?" if near else ""
        raise SpecError(f"{path}: not a spec field{hint}")
    return _LEAF_TYPES[path].type


def coerce_value(value: Any, ftype, path: str) -> Any:
    """Coerce a CLI/JSON-supplied value to a leaf field's declared type.
    Strings parse per the type ("none"/"null" -> None for Optionals)."""
    origin = getattr(ftype, "__origin__", None)
    args = getattr(ftype, "__args__", ())
    optional = origin is not None and type(None) in args
    if optional:
        inner = [a for a in args if a is not type(None)]
        if value is None or (isinstance(value, str)
                             and value.lower() in ("none", "null")):
            return None
        ftype = inner[0] if len(inner) == 1 else str
        origin = getattr(ftype, "__origin__", None)
    if origin is dict:   # e.g. controller.straggler: "2:1.5,3:1.2" or a dict
        dict_args = getattr(ftype, "__args__", ())
        val_t = dict_args[1] if len(dict_args) == 2 else float
        if isinstance(value, dict):
            return {int(k): val_t(v) for k, v in value.items()}
        try:
            return {int(k): val_t(v) for k, v in
                    (part.split(":") for part in str(value).split(","))}
        except ValueError:
            raise SpecError(
                f"{path}: expected 'key:value[,key:value...]', "
                f"got {value!r}") from None
    if ftype is bool:
        if isinstance(value, bool):
            return value
        s = str(value).lower()
        if s in ("1", "true", "yes", "on"):
            return True
        if s in ("0", "false", "no", "off"):
            return False
        raise SpecError(f"{path}: expected a bool, got {value!r}")
    if ftype is int:
        if isinstance(value, bool):
            raise SpecError(f"{path}: expected an int, got {value!r}")
        try:
            return int(value)
        except (TypeError, ValueError):
            raise SpecError(
                f"{path}: expected an int, got {value!r}") from None
    if ftype is float:
        try:
            return float(value)
        except (TypeError, ValueError):
            raise SpecError(
                f"{path}: expected a float, got {value!r}") from None
    return str(value)

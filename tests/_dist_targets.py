"""Rank targets and hooks for the port's multi-process tests.

``repro_torch.launch.dist.launch`` imports its target in every rank, so
what lives here imports torch and the port only: each rank checks that no
module of jax or of the reference package was loaded.
"""
import torch


def cross_entropy(mesh, h, head, labels, mask):
    """The vocab-parallel loss over the model ring: rank s holds vocab
    shard s of ``head``; returns the loss and the gradients of h and of the
    shard."""
    from repro_torch.models.layers import cross_entropy_with_head
    V = head.shape[1] // mesh.model
    off = mesh.stage * V
    h = h.clone().requires_grad_(True)
    w = head[:, off:off + V].clone().requires_grad_(True)
    loss = cross_entropy_with_head(h, w, labels, label_mask=mask,
                                   vocab_offset=off, group=mesh.model_group,
                                   comm=mesh.comm)
    loss.backward()
    return {"loss": loss.detach(), "dh": h.grad, "dw": w.grad,
            "offset": off}


def compressed_psum(mesh, gs, errs, method):
    """``compressed_psum`` over every rank: rank r reduces ``gs[r]``."""
    import torch.distributed as dist

    from repro_torch.runtime.compression import compressed_psum as cp
    r = mesh.rank
    err = None if errs is None else errs[r]
    red, new_err = cp(gs[r], dist.group.WORLD, method=method, err=err)
    return {"red": red, "err": new_err}


def migrate_rows(mesh, tree, old_lps, new_lps, L_max):
    """``apply_plan_across`` on this rank's row of ``tree`` (a whole
    ``[S, L_max, ...]`` tree handed to every rank); returns the new row."""
    from repro_torch.core.migration import apply_plan_across, build_plan
    s = mesh.stage
    row = {k: v[s:s + 1].clone() for k, v in tree.items()}
    plan = build_plan(old_lps, new_lps, L_max)
    return {"row": apply_plan_across(row, plan, mesh),
            "sent": mesh.comm.stats["rows_sent"],
            "recv": mesh.comm.stats["rows_recv"]}


def ring(mesh, rounds: int = 3, fail_rank=None, fail_round: int = 1):
    """A ring exchange and an all-reduce per round — the transport alone
    (``fail_rank`` raises at ``fail_round``: the launcher must end the
    run)."""
    from repro_torch.launch.dist import foreign_modules
    nxt = mesh.rank_of((mesh.stage + 1) % mesh.model)
    prv = mesh.rank_of((mesh.stage - 1) % mesh.model)
    got = []
    for i in range(rounds):
        if mesh.rank == fail_rank and i == fail_round:
            raise RuntimeError(f"rank {mesh.rank} fails at round {i}")
        x = torch.full((4,), float(mesh.rank * 10 + i), device=mesh.device)
        buf = torch.empty_like(x)
        if mesh.stage % 2 == 0:
            mesh.comm.send(x, nxt)
            mesh.comm.recv(buf, prv)
        else:
            mesh.comm.recv(buf, prv)
            mesh.comm.send(x, nxt)
        tot = mesh.comm.all_reduce(x, None)
        got.append((float(buf[0]), float(tot[0])))
    return {"rank": mesh.rank, "got": got, "foreign": foreign_modules()}


class FailAt:
    """A ``train(on_step=...)`` hook that raises on one rank after one
    step (picklable: the ranks import this module)."""

    def __init__(self, rank: int, step: int):
        self.rank, self.step = rank, step

    def __call__(self, step, session):
        import torch.distributed as dist
        if dist.get_rank() == self.rank and step == self.step:
            raise RuntimeError(f"rank {self.rank} fails after step {step}")


def modules(mesh):
    """The rank's loaded modules of jax or the reference package."""
    from repro_torch.launch.dist import foreign_modules
    x = torch.ones(2) * mesh.rank
    return {"foreign": foreign_modules(),
            "sum": float(mesh.comm.all_reduce(x, None)[0])}


W8 = dict(num_layers=8, d_model=64, num_heads=4, num_kv_heads=2, d_ff=256,
          vocab_size=512)


def engine_scenario(mesh=None):
    """The engine's resizes on reduced smollm (8 layers, 4 stages, two
    microbatches of 2 x 32 tokens): one step, resize(2), back to 4 (the
    round trip), resize(2) and a step on it, back to 4, evict worker 1, a
    grant of a never-seen id, a step.  Run in one process (``mesh=None``)
    and as one rank of 4; returns the losses, the trees gathered whole at
    each point and, across ranks, the rank's world and bytes held."""
    import numpy as np

    from repro_torch.configs import DistConfig, get_config, reduced_config
    from repro_torch.dynamics.config import DynamicsConfig
    from repro_torch.launch.engine import ElasticEngine
    from repro_torch.pipeline.pipeline import PipelineShapes
    from repro_torch.runtime.fault_tolerance import WorkerPool
    cfg = reduced_config(get_config("smollm-360m"), **W8)
    dcfg = DistConfig(num_stages=4, slot_slack=2, remat="none",
                      param_dtype="float32", kernel_impl="pallas")
    eng = ElasticEngine(cfg, dcfg, DynamicsConfig(), PipelineShapes(2, 2, 32),
                        pool=WorkerPool(4), device="cpu", mesh=mesh)
    r = np.random.RandomState(0)
    batch = {"tokens": r.randint(0, cfg.vocab_size, (2, 2, 32)),
             "labels": r.randint(0, cfg.vocab_size, (2, 2, 32)),
             "label_mask": np.ones((2, 2, 32), np.float32)}
    out = {"losses": {}, "trees": {}, "held": {}, "world": {}}

    def note(name, st):
        out["trees"][name] = {
            "params": eng.gather_state(st.params, "params"),
            "opt": eng.gather_state(st.opt_state, "opt"),
            "dyn": eng.gather_state(st.dyn)}
        out["held"][name] = eng.held_bytes(st)
        out["world"][name] = (None if mesh is None else
                              (list(eng.mesh.ranks), eng.role()))

    st = eng.init_state(0, with_opt=True)
    loss, _, gnorm = eng.step(st, batch, 3e-4)
    out["losses"]["step"] = (float(loss), float(gnorm))
    note("start", st)
    out["losses"]["l4"] = float(eng.eval_loss(st, batch))
    s2 = eng.resize(st, 2)
    out["losses"]["l2"] = float(eng.eval_loss(s2, batch))
    note("resize2", s2)
    s4 = eng.resize(s2, 4)
    note("round_trip", s4)
    s2 = eng.resize(s4, 2)
    loss, _, gnorm = eng.step(s2, batch, 3e-4)
    out["losses"]["step2"] = (float(loss), float(gnorm))
    out["losses"]["l2b"] = float(eng.eval_loss(s2, batch))
    s4 = eng.resize(s2, 4)
    s3 = eng.evict(s4, [1], step=7)
    out["losses"]["l3"] = float(eng.eval_loss(s3, batch))
    note("evict", s3)
    out["evict"] = {"stage_workers": list(eng.stage_workers),
                    "dead": sorted(eng.pool.dead),
                    "request": eng.jm.request(1)}
    # the manager provisions a fresh machine: a never-seen id
    eng.pool.spares = 1
    s4 = eng.grow(s3, 1, step=8)
    out["grow"] = {"stage_workers": list(eng.stage_workers),
                   "column": eng.worker_column[eng.stage_workers[-1]]}
    loss, _, gnorm = eng.step(s4, batch, 3e-4)
    out["losses"]["step4"] = (float(loss), float(gnorm))
    note("grow", s4)
    out["pool_log"] = list(eng.pool.log)
    out["epoch"] = eng.epoch
    return out


def engine_elastic(mesh):
    """``engine_scenario`` as one rank; rank 0 returns the trees."""
    from repro_torch.launch.dist import foreign_modules
    out = engine_scenario(mesh)
    if mesh.rank != 0:
        out.pop("trees")
    out["foreign"] = foreign_modules()
    return out


def fail_released(mesh):
    """A shrink releases ranks 2 and 3; rank 3 then raises while the world
    of ranks 0 and 1 goes on (the launcher must end the run)."""
    import numpy as np

    from repro_torch.configs import DistConfig, get_config, reduced_config
    from repro_torch.dynamics.config import DynamicsConfig
    from repro_torch.launch.engine import ElasticEngine
    from repro_torch.pipeline.pipeline import PipelineShapes
    cfg = reduced_config(get_config("smollm-360m"), **W8)
    dcfg = DistConfig(num_stages=4, slot_slack=2, remat="none",
                      param_dtype="float32")
    eng = ElasticEngine(cfg, dcfg, DynamicsConfig(), PipelineShapes(2, 2, 32),
                        device="cpu", mesh=mesh)
    st = eng.shrink(eng.init_state(0, with_opt=True), 2, step=0)
    if mesh.rank == 3:
        raise RuntimeError(f"rank 3 fails while released "
                           f"({eng.role()}, {eng.held_bytes(st)} bytes)")
    r = np.random.RandomState(0)
    batch = {"tokens": r.randint(0, cfg.vocab_size, (2, 2, 32)),
             "labels": r.randint(0, cfg.vocab_size, (2, 2, 32)),
             "label_mask": np.ones((2, 2, 32), np.float32)}
    for _ in range(3):
        eng.step(st, batch, 3e-4)
    return {}


def serve_cycle(mesh, spec, trace, resize_at, params):
    """``Session.serve`` as one rank of the elastic server, then one more
    shrink / grow cycle on the live state; rank 0 returns the report and
    the page pool gathered whole."""
    from repro_torch.api.session import Session
    from repro_torch.launch.dist import foreign_modules
    with Session(spec, device=mesh.device, params=params, mesh=mesh) as s:
        rep = s.serve(trace, resize_at=resize_at)
        eng = s.server.engine
        st = eng.shrink(s.server.state, 2, step=100)
        held = eng.held_bytes(st)
        st = eng.grow(st, 2, step=101)
        pool = eng.gather_state(st.cache)
    out = {"role": rep["role"], "held_after_shrink": held,
           "foreign": foreign_modules()}
    if mesh.rank == 0:
        out.update(report=rep, pool=pool)
    return out


def fixed_latency(base, k: int):
    """``base`` (a ``ControlPlane`` class) whose decisions take ``k`` steps:
    the timing authority (every plane in one process) decides a snapshot
    as soon as it is published, and its plan reaches the outbox at the
    (k + 1)-th poll after the publish — the apply step is then the same in
    one process and across ranks, whatever each thread's pace."""
    from repro_torch.cluster.service import ControlPlane

    class Fixed(base):
        def publish(self, snap):
            super().publish(snap)
            if getattr(self, "lead", True):
                ControlPlane.drain(self)
            self._age = 0

        def poll(self, epoch):
            age = getattr(self, "_age", None)
            if age is not None:
                self._age = age = age + 1
            if not getattr(self, "lead", True) or (age is not None
                                                    and age > k):
                return super().poll(epoch)
            with self._cv:
                held, self._outbox = self._outbox, None
            try:
                return super().poll(epoch)
            finally:
                with self._cv:
                    if self._outbox is None:
                        self._outbox = held

    return Fixed


def patch_latency(k: int):
    """Make ``Session.train``'s control planes ``fixed_latency`` ones."""
    from repro_torch.cluster import service
    for name in ("ControlPlane", "RankControlPlane"):
        cls = getattr(service, name)
        setattr(service, name, fixed_latency(getattr(cls, "_unfixed", cls),
                                             k))
        getattr(service, name)._unfixed = getattr(cls, "_unfixed", cls)


def latency_train(mesh, spec, k: int):
    """``rank_train`` with decisions that take ``k`` steps
    (``fixed_latency``); every rank returns its counters."""
    from repro_torch.api.session import rank_train
    patch_latency(k)
    out = rank_train(mesh, spec)
    if "report" in out:
        out["report"] = {key: out["report"][key] for key in
                         ("losses", "controller", "stages_history")}
    return out


def runs(mesh, parts, archs=()):
    """Several runs in one launch (the ranks' start is paid once).  Each
    part is (kind, spec or None, kwargs): "train" is ``rank_train``,
    "serve" ``rank_serve_elastic``, "one_shot" ``launch.serve.rank_serve``;
    ``archs``: configs registered at run time in the parent.  Returns
    each part's result."""
    from repro_torch.api.session import rank_serve_elastic, rank_train
    from repro_torch.launch.dist import ensure_arch
    from repro_torch.launch.serve import rank_serve
    for cfg in archs:
        ensure_arch(cfg)
    out = []
    for kind, spec, kw in parts:
        if kind == "one_shot":
            out.append(rank_serve(mesh, **kw))
        else:
            fn = rank_train if kind == "train" else rank_serve_elastic
            out.append(fn(mesh, spec, **kw))
    return out


def family_step(mesh, cfg, dcfg, dyncfg, shapes, tree):
    """``value_and_grad`` of the pipelined loss as this rank's stage, on a
    reference tree's params, assignment, dyn and batch (numpy); returns
    the loss and the gradients with the stage rows gathered whole."""
    import numpy as np

    from repro_torch import convert
    from repro_torch.launch.sharding import (gather_rows, local_params,
                                             local_rows, split_batch)
    from repro_torch.pipeline import pipeline as P
    loss_fn = P.build_loss_fn(cfg, dcfg, dyncfg, shapes, mesh=mesh)
    params = local_params(convert.to_torch(tree["params"], "cpu"), mesh)
    dyn = local_rows(convert.to_torch(tree["dyn"], "cpu"), mesh)
    batch = split_batch({k: torch.from_numpy(np.asarray(v))
                         for k, v in tree["batch"].items()}, mesh)
    loss, _, grads = P.value_and_grad(
        loss_fn, params, convert.to_torch(tree["assign"], "cpu"), dyn, batch)
    grads["stages"] = gather_rows(grads["stages"], mesh)
    return {"loss": loss, "grads": grads}


def server(mesh, cfg, dcfg, dyncfg, shapes, trace, params, paged=None):
    """The elastic server as this rank's stage (one rank per stage), on a
    reference's params; rank 0 returns the completions."""
    from repro_torch.serve.server import ElasticServer
    srv = ElasticServer(cfg, dcfg, dyncfg, shapes, seed=0, paged=paged,
                        device=mesh.device, params=params, mesh=mesh)
    try:
        rep = srv.serve(trace)
    finally:
        srv.close()
    return {c["rid"]: c["tokens"] for c in rep["completions"]}

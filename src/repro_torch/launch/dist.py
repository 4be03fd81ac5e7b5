"""Ranks: the process launcher and the transport of the port's mesh.

The reference runs the cells of its ``data x model`` mesh as devices of
one program; ``REPRO_TRAIN_DEVICES`` fakes them on the host.  The port runs
each cell as an OS process.  ``launch`` is the parent's side:

  1. it builds every CUDA kernel once, before any rank starts (four ranks
     would otherwise run four ``nvcc`` per source);
  2. it picks the backend from the layout (``choose_backend``): ``nccl``
     when every rank has a card of its own, ``gloo`` when ranks share a
     card or run on the CPU — and prints the choice;
  3. it spawns one ``python -m repro_torch.launch.dist`` per rank, which
     meets the others through a ``file://`` rendezvous in a fresh
     directory (parallel runs cannot collide), takes its own device
     (``cuda:{rank % device_count}``, or the CPU when asked), builds the
     mesh and calls the job's target;
  4. it watches the ranks: the first one to exit non-zero ends the run —
     the others are killed and ``launch`` raises with that rank's output.
     Every collective has the process group's ``timeout``, and the parent
     a deadline of its own, so no rank can hang the run.

``Comm`` is the ranks' side: point-to-point ``send`` / ``recv``,
``exchange`` (one ``batch_isend_irecv``), ``all_reduce``, ``all_gather``,
``broadcast`` and ``broadcast_object`` over a group.  With ``gloo`` (which moves host memory
only) a CUDA tensor goes through the host on each side: the pipeline's
carries and their gradients (whose shapes ``PipelineShapes`` fixes)
through pinned buffers kept per shape and dtype, a migration's rows and
the collectives through plain host copies.  With ``nccl`` the card's
tensors go directly.
"""
from __future__ import annotations

import datetime
import importlib
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

# a group of one rank: every collective over it is the identity
SOLO = "solo"
# modules a rank must never have loaded
FOREIGN = ("jax", "jaxlib", "repro")


def choose_backend(device: torch.device, nprocs: int,
                   explicit: Optional[str] = None,
                   device_count: Optional[int] = None) -> str:
    """``nccl`` when every rank has a card of its own, else ``gloo``.  An
    explicit ``nccl`` on shared cards or on the CPU raises with the reason
    (NCCL refuses two ranks on one device)."""
    if device.type == "cpu":
        if explicit == "nccl":
            raise ValueError("--dist-backend nccl needs CUDA cards; the "
                             "ranks run on the CPU (use gloo)")
        return "gloo"
    n = torch.cuda.device_count() if device_count is None else device_count
    own = nprocs <= n
    if explicit == "nccl" and not own:
        raise ValueError(
            f"--dist-backend nccl: {nprocs} ranks would share {n} card(s), "
            f"and NCCL refuses two ranks on one device; use gloo (host-"
            f"staged) or one card per rank")
    if explicit not in (None, "nccl", "gloo"):
        raise ValueError(f"unknown backend {explicit!r}: nccl or gloo")
    return explicit or ("nccl" if own else "gloo")


def rank_device(rank: int, device: str) -> torch.device:
    """The rank's own device: ``cuda:{rank % device_count}`` or the CPU."""
    if torch.device(device).type == "cpu":
        return torch.device("cpu")
    from repro_torch.device import resolve_device
    resolve_device("cuda")
    return torch.device("cuda", rank % torch.cuda.device_count())


# ---------------------------------------------------------------------------
# Transport
# ---------------------------------------------------------------------------
class Comm:
    """Collectives and point-to-point transfers of one rank.

    ``stats`` counts the pipeline's hand-offs: ``handoffs`` (carries and
    carry gradients sent) and their ``handoff_bytes``, ``copy_s`` (the
    device <-> host staging copies on both sides), ``send_s`` (inside
    ``send``) and ``recv_wait_s`` (inside ``recv``, which includes waiting
    for the peer's compute), the seconds of a train step's gradient sums
    (``grad_ring_s``: the replicated leaves' over the model ring,
    ``grad_data_s``: every gradient's over ``data``; both from an idle
    card when staged), the rows a migration or a resize moved
    (``rows_sent`` / ``rows_recv``, one per slot of a tree) and the bytes
    ``exchange`` moved (``bytes_sent`` / ``bytes_recv``)."""

    def __init__(self, backend: str, device: torch.device):
        self.backend = backend
        self.device = torch.device(device)
        self.staged = backend == "gloo" and self.device.type == "cuda"
        self._pinned: Dict[Tuple, torch.Tensor] = {}
        # id(group) -> the group ranks' positions in the order the mesh
        # lists its members (a process group orders them by global rank)
        self.order: Dict[int, List[int]] = {}
        self.stats = {"handoffs": 0, "handoff_bytes": 0, "copy_s": 0.0,
                      "send_s": 0.0, "recv_wait_s": 0.0,
                      "grad_ring_s": 0.0, "grad_data_s": 0.0,
                      "rows_sent": 0, "rows_recv": 0,
                      "bytes_sent": 0, "bytes_recv": 0}

    # -- helpers -------------------------------------------------------------
    @staticmethod
    def size(group) -> int:
        import torch.distributed as dist
        return 1 if group is SOLO else dist.get_world_size(group)

    def _buf(self, shape, dtype, role: str) -> torch.Tensor:
        key = (tuple(shape), dtype, role)
        b = self._pinned.get(key)
        if b is None:
            b = torch.empty(shape, dtype=dtype, pin_memory=True)
            self._pinned[key] = b
        return b

    def _out(self, t: torch.Tensor, role: str = "out") -> torch.Tensor:
        """The tensor the backend sends: ``t`` itself, or its host copy."""
        if not self.staged:
            return t.contiguous()
        t0 = time.perf_counter()
        h = self._buf(t.shape, t.dtype, role)
        h.copy_(t, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        self.stats["copy_s"] += time.perf_counter() - t0
        return h

    def _in(self, h: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        if h is out:
            return out
        t0 = time.perf_counter()
        out.copy_(h)
        self.stats["copy_s"] += time.perf_counter() - t0
        return out

    def _landing(self, out: torch.Tensor, role: str = "in") -> torch.Tensor:
        return (self._buf(out.shape, out.dtype, role) if self.staged
                else out)

    # -- point to point ------------------------------------------------------
    def send(self, t: torch.Tensor, dst: int) -> None:
        import torch.distributed as dist
        h = self._out(t, "send")
        t0 = time.perf_counter()
        dist.send(h, dst)
        self.stats["send_s"] += time.perf_counter() - t0
        self.stats["handoffs"] += 1
        self.stats["handoff_bytes"] += h.numel() * h.element_size()

    def recv(self, out: torch.Tensor, src: int) -> torch.Tensor:
        """Receive into ``out`` (a tensor of the expected shape and dtype on
        this rank's device) and return it."""
        import torch.distributed as dist
        h = self._landing(out, "recv")
        t0 = time.perf_counter()
        dist.recv(h, src)
        self.stats["recv_wait_s"] += time.perf_counter() - t0
        return self._in(h, out)

    def exchange(self, sends: Sequence[Tuple[torch.Tensor, int]],
                 recvs: Sequence[Tuple[torch.Tensor, int]],
                 tally: bool = True) -> None:
        """Post every send and receive at once (one ``batch_isend_irecv``)
        and wait for all of them; ``recvs``' tensors are filled in place.
        Both sides list their transfers in one global order, so the k-th
        message between two ranks is the one both sides mean.  ``tally``
        counts the bytes in ``bytes_sent`` / ``bytes_recv`` (a resize's
        moves; a train step's gradient sums are not counted there)."""
        import torch.distributed as dist
        ops, landed, staged = [], [], {}
        for t, dst in sends:
            # a tensor sent to several ranks is staged once
            h = staged.get(id(t))
            if h is None:
                h = staged[id(t)] = (t.detach().to("cpu") if self.staged
                                     else t.contiguous())
            ops.append(dist.P2POp(dist.isend, h, dst))
            if tally:
                self.stats["bytes_sent"] += h.numel() * h.element_size()
        for out, src in recvs:
            h = (torch.empty(out.shape, dtype=out.dtype) if self.staged
                 else out)
            landed.append((h, out))
            ops.append(dist.P2POp(dist.irecv, h, src))
            if tally:
                self.stats["bytes_recv"] += h.numel() * h.element_size()
        if not ops:
            return
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        for h, out in landed:
            if h is not out:
                out.copy_(h)

    # -- collectives -----------------------------------------------------------
    def all_reduce(self, t: torch.Tensor, group=None,
                   op: str = "sum") -> torch.Tensor:
        """The reduction of ``t`` over ``group`` (a new tensor on ``t``'s
        device; ``op`` sum or max)."""
        import torch.distributed as dist
        if self.size(group) == 1:
            return t.clone()
        h = t.detach().to("cpu", copy=True) if self.staged else t.clone()
        dist.all_reduce(h, op={"sum": dist.ReduceOp.SUM,
                               "max": dist.ReduceOp.MAX}[op], group=group)
        return h.to(t.device)

    def all_gather(self, t: torch.Tensor, group=None) -> torch.Tensor:
        """``[n, *t.shape]``: every member's ``t`` in group-rank order."""
        import torch.distributed as dist
        n = self.size(group)
        if n == 1:
            return t[None].clone()
        h = t.detach().to("cpu").contiguous() if self.staged \
            else t.contiguous()
        outs = [torch.empty_like(h) for _ in range(n)]
        dist.all_gather(outs, h, group=group)
        order = self.order.get(id(group))
        if order is not None:
            outs = [outs[i] for i in order]
        return torch.stack(outs).to(t.device)

    def broadcast(self, t: torch.Tensor, src: int, group=None
                  ) -> torch.Tensor:
        """``t`` as the global rank ``src`` holds it, on every member
        (in place on ``t``, which is returned)."""
        import torch.distributed as dist
        if self.size(group) == 1:
            return t
        h = t.detach().to("cpu").contiguous() if self.staged \
            else t.contiguous()
        dist.broadcast(h, src, group=group)
        if h is not t:
            t.copy_(h)
        return t

    def broadcast_object(self, obj, src: int, group=None):
        """``obj`` (any picklable value; its tensors travel through the
        host) as the global rank ``src`` holds it, on every member; tensors
        land on this rank's device.  The other members' ``obj`` is
        ignored."""
        import torch.distributed as dist
        if self.size(group) == 1:
            return obj
        box = [_to_device(obj, "cpu") if dist.get_rank() == src else None]
        dist.broadcast_object_list(box, src, group=group)
        return _to_device(box[0], self.device)

    def all_gather_object(self, obj, group=None) -> List[Any]:
        import torch.distributed as dist
        n = self.size(group)
        if n == 1:
            return [obj]
        out = [None] * n
        dist.all_gather_object(out, obj, group=group)
        return out


def _to_device(obj, device):
    """``obj`` with every tensor in its dicts, lists and tuples moved to
    ``device``."""
    if torch.is_tensor(obj):
        return obj.detach().to(device)
    if isinstance(obj, dict):
        return {k: _to_device(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_device(v, device) for v in obj)
    return obj


# ---------------------------------------------------------------------------
# Launcher (the parent)
# ---------------------------------------------------------------------------
def _package_root() -> str:
    return str(Path(__file__).resolve().parents[2])


def build_kernels() -> Dict[str, float]:
    """Build every CUDA kernel of the port (the parent, before the ranks
    start)."""
    from repro_torch.kernels import KERNELS
    from repro_torch.kernels._build import build
    return build(KERNELS)


def launch(target: str, nprocs: int, *, data: int = 1,
           device: Optional[str] = None, backend: Optional[str] = None,
           kwargs: Optional[Dict[str, Any]] = None,
           timeout_s: float = 300.0,
           run_timeout_s: Optional[float] = None) -> List[Any]:
    """Run ``target`` ("module:function", called as ``fn(mesh,
    **kwargs)``) on ``nprocs`` ranks laid out as ``data x (nprocs //
    data)``; returns every rank's return value, rank order.  ``timeout_s``
    bounds each collective (the process group's timeout), ``run_timeout_s``
    the whole run.  Rank 0's output is printed after the run.  Raises
    ``RuntimeError`` with the failing ranks' output when any rank exits
    non-zero (the others are killed)."""
    if nprocs < 1 or nprocs % data:
        raise ValueError(f"{nprocs} ranks do not split into data={data} "
                         f"replicas")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        from repro_torch.device import resolve_device
        resolve_device("cuda")
    backend = choose_backend(dev, nprocs, backend)
    if dev.type == "cuda":
        build_kernels()
        cards = torch.cuda.device_count()
        how = ("one card each" if backend == "nccl" else
               f"sharing {min(cards, nprocs)} card(s), host-staged")
    else:
        how = "on the CPU"
    print(f"[dist] {nprocs} ranks (data={data} x model={nprocs // data}) "
          f"backend={backend} ({how})", flush=True)
    rundir = tempfile.mkdtemp(prefix="repro_torch_dist_")
    job = {"target": target, "kwargs": kwargs or {}, "nprocs": nprocs,
           "data": data, "device": dev.type, "backend": backend,
           "init": f"file://{rundir}/rendezvous", "timeout_s": timeout_s}
    torch.save(job, os.path.join(rundir, "job.pt"))
    path = [_package_root()] + [p for p in sys.path if p and
                                os.path.isdir(p)]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(path)}
    procs, logs = [], []
    try:
        for r in range(nprocs):
            log = open(os.path.join(rundir, f"rank{r}.log"), "wb")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dist", rundir,
                 str(r)], stdout=log, stderr=subprocess.STDOUT, env=env))
        deadline = (None if run_timeout_s is None
                    else time.monotonic() + run_timeout_s)
        failed = None
        while failed is None and any(p.poll() is None for p in procs):
            for r, p in enumerate(procs):
                if p.poll() not in (None, 0):
                    failed = (r, _exit_words(p.returncode))
                    break
            else:
                if deadline is not None and time.monotonic() > deadline:
                    failed = (None, f"did not finish in {run_timeout_s} s")
                time.sleep(0.05)
        if failed is None:
            for r, p in enumerate(procs):
                if p.returncode != 0:
                    failed = (r, _exit_words(p.returncode))
                    break
        if failed is not None:
            # a rank's failure ends its peers' collectives: give them a
            # moment to exit on their own, so every failed rank's own words
            # (the cause among them) are in the message
            grace = time.monotonic() + 2.0
            while time.monotonic() < grace and any(
                    p.poll() is None for p in procs):
                time.sleep(0.05)
            # the ranks a SIGKILL ended before the parent kills the rest
            killed = [i for i, p in enumerate(procs) if p.poll() == -9]
            _kill(procs)
            r, why = failed
            shown = [i for i, p in enumerate(procs)
                     if r is None or p.returncode not in (0, -9)]
            tails = "\n".join(f"--- rank {i} (exit {procs[i].returncode}) "
                              f"---\n{_tail(rundir, i, 3000)}"
                              for i in shown)
            who = "the run" if r is None else f"rank {r}"
            if killed:
                # a SIGKILL's rank says nothing: name it (a fault plan's
                # trainer_kill fires it in every rank at the same step)
                why += (f"; ranks {killed} were killed by SIGKILL (exit -9, "
                        f"as a trainer_kill ends the run)")
            raise RuntimeError(f"{who} {why}; every rank stopped\n{tails}")
        sys.stdout.write(_tail(rundir, 0, limit=None))
        sys.stdout.flush()
        return [torch.load(os.path.join(rundir, f"rank{r}.result.pt"),
                           weights_only=False) for r in range(nprocs)]
    finally:
        _kill(procs)
        for log in logs:
            log.close()
        shutil.rmtree(rundir, ignore_errors=True)


def _exit_words(code: int) -> str:
    return ("was killed by SIGKILL (exit -9)" if code == -9
            else f"exited {code}")


def _kill(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            pass


def _tail(rundir: str, rank: int, limit: Optional[int] = 6000) -> str:
    try:
        text = Path(rundir, f"rank{rank}.log").read_text(errors="replace")
    except OSError:
        return ""
    return text if limit is None else text[-limit:]


# ---------------------------------------------------------------------------
# Rank (the child)
# ---------------------------------------------------------------------------
def foreign_modules() -> List[str]:
    """Loaded modules of ``jax`` or the reference package (must be none)."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in FOREIGN)


def _rank_main(rundir: str, rank: int) -> None:
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    job = torch.load(os.path.join(rundir, "job.pt"), weights_only=False)
    n = job["nprocs"]
    dev = rank_device(rank, job["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        # load the kernels' libraries (built by the parent) and cuBLAS now,
        # every rank at once, not stage after stage in the first tick
        from repro_torch.kernels import KERNELS
        for k in KERNELS:
            k.lib()
        torch.ones(8, 8, device=dev) @ torch.ones(8, 8, device=dev)
    else:
        # the ranks share the host's cores: one thread each
        torch.set_num_threads(1)
    dist.init_process_group(
        job["backend"], init_method=job["init"], world_size=n, rank=rank,
        timeout=datetime.timedelta(seconds=job["timeout_s"]))
    if dev.type == "cuda":
        # the first non-reentrant checkpoint imports torch._dynamo (with a
        # process group up, FSDP and DTensor too: seconds); paid here,
        # every rank at once, it is not paid stage after stage in the
        # card's first tick (the CPU's ranks, which time nothing, pay it
        # at their first checkpoint, if any)
        from torch.utils.checkpoint import checkpoint
        checkpoint(torch.neg, torch.ones(1, requires_grad=True),
                   use_reentrant=False)
    try:
        mesh = make_host_mesh(job["data"], n // job["data"], device=dev,
                              backend=job["backend"])
        mod, fn = job["target"].split(":")
        out = getattr(importlib.import_module(mod), fn)(mesh,
                                                        **job["kwargs"])
        bad = foreign_modules()
        if bad:
            raise RuntimeError(f"rank {rank} loaded {bad[:5]}: the port "
                               f"imports no jax and nothing of repro")
        tmp = os.path.join(rundir, f"rank{rank}.result.tmp")
        torch.save(out, tmp)
        os.replace(tmp, os.path.join(rundir, f"rank{rank}.result.pt"))
        # no rank leaves before every result is written
        dist.barrier()
    finally:
        dist.destroy_process_group()


def ensure_arch(cfg) -> None:
    """Register ``cfg`` (a ``ModelConfig`` the parent may have registered
    at run time) unless this rank's registry has its name."""
    if cfg is None:
        return
    from repro_torch.configs.base import get_config, register
    try:
        get_config(cfg.name)
    except KeyError:
        register(cfg)


def launch_counts() -> Dict[str, Dict[str, int]]:
    """This process's kernel launch counters ({name: {launches, tc, bwd,
    split}})."""
    from repro_torch.kernels import KERNELS
    return {k.name: {"launches": k.launches, "tc": k.launches_tc,
                     "bwd": k.launches_bwd, "split": k.launches_split}
            for k in KERNELS}


def handoff_probe(mesh, shape=(2, 1024, 960), reps: int = 20,
                  warmup: int = 3) -> Dict[str, Any]:
    """The hand-off's own cost between ranks 0 and 1: a carry-sized fp32
    tensor sent back and forth ``reps`` times with both sides waiting, the
    card idle otherwise.  Returns the mean one-way ms, and the share of it
    spent in the device <-> host staging copies (zero without staging)."""
    if mesh.rank > 1:
        return {"rank": mesh.rank}
    peer = 1 - mesh.rank
    x = torch.randn(shape, device=mesh.device)
    buf = torch.empty_like(x)
    comm = mesh.comm

    def ping():
        if mesh.rank == 0:
            comm.send(x, peer)
            comm.recv(buf, peer)
        else:
            comm.recv(buf, peer)
            comm.send(buf, peer)

    for _ in range(warmup):
        ping()
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    copy0 = comm.stats["copy_s"]
    t0 = time.perf_counter()
    for _ in range(reps):
        ping()
    took = time.perf_counter() - t0
    return {"rank": mesh.rank, "bytes": x.numel() * x.element_size(),
            "one_way_ms": took * 1e3 / (2 * reps),
            "copy_ms": (comm.stats["copy_s"] - copy0) * 1e3 / (2 * reps),
            "equal": bool(torch.equal(buf, x))}


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))

"""A mesh of ranks, and the logical mesh of the dry run — the port's
counterpart of ``repro.launch.mesh``.

The reference lays S pipeline stages and D data replicas out as a
``data x model`` mesh of devices.  Here each cell of that mesh is one OS
process (a rank of ``torch.distributed``), and a ``Mesh`` holds the
process groups its axes need:

  * ``model_group``: the pipeline ring of this rank's data row (stage s
    hands its carry to stage s+1 of the same row);
  * ``data_group``: the data replicas of this rank's stage column (the
    gradients of a stage are summed over it);
  * ``world_group``: every rank of the mesh, over which the loss's
    numerator and denominator are summed (None: the mesh is the whole
    launch, the default group).

The layout is data-major, as the reference's ``_devices_for`` orders
devices: rank ``d * model + s`` runs stage s of data replica d.  A world of
fewer stages after a resize runs on a subset of the launch's ranks: the
columns of its workers (``make_submesh(data, k, ranks=...)``, ranks
``d * S0 + column``); a rank outside it is not a ``member`` and holds no
group of it.  Collectives and point-to-point transfers go through
``mesh.comm`` (``launch.dist.Comm``, one per rank, shared by every world's
mesh), which stages CUDA tensors through host buffers when the backend is
``gloo``.

A ``LogicalMesh`` is the other kind: axis names and sizes, no process and
no group.  The dry run (``launch.dryrun``) places its input specs on one,
as the reference places its on placeholder devices:
``make_production_mesh()`` is the reference's 16 x 16 ``("data",
"model")`` mesh, ``make_production_mesh(multi_pod=True)`` its 2 x 16 x 16
``("pod", "data", "model")`` one.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class LogicalMesh:
    """Axis names and sizes of a mesh of cards, with no process behind it
    (the dry run's placement target)."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        n = 1
        for a in self.axis_sizes:
            n *= a
        return n


def make_production_mesh(*, multi_pod: bool = False) -> LogicalMesh:
    """The reference's production mesh: 16 x 16 (data x model) = 256
    cards, or 2 x 16 x 16 (pod x data x model) = 512."""
    if multi_pod:
        return LogicalMesh(("pod", "data", "model"), (2, 16, 16))
    return LogicalMesh(("data", "model"), (16, 16))


@dataclasses.dataclass
class Mesh:
    """This rank's view of a ``data x model`` mesh of ranks."""
    data: int
    model: int
    rank: int
    ranks: List[int]            # the mesh's global ranks, data-major
    device: torch.device
    backend: str
    model_group: Any = None     # None: the default group covers the ring
    data_group: Any = None
    comm: Any = None            # launch.dist.Comm
    world_group: Any = None     # None: the mesh is the whole launch

    axis_names = ("data", "model")

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}

    @property
    def member(self) -> bool:
        """Whether this rank runs a cell of the mesh."""
        return self.rank in self.ranks

    @property
    def leader(self) -> int:
        """The global rank of the mesh's first cell (stage 0, replica 0):
        its clocks are the ones every rank's decisions read."""
        return self.ranks[0]

    @property
    def index(self) -> int:
        return self.ranks.index(self.rank)

    @property
    def stage(self) -> int:
        """This rank's pipeline stage (its position on the model ring)."""
        return self.index % self.model

    @property
    def replica(self) -> int:
        """This rank's data replica (its row of the mesh)."""
        return self.index // self.model

    def rank_of(self, stage: int, replica: Optional[int] = None) -> int:
        """The global rank that runs ``stage`` of ``replica`` (default:
        this rank's replica)."""
        d = self.replica if replica is None else replica
        return self.ranks[d * self.model + stage]


def make_submesh(data: int, model: int, ranks: Optional[Sequence[int]] = None,
                 *, device=None, backend: Optional[str] = None,
                 comm=None) -> Mesh:
    """A mesh over an explicit rank subset (default: the first
    ``data * model`` ranks of the world).  Every rank of the world must call
    it with the same arguments: ``torch.distributed.new_group`` is
    collective.  ``comm`` (a ``launch.dist.Comm``) is shared with the
    caller's other meshes; default: a new one.  Raises when the world has
    fewer ranks than the mesh needs."""
    import torch.distributed as dist

    from repro_torch.launch.dist import SOLO, Comm

    world = dist.get_world_size()
    rank = dist.get_rank()
    ranks = list(range(data * model)) if ranks is None else list(ranks)
    if len(ranks) != data * model:
        raise ValueError(f"submesh needs {data * model} ranks (data={data} "
                         f"x model={model}), got {len(ranks)}")
    if len(ranks) > world:
        raise ValueError(f"submesh needs {len(ranks)} ranks, the world has "
                         f"{world}")
    backend = backend or dist.get_backend()
    full = len(ranks) == world
    dev = torch.device("cpu" if device is None else device)
    comm = Comm(backend, dev) if comm is None else comm

    def group(members):
        # new_group is collective over the whole world: every rank makes
        # every group, in the same order
        if len(members) == 1:
            return SOLO
        if full and len(members) == world and members == sorted(members):
            return None
        g = dist.new_group(members)
        if members != sorted(members):
            # the group orders its ranks by global rank; a gather over it
            # is put back into the mesh's (stage) order
            comm.order[id(g)] = [sorted(members).index(r) for r in members]
        return g

    rows = [[ranks[d * model + s] for s in range(model)]
            for d in range(data)]
    cols = [[ranks[d * model + s] for d in range(data)]
            for s in range(model)]
    row_groups = [group(r) for r in rows]
    col_groups = [group(c) for c in cols]
    # with one replica the ring is every rank of the mesh
    whole = row_groups[0] if data == 1 else group(ranks)
    mesh = Mesh(data=data, model=model, rank=rank, ranks=ranks,
                device=dev, backend=backend, comm=comm)
    if rank in ranks:
        mesh.model_group = row_groups[mesh.replica]
        mesh.data_group = col_groups[mesh.stage]
        mesh.world_group = whole
    return mesh


def make_host_mesh(data: int = 1, model: int = 4, *, device=None,
                   backend: Optional[str] = None) -> Mesh:
    """The mesh over every rank of the world, ``data x model`` of them."""
    return make_submesh(data, model, device=device, backend=backend)


def data_axes(mesh) -> tuple:
    """The data-parallel axes of a mesh (everything but the pipeline)."""
    return tuple(a for a in mesh.axis_names if a != "model")


def dp_degree(mesh) -> int:
    """The number of data replicas (the product of the data axes)."""
    if mesh is None:
        return 1
    n = 1
    for a in data_axes(mesh):
        n *= mesh.shape[a]
    return int(n)

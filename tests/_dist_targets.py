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

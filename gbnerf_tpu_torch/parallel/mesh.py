"""Process group, device mesh and collectives: the port's communication
backend.

Port of gbnerf_tpu/parallel/mesh.py. The JAX package lays one SPMD program
over a ``jax.sharding.Mesh`` and lets XLA insert the collectives. Here each
device is a process (``torchrun``), parameters are replicated, the ray or
sample batch is split by rows over the ``data`` axis (and, with guidance
tensor parallelism, the SD towers' channels over ``model``), and the
collectives are explicit:

- ``gather``: an all-gather of a leading or channel axis whose backward
  all-reduces the cotangent and keeps this rank's slice, so that a loss
  computed whole on every rank from the gathered value differentiates as
  in one process once the gradients are averaged (``average_grads``);
- ``average_grads``: one all-reduce of the flattened gradients, over the
  world, divided by its size.

Every rank draws the global batch from one identically seeded generator
and keeps its rows (``RowShard``); the draws inside a render are made at
the global batch's size too (``global_rows``, ``draw``), so an N-rank step
is the one-process step up to the order of its sums.
"""
from __future__ import annotations

import contextlib
import contextvars
import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..utils import jax_random as jr


def init_distributed(device="cuda", backend: Optional[str] = None
                     ) -> torch.device:
    """Join the process group that ``torchrun`` describes in the
    environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT)
    and return this rank's device: ``cuda:LOCAL_RANK`` for a CUDA
    ``device``, the CPU for ``cpu``. Outside torchrun (no WORLD_SIZE) it
    joins nothing and returns ``device`` as given.

    backend: None → nccl on the card, gloo on the CPU. More ranks than
    cards is refused unless the caller passed ``backend="gloo"``: then the
    ranks share the cards round-robin (NCCL refuses two ranks on one
    device)."""
    device = torch.device(device)
    if "WORLD_SIZE" not in os.environ:
        return device
    local = int(os.environ.get("LOCAL_RANK", 0))
    chosen = backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        n_cards = torch.cuda.device_count()
        if local >= n_cards and backend != "gloo":
            raise SystemExit(
                f"local rank {local} has no card of its own ({n_cards} "
                "visible): launch fewer ranks, or pass --dist_backend gloo "
                "to let the ranks share the cards")
        device = torch.device("cuda", local % n_cards)
        torch.cuda.set_device(device)
    elif chosen == "nccl":
        raise SystemExit("the nccl backend needs CUDA devices: use gloo on "
                         "the CPU")
    if not dist.is_initialized():
        dist.init_process_group(chosen)
    return device


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _device_type() -> str:
    # the mesh's device type names only its process groups' default
    # backend: gloo's carry CPU and CUDA tensors alike
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(num_devices: int = 0, axis: str = "data") -> DeviceMesh:
    """A 1-D mesh over every rank, its axis named ``axis``. num_devices 0
    means the world size; any other count must equal it (a rank cannot sit
    out of the program)."""
    n = world_size()
    if num_devices and num_devices != n:
        raise ValueError(f"a mesh of {num_devices} devices needs as many "
                         f"ranks; the world has {n}")
    return init_device_mesh(_device_type(), (n,), mesh_dim_names=(axis,))


def make_mesh_2d(dcn: int, ici: int = 0,
                 axes: tuple = ("dcn", "data")) -> DeviceMesh:
    """A 2-D mesh dcn × ici over every rank (ici 0: the world size / dcn),
    row-major as the JAX package reshapes its devices; with
    axes=("data", "model") it is the guidance tensor-parallel layout."""
    n = world_size()
    ici = ici or n // dcn
    if dcn * ici != n:
        raise ValueError(f"a {dcn} × {ici} mesh needs {dcn * ici} ranks; the "
                         f"world has {n}")
    return init_device_mesh(_device_type(), (dcn, ici), mesh_dim_names=axes)


def _axes(axis) -> tuple:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def axis_size(mesh: Optional[DeviceMesh], axis="data") -> int:
    """The number of ranks along ``axis`` (a name or a tuple of names: the
    product), 1 without a mesh or for an axis the mesh lacks."""
    if mesh is None:
        return 1
    names = mesh.mesh_dim_names
    out = 1
    for a in _axes(axis):
        if a in names:
            out *= mesh.size(names.index(a))
    return out


def axis_rank(mesh: Optional[DeviceMesh], axis="data") -> int:
    """This rank's coordinate along ``axis`` (row-major over a tuple)."""
    if mesh is None:
        return 0
    names = mesh.mesh_dim_names
    out = 0
    for a in _axes(axis):
        if a in names:
            out = out * mesh.size(names.index(a)) + mesh.get_local_rank(a)
    return out


def axis_group(mesh: DeviceMesh, axis="data"):
    """The process group of the ranks that differ only along ``axis``."""
    names = tuple(a for a in _axes(axis) if a in mesh.mesh_dim_names)
    if len(names) == 1:
        return mesh.get_group(names[0])
    if len(names) == len(mesh.mesh_dim_names):
        return dist.group.WORLD
    raise ValueError(f"no group for the axes {names} of a mesh "
                     f"{mesh.mesh_dim_names}")


def pad_to_multiple(n: int, m: int) -> int:
    return -(-n // m) * m


@dataclass(frozen=True)
class RowShard:
    """This rank's contiguous rows of an n-row leading axis split over
    ``world`` ranks: rows [start, stop), padded to ``rows`` (every rank
    holds the same count, pad_to_multiple(n, world) / world; the rows JAX's
    P("data") gives device ``index`` when n divides)."""

    n: int
    index: int
    world: int

    @property
    def rows(self) -> int:
        return pad_to_multiple(self.n, self.world) // self.world

    @property
    def start(self) -> int:
        return min(self.index * self.rows, self.n)

    @property
    def stop(self) -> int:
        return min(self.start + self.rows, self.n)

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """x[start:stop], padded to ``rows`` with copies of x's last row
        (finite, and cut off again by ``gather``)."""
        part = x[self.start:self.stop]
        short = self.rows - part.shape[0]
        if short:
            part = torch.cat([part, x[-1:].expand((short,) + x.shape[1:])])
        return part


def data_sharding(mesh: Optional[DeviceMesh], n: int,
                  axis="data") -> RowShard:
    """The rows of an n-row batch that this rank holds."""
    return RowShard(n, axis_rank(mesh, axis), axis_size(mesh, axis))


def shard_batch(mesh: Optional[DeviceMesh], batch, axis="data"):
    """A dict (nested) or tensor of [N, ...] batches → this rank's rows of
    each; the identity without a mesh."""
    if mesh is None or batch is None:
        return batch
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v, axis) for k, v in batch.items()}
    return data_sharding(mesh, batch.shape[0], axis).take(batch)


def constrain_data(x, mesh: Optional[DeviceMesh], axis="data"):
    """This rank's rows of x over ``axis``; the identity without a mesh."""
    return shard_batch(mesh, x, axis)


@torch.no_grad()
def replicate(mesh: Optional[DeviceMesh], tree):
    """Broadcast every tensor of a dict, list or module from rank 0 in
    place; returns the tree. The identity without a mesh."""
    if mesh is None:
        return tree
    if isinstance(tree, torch.nn.Module):
        tensors = list(tree.parameters()) + list(tree.buffers())
    elif isinstance(tree, dict):
        tensors = list(tree.values())
    elif isinstance(tree, torch.Tensor):
        tensors = [tree]
    else:
        tensors = list(tree)
    for t in tensors:
        _collective("broadcast", t, lambda: dist.broadcast(t, src=0))
    return tree


def _collective(name: str, x: torch.Tensor, fn) -> None:
    """Run a collective; a backend that lacks it for this dtype and device
    raises, naming the collective, the dtype, the device and the backend
    (no route through the host is taken behind the caller's back)."""
    try:
        fn()
    except (RuntimeError, ValueError) as e:
        raise RuntimeError(
            f"{name} of {x.dtype} on {x.device.type} is not supported by the "
            f"{dist.get_backend()} backend: {e}") from e


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """In place: x ← Σ over the group's ranks of x."""
    _collective("all_reduce", x, lambda: dist.all_reduce(x, group=group))
    return x


def all_reduce_max(x: torch.Tensor, group=None) -> torch.Tensor:
    """In place: x ← the largest over the group's ranks of x."""
    _collective("all_reduce", x, lambda: dist.all_reduce(
        x, op=dist.ReduceOp.MAX, group=group))
    return x


def all_gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's x, concatenated along ``dim`` in rank order."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    xc = x.contiguous()
    _collective("all_gather", x, lambda: dist.all_gather(parts, xc,
                                                         group=group))
    return torch.cat(parts, dim=dim)


class _Gather(torch.autograd.Function):
    """Forward: the group's slices concatenated along ``dim``, cut to n.
    Backward: the cotangent summed over the group, this rank's slice of it
    (a reduce-scatter as an all-reduce and a slice)."""

    @staticmethod
    def forward(ctx, x, group, index, dim, n):
        ctx.group, ctx.index, ctx.dim = group, index, dim
        ctx.rows, ctx.n_full = x.shape[dim], None
        out = all_gather_cat(x, group, dim)
        ctx.n_full = out.shape[dim]
        return out.narrow(dim, 0, n)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[ctx.dim]
        if n < ctx.n_full:
            pad = list(g.shape)
            pad[ctx.dim] = ctx.n_full - n
            g = torch.cat([g, g.new_zeros(pad)], dim=ctx.dim)
        # a copy: autograd may hand the same cotangent to other branches
        g = all_reduce_sum(g.clone(memory_format=torch.contiguous_format),
                           ctx.group)
        return (g.narrow(ctx.dim, ctx.index * ctx.rows, ctx.rows),
                None, None, None, None)


def gather(x: torch.Tensor, mesh: Optional[DeviceMesh], axis="data",
           dim: int = 0, n: Optional[int] = None) -> torch.Tensor:
    """Gather every rank's slice of ``axis`` (equal sizes, rank order)
    along ``dim``, cut to ``n`` (default: all); differentiable, see
    _Gather. The identity without a mesh or on an axis of size 1."""
    if mesh is None or axis_size(mesh, axis) == 1:
        return x if n is None else x.narrow(dim, 0, n)
    dim = dim % x.dim()
    total = x.shape[dim] * axis_size(mesh, axis)
    return _Gather.apply(x, axis_group(mesh, axis), axis_rank(mesh, axis),
                         dim, total if n is None else n)


class _MeanGrad(torch.autograd.Function):
    """Forward: the identity. Backward: the cotangent averaged over the
    group (the entry of a tensor-parallel layer, parallel/tp.py)."""

    @staticmethod
    def forward(ctx, x, group, size):
        ctx.group, ctx.size = group, size
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)   # see _Gather
        return all_reduce_sum(g, ctx.group) / ctx.size, None, None


def mean_grad(x: torch.Tensor, mesh: Optional[DeviceMesh],
              axis="model") -> torch.Tensor:
    if mesh is None or axis_size(mesh, axis) == 1:
        return x
    return _MeanGrad.apply(x, axis_group(mesh, axis), axis_size(mesh, axis))


@torch.no_grad()
def average_grads(params, mesh: Optional[DeviceMesh]) -> None:
    """Replace each parameter's .grad by its mean over every rank of the
    mesh: one all-reduce of the flattened gradients for each dtype.
    Parameters without a gradient are skipped (alike on every rank: the
    ranks run one graph)."""
    if mesh is None or dist.get_world_size() == 1:
        return
    by_dtype = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p)
    n = dist.get_world_size()
    for ps in by_dtype.values():
        flat = torch.cat([p.grad.reshape(-1) for p in ps])
        all_reduce_sum(flat)
        flat /= n
        off = 0
        for p in ps:
            k = p.grad.numel()
            p.grad.copy_(flat[off:off + k].view_as(p.grad))
            off += k


# ---------------- the draws of a sharded batch ----------------

_ROWS: contextvars.ContextVar = contextvars.ContextVar("global_rows",
                                                       default=None)


@contextlib.contextmanager
def global_rows(shard: Optional[RowShard]):
    """Within the block, ``draw`` makes each random tensor at the global
    batch's ``shard.n`` rows and keeps this rank's. None: no effect."""
    token = _ROWS.set(shard)
    try:
        yield
    finally:
        _ROWS.reset(token)


def draw(kind: str, shape, generator, dtype=torch.float32, device=None
         ) -> torch.Tensor:
    """A random tensor of ``shape`` from ``generator``: "rand" (uniform in
    [0, 1)), "randn" or "exponential" (rate 1); a ``JaxKey`` draws the JAX
    package's values (utils/jax_random.py). Inside ``global_rows`` the
    leading axis is this rank's rows of the batch: the draw is made at the
    global row count, as one process makes it, and rows [start, stop)
    are kept (zero rows pad it to the rank's count). So a ``JaxKey``
    draws what the JAX package's SPMD step draws: its global array, whose
    values do not depend on the sharding."""
    shard = _ROWS.get()
    shape = tuple(shape)
    full = shape if shard is None else (shard.n,) + shape[1:]
    x = jr.draw(kind, full, generator, dtype, device)
    if shard is None:
        return x
    if shape[0] != shard.rows:
        raise ValueError(f"a draw of {shape[0]} rows inside a shard of "
                         f"{shard.rows}")
    part = x[shard.start:shard.stop]
    short = shard.rows - part.shape[0]
    if short:
        part = torch.cat([part, part.new_zeros((short,) + shape[1:])])
    return part

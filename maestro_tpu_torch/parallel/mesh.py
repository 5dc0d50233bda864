"""Process mesh and placement rules: data x tensor parallel, optional FSDP.

The reference delegates all parallelism to Lightning DDP over NCCL
(conf/trainer.py:12-14); the JAX package lays one ``Mesh`` with axes
``("data", "model")`` (or ``("replica", "data", "model")``) over its
devices and lets XLA insert the collectives.  Here one process drives one
device, and the mesh is a ``DeviceMesh`` over the processes with the same
axis names and the JAX package's -1 rule and error texts.

* The batch is sharded over the batch axes (``"replica"`` then ``"data"``):
  each data-parallel rank holds its rows (``Parallel.shard_batch``).
* Tensor parallelism by head over ``"model"`` when that axis is > 1, with
  the JAX package's rules (``param_spec``): ``qkv``, ``fc1`` and ``to_kv``
  are split by output feature (their biases with them), ``out`` and ``fc2``
  by input feature.  The fused ``qkv`` is split by head WITHIN each of q, k
  and v (and ``to_kv`` within k and v), so a rank's attention gets H / tp
  whole heads; the row-split layers all-reduce their partial products before
  the bias.  The date pool's kernel takes the whole ``to_kv`` weight, which
  is gathered before the pool (and its gradient sliced back).
* ``fsdp=True`` shards every parameter (and so its gradient and AdamW
  moments) over ``"data"`` with FSDP2 ``fully_shard``, a unit per block and
  head (``fsdp_units``), so that one unit at a time is gathered whole, as
  the JAX package gathers each parameter where it is used; under a replica axis
  it is HSDP: sharded over ``"data"``, replicated over ``"replica"``, as the
  JAX package's multi-slice FSDP shards only within a slice.
* Without FSDP, data parallelism is DDP over the batch axes; a phase is
  wrapped after its frozen roles stop requiring gradients (``for_phase``).

A train step under any of these gives the gradients of the GLOBAL batch, as
the JAX package's jit over sharded arrays does: losses divide by the
all-reduced count of the global batch (``count_reduce``) and are scaled by
the data-parallel size, which the gradient average divides back out.
"""

from __future__ import annotations

import gc
from typing import Any

import torch
import torch.distributed as dist
from torch import nn

from maestro_tpu_torch.parallel.distributed import process_count
from maestro_tpu_torch.port.from_jax import flax_path

DATA_AXIS = "data"
MODEL_AXIS = "model"
REPLICA_AXIS = "replica"  # outer pure-DP axis


# --------------------------------------------------------------------------
# the mesh
# --------------------------------------------------------------------------
def mesh_shape(n: int, num_data: int = -1, num_model: int = 1,
               num_replica: int = 1) -> tuple[int, int, int]:
    """(replica, data, model) sizes over ``n`` processes; ``num_data=-1``
    takes every process left (the JAX package's ``make_mesh`` rule and
    errors, one device per process)."""
    if num_data == -1:
        per_replica = n // num_replica
        if n % num_replica or per_replica % num_model:
            msg = (
                f"{n} devices not divisible into {num_replica} replicas "
                f"x model axis {num_model}."
            )
            raise ValueError(msg)
        num_data = per_replica // num_model
    need = num_replica * num_data * num_model
    if n < need:
        msg = (
            f"mesh ({num_replica} replica x {num_data} data x {num_model} "
            f"model) needs {need} devices but only {n} are available "
            "(one per process). Start that many processes (torchrun "
            "--nproc_per_node=N)."
        )
        raise ValueError(msg)
    if n > need:
        msg = (
            f"mesh ({num_replica} replica x {num_data} data x {num_model} model) "
            f"uses {need} of {n} processes; every process must be in the mesh."
        )
        raise ValueError(msg)
    return num_replica, num_data, num_model


def make_mesh(num_data: int = -1, num_model: int = 1, num_replica: int = 1,
              device_type: str = "cuda"):
    """A ``DeviceMesh`` over the processes of the default group, axes
    ``("data", "model")``, or ``("replica", "data", "model")`` when
    ``num_replica > 1``."""
    from torch.distributed.device_mesh import init_device_mesh

    r, d, m = mesh_shape(process_count(), num_data, num_model, num_replica)
    if r == 1:
        return init_device_mesh(device_type, (d, m), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    return init_device_mesh(device_type, (r, d, m),
                            mesh_dim_names=(REPLICA_AXIS, DATA_AXIS, MODEL_AXIS))


def batch_axes(mesh) -> tuple[str, ...]:
    """Mesh axes the batch dim is sharded over (replica-major when present)."""
    if REPLICA_AXIS in mesh.mesh_dim_names:
        return (REPLICA_AXIS, DATA_AXIS)
    return (DATA_AXIS,)


def num_batch_shards(mesh) -> int:
    """Total data-parallel ways (replicas x the data axis)."""
    n = 1
    for axis in batch_axes(mesh):
        n *= mesh.size(mesh.mesh_dim_names.index(axis))
    return n


def batch_shard_index(mesh) -> int:
    """This process's index over the batch axes (replica-major): the shard of
    every batch it holds."""
    names = mesh.mesh_dim_names
    coord = mesh.get_coordinate()
    index = 0
    for axis in batch_axes(mesh):
        i = names.index(axis)
        index = index * mesh.size(i) + coord[i]
    return index


# --------------------------------------------------------------------------
# placement rules (the JAX package's _param_spec, on flax paths)
# --------------------------------------------------------------------------
def jax_param_spec(path: tuple[str, ...], ndim: int, tp: bool) -> tuple:
    """The JAX package's PartitionSpec of a parameter by its flax path, as a
    tuple of axis names (``None`` for a replicated dim), in flax layout."""
    if not tp:
        return ()
    joined = "/".join(path)
    if ndim < 2:
        return (MODEL_AXIS,) if joined.endswith(("qkv/bias", "fc1/bias", "to_kv/bias")) else ()
    if joined.endswith(("qkv/kernel", "fc1/kernel")) or "to_kv/kernel" in joined:
        return (None, MODEL_AXIS)
    if joined.endswith(("out/kernel", "fc2/kernel")):
        return (MODEL_AXIS, None)
    return ()


def param_spec(model: nn.Module, name: str, tp: bool) -> tuple:
    """The placement of ``model``'s parameter ``name`` over the model axis, in
    the port's layout: the JAX rule on its flax path (``port.from_jax``),
    reversed for a transposed Dense kernel, padded to the tensor's rank."""
    p = model.get_parameter(name)
    path, transpose = flax_path(model, name)
    spec = jax_param_spec(path, p.ndim, tp)
    spec = tuple(spec) + (None,) * (p.ndim - len(spec))
    return spec[::-1] if transpose else spec


# --------------------------------------------------------------------------
# tensor-parallel collectives (Megatron's f and g) and the head split
# --------------------------------------------------------------------------
class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the gradient is summed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromGroup(torch.autograd.Function):
    """Sum over the group forward; the gradient passes as it is."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromGroup.apply(x, group)


def head_piece(full: torch.Tensor, dim: int, parts: int, n: int, k: int) -> torch.Tensor:
    """Rank ``k`` of ``n``'s piece of ``full`` split along ``dim``: each of the
    ``parts`` equal segments (q, k, v of a fused projection) is cut in ``n``
    and the rank keeps its cut of every segment."""
    return torch.cat([c.chunk(n, dim)[k] for c in full.chunk(parts, dim)], dim)


def join_pieces(pieces: list[torch.Tensor], dim: int, parts: int) -> torch.Tensor:
    """The inverse of ``head_piece`` over the ranks' pieces, in rank order."""
    split = [p.chunk(parts, dim) for p in pieces]
    return torch.cat([torch.cat([s[j] for s in split], dim) for j in range(parts)], dim)


class _GatherPieces(torch.autograd.Function):
    """The whole tensor from every rank's piece; the gradient of the whole
    (the same on every rank: what reads it is replicated) is sliced back to
    this rank's piece."""

    @staticmethod
    def forward(ctx, x, group, dim, parts):
        ctx.group, ctx.dim, ctx.parts = group, dim, parts
        pieces = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(pieces, x.contiguous(), group=group)
        return join_pieces(pieces, dim, parts)

    @staticmethod
    def backward(ctx, g):
        n, k = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return head_piece(g, ctx.dim, ctx.parts, n, k).contiguous(), None, None, None


def gather_pieces(x: torch.Tensor, group, dim: int, parts: int) -> torch.Tensor:
    return _GatherPieces.apply(x, group, dim, parts)


_FUSED_PARTS = {"qkv": 3, "to_kv": 2}  # the segments a fused projection's rows hold


def tp_layout(model: nn.Module) -> dict[str, tuple[int, int]]:
    """Parameter name -> (dim, parts) of every tensor-parallel split: the
    placement rules (``param_spec``) on the parameters of the modules that
    run split (``models.vit``'s attention, MLP and date pool); ``parts`` is
    the number of segments (q, k, v) each cut by head.  Every other
    parameter is replicated over the model axis."""
    from maestro_tpu_torch.models.vit import Attention, AttentiveReduce, FeedForward

    out = {}
    for mname, mod in model.named_modules():
        if not isinstance(mod, (Attention, FeedForward, AttentiveReduce)):
            continue
        for pname, _ in mod.named_parameters():
            name = f"{mname}.{pname}" if mname else pname
            spec = param_spec(model, name, tp=True)
            if MODEL_AXIS in spec:
                out[name] = (spec.index(MODEL_AXIS), _FUSED_PARTS.get(pname.split(".")[0], 1))
    return out


def check_tp_split(model: nn.Module, n: int) -> None:
    """Refuse a tensor-parallel size that does not divide every split
    module's heads (attention, date pool) and MLP width."""
    from maestro_tpu_torch.models.vit import Attention, AttentiveReduce, FeedForward

    for name, mod in model.named_modules():
        if isinstance(mod, (Attention, AttentiveReduce)) and mod.heads % n:
            kind = "attention" if isinstance(mod, Attention) else "pool"
            msg = (f"{name}: {mod.heads} {kind} heads do not split over "
                   f"trainer.mesh_model={n}")
            raise ValueError(msg)
        if isinstance(mod, FeedForward) and mod.fc1.out_features % n:
            msg = f"{name}: MLP width {mod.fc1.out_features} does not split over {n}"
            raise ValueError(msg)


def fsdp_units(model: nn.Module) -> list[nn.Module]:
    """The modules FSDP2 shards as units of their own, inner before outer:
    every transformer block (``models.vit.Block``, the baselines'
    ``EncoderBlock``) and every head.  Each reads its parameters only inside
    its own forward, where FSDP2 has them gathered."""
    from maestro_tpu_torch.baselines.backbone import EncoderBlock
    from maestro_tpu_torch.models.vit import Block

    units = [m for m in model.modules() if isinstance(m, (Block, EncoderBlock))]
    heads = getattr(model, "heads", None)
    if isinstance(heads, nn.ModuleDict):
        units += list(heads.values())
    return units


def resharded(model: nn.Module) -> nn.Module:
    """``model`` with FSDP2's sharded parameters registered: a forward with
    no backward (an eval pass) leaves the root's gathered parameters in
    place, and what reads parameters by name (the optimizer's state, EMA,
    checkpoints) means the sharded ones.  Any other model as it is."""
    if hasattr(model, "reshard"):
        model.reshard()
    return model


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a parameter or gradient (a DTensor's local
    tensor; any other tensor as it is)."""
    return t.to_local() if hasattr(t, "to_local") else t


# --------------------------------------------------------------------------
# one model placed on the mesh
# --------------------------------------------------------------------------
class Parallel:
    """``model`` placed on ``mesh``: tensor-parallel pieces over the model
    axis, FSDP2 over the batch axes with ``fsdp``, and the groups, ranks and
    reductions a train step needs.  ``module`` is what a train step calls:
    the DDP wrapper of the current phase (``for_phase``), else the model.

    Apply it after any warm start (the weights are cut in place).  The model
    keeps its parameter names; the pieces are plain tensors, or FSDP2's
    DTensors, of which the kernels only ever see the gathered plain ones.
    """

    def __init__(self, model: nn.Module, mesh, fsdp: bool = False) -> None:
        self.model, self.mesh, self.fsdp = model, mesh, fsdp
        names = mesh.mesh_dim_names
        grid = mesh.mesh.reshape(-1, mesh.size(names.index(MODEL_AXIS)))  # [dp, tp] ranks
        me = dist.get_rank()
        dp_lists = [grid[:, j].tolist() for j in range(grid.shape[1])]
        tp_lists = [grid[i].tolist() for i in range(grid.shape[0])]
        self.dp_group, _ = dist.new_subgroups_by_enumeration(dp_lists)
        self.tp_group, _ = dist.new_subgroups_by_enumeration(tp_lists)
        self.dp_size, self.tp_size = grid.shape
        mine = (grid == me).nonzero()[0].tolist()
        self.dp_rank, self.tp_rank = int(mine[0]), int(mine[1])
        self.layout: dict[str, tuple[int, int]] = {}
        self._ddp = None
        self.module: nn.Module = model
        if self.tp_size > 1:
            self._split_heads()
        self.fsdp_units = 0
        if fsdp:
            from torch.distributed.fsdp import fully_shard

            # one unit per block and head, then the root (what is left: the
            # embeddings, the final norms, the mask tokens): only one unit's
            # parameters are gathered whole at a time
            shard_mesh = mesh[batch_axes(mesh)]
            for unit in [*fsdp_units(model), model]:
                fully_shard(unit, mesh=shard_mesh, reshard_after_forward=True)
                self.fsdp_units += 1

    def describe(self) -> dict:
        """The placement as a run records it (``meta.json``): the mesh's
        axes, FSDP and its units, and how many parameters are sharded
        (FSDP2's DTensors) or split by head, of how many."""
        params = list(resharded(self.model).parameters())
        return {
            "mesh": dict(zip(self.mesh.mesh_dim_names, self.mesh.mesh.shape, strict=True)),
            "processes": dist.get_world_size(),
            "fsdp": self.fsdp,
            "fsdp_units": self.fsdp_units,
            "sharded_parameters": sum(hasattr(p, "placements") for p in params),
            "head_split_parameters": len(self.layout),
            "parameters": len(params),
        }

    # -- placement ------------------------------------------------------
    @torch.no_grad()
    def _split_heads(self) -> None:
        from maestro_tpu_torch.models.vit import Attention, AttentiveReduce, FeedForward

        n, k, group = self.tp_size, self.tp_rank, self.tp_group
        check_tp_split(self.model, n)
        self.layout = tp_layout(self.model)
        for name, (dim, parts) in self.layout.items():
            owner_name, _, attr = name.rpartition(".")
            owner = self.model.get_submodule(owner_name)
            full = getattr(owner, attr)
            setattr(owner, attr, nn.Parameter(head_piece(full.detach(), dim, parts, n, k)))
        for mod in self.model.modules():
            if isinstance(mod, Attention):
                mod.heads //= n
            if isinstance(mod, (Attention, FeedForward, AttentiveReduce)):
                mod.tp = group

    def for_phase(self, roles) -> nn.Module:
        """Make the parameters of ``roles`` (and only those) require
        gradients, and (without FSDP) wrap the model in a DDP over the batch
        axes for this phase; returns the module a train step calls."""
        from maestro_tpu_torch.train.optim import param_role

        for name, p in self.model.named_parameters():
            p.requires_grad_(param_role(name) in roles)
        if self.fsdp:
            return self.module
        if self._ddp is not None:  # the last phase's reducer and its hooks
            self._ddp = self.module = None
            gc.collect()
        from torch.nn.parallel import DistributedDataParallel

        device = next(self.model.parameters()).device
        self._ddp = DistributedDataParallel(
            self.model, process_group=self.dp_group, broadcast_buffers=False,
            device_ids=[device] if device.type == "cuda" else None,
        )
        self.module = self._ddp
        return self.module

    # -- the batch and the reductions of a step --------------------------
    def rows(self, local_batch: int) -> tuple[int, int]:
        """(offset, global batch) of this rank's rows."""
        return self.dp_rank * local_batch, self.dp_size * local_batch

    def shard_batch(self, batch: dict) -> dict:
        """This rank's rows of a global batch."""
        size = next(iter(batch.values())).shape[0]
        if size % self.dp_size:
            msg = f"global batch {size} does not split over {self.dp_size} data-parallel ranks"
            raise ValueError(msg)
        b = size // self.dp_size
        return {k: v[self.dp_rank * b : (self.dp_rank + 1) * b] for k, v in batch.items()}

    def count_reduce(self, count: torch.Tensor) -> torch.Tensor:
        """A count over the global batch (detached: a denominator is a
        constant of the gradient)."""
        count = count.detach().clone()
        dist.all_reduce(count, group=self.dp_group)
        return count

    @property
    def loss_scale(self) -> int:
        """What a rank's loss is multiplied by before ``backward``: the
        gradient average over the data-parallel ranks divides it back out."""
        return self.dp_size

    def global_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """The global batch's loss: the sum of the ranks' parts."""
        return self.count_reduce(loss)

    def sum_states(self, states: dict) -> dict:
        """Metric states summed over the data-parallel ranks, in place."""
        for sub in states.values():
            for t in sub.values():
                dist.all_reduce(t, group=self.dp_group)
        return states

    def gather_objects(self, obj) -> list:
        """``obj`` of every data-parallel rank, in rank order."""
        out: list[Any] = [None] * self.dp_size
        dist.all_gather_object(out, obj, group=self.dp_group)
        return out

    # -- whole tensors for checkpoints -----------------------------------
    def full_tensor(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole tensor of which ``t`` is this rank's part, for the
        parameter ``name`` (the parameter itself, a moment, an EMA copy, an
        accumulator).  Collective: every rank calls it, in the same order."""
        p = resharded(self.model).get_parameter(name)
        if hasattr(t, "full_tensor"):
            t = t.full_tensor()
        elif hasattr(p, "full_tensor"):
            from torch.distributed.tensor import DTensor

            t = DTensor.from_local(t, p.device_mesh, p.placements, shape=p.shape,
                                   stride=p.stride()).full_tensor()
        if name in self.layout:
            dim, parts = self.layout[name]
            pieces = [torch.empty_like(t) for _ in range(self.tp_size)]
            dist.all_gather(pieces, t.contiguous(), group=self.tp_group)
            t = join_pieces(pieces, dim, parts)
        return t

    def local_piece(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's part of the whole tensor ``full`` of parameter ``name``
        (the inverse of ``full_tensor``; no communication)."""
        if name in self.layout:
            dim, parts = self.layout[name]
            full = head_piece(full, dim, parts, self.tp_size, self.tp_rank)
        p = resharded(self.model).get_parameter(name)
        if hasattr(p, "placements"):
            for i, pl in enumerate(p.placements):
                if pl.is_shard():
                    n, k = p.device_mesh.size(i), p.device_mesh.get_local_rank(i)
                    chunks = torch.chunk(full, n, dim=pl.dim)
                    full = chunks[k] if k < len(chunks) else full.narrow(pl.dim, 0, 0)
        return full

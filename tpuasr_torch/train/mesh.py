"""Ranks, their (data, model) grid and the sharding of parameters (port
of ``tpuasr/train/mesh.py``).

The JAX package runs one program over a mesh of local devices and lets
GSPMD insert the collectives; its distributed step is the single-device
step on the global batch. PyTorch's idiom is one process a card, so
here every rank is a process (``distributed_init``, launched by
``cli.multiproc``) and the collectives are ``torch.distributed`` calls
outside the kernels (``tpuasr_torch/parallel.py``, below the model,
which gets its groups from ``shard_model_``). The step stays the
single-device step on the global batch, the ranks' local batches
concatenated in data-rank order:

  * data parallelism: every BatchNorm takes its masked sums over the
    data group (``MaskedBatchNorm``), the loss divides by the global
    count of usable utterances, and the gradients are summed over the
    data group after the backward (``train.step``);
  * tensor parallelism on a (data, model) grid (``make_mesh(world,
    tp)``): rank r has data index r // tp and model index r % tp. The
    leaves of ``TP_SHARDED_LEAVES`` are stored sharded over the model
    group, by the rule of ``param_sharding_specs``. With
    ``direction_tp`` (tp = 2, a bidirectional GRU or LSTM) model rank m
    holds direction m of every recurrent layer and runs its kernel at
    D=1; otherwise the gate axis is split and each layer all-gathers
    its weights before the (replicated) time loop.

The CTC loss needs no collective: its kernels work per utterance, so
each rank's rows are exactly what the JAX package's ``shard_map`` over
``data`` gives each shard (``tpuasr/ctc/loss.py:160-175``).
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from tpuasr_torch.parallel import Group, all_gather, broadcast

MODEL_AXIS = "model"

# parameter leaves whose last (gate) axis, or with direction_tp their
# leading direction axis, shard over the model group
TP_SHARDED_LEAVES = frozenset(
    {"input_kernel", "input_bias", "recurrent_kernel", "recurrent_bias"})

DEFAULT_DIST_URL = "localhost:12355"
TIMEOUT_S = 600.0  # a rank that never arrives fails the collective, not the run's clock


def default_backend(device) -> str:
    """NCCL on a card, gloo on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def distributed_init(dist_url: str | None, world: int, rank: int,
                     backend: str = "nccl") -> None:
    """Join the process group (the reference's
    ``init_process_group(dist_url, ...)``). ``dist_url`` is ``host:port``
    as tpuasr takes it, or a full init method (``tcp://...``,
    ``file://...``); None reads ``TPUASR_COORDINATOR`` (``cli.multiproc``
    sets it) or takes ``DEFAULT_DIST_URL``."""
    url = dist_url or os.environ.get("TPUASR_COORDINATOR") or DEFAULT_DIST_URL
    dist.init_process_group(backend, init_method=url if "://" in url else f"tcp://{url}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))


@dataclass(frozen=True)
class Mesh:
    """A rank's place on the (data, model) grid. ``data`` and ``model``
    are its groups (None where the run has one process); ``control`` is
    a gloo group of every rank for host flags."""

    world: int = 1
    tp: int = 1
    rank: int = 0
    data: Group | None = None
    model: Group | None = None
    control: Group | None = None

    @property
    def data_index(self) -> int:
        return self.rank // self.tp

    @property
    def model_index(self) -> int:
        return self.rank % self.tp

    @property
    def data_size(self) -> int:
        return self.world // self.tp

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def any(self, flag: bool) -> bool:
        """True on every rank when ``flag`` is true on any (a host
        all-reduce, MAX, that never waits for a card)."""
        if self.control is None:
            return flag
        t = torch.tensor([int(flag)], dtype=torch.int64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.control.pg)
        return bool(t.item())


def make_mesh(world: int = 1, tp: int = 1) -> Mesh:
    """This rank's place on a (world // tp, tp) grid. Every rank calls it
    in the same order (it creates every group). Raises where tp does not
    divide the world. Without a process group (one process) it returns
    the single-rank mesh; with one, the groups are made even at size 1,
    so a one-rank run still goes through the collectives."""
    if tp < 1 or world % tp:
        raise ValueError(f"{world} ranks not divisible by tp={tp}")
    if not dist.is_initialized():
        if world > 1:
            raise RuntimeError("a mesh of several ranks needs distributed_init first")
        return Mesh()
    if dist.get_world_size() != world:
        raise ValueError(f"the process group has {dist.get_world_size()} ranks, not {world}")
    rank = dist.get_rank()
    backend = dist.get_backend()
    staged = backend == "gloo"
    n_data = world // tp
    model_pgs = [dist.new_group([d * tp + m for m in range(tp)]) for d in range(n_data)]
    data_pgs = [dist.new_group([d * tp + m for d in range(n_data)]) for m in range(tp)]
    control_pg = dist.group.WORLD if staged else dist.new_group(backend="gloo")
    d, m = divmod(rank, tp)
    return Mesh(world=world, tp=tp, rank=rank,
                data=Group(data_pgs[m], n_data, d, staged),
                model=Group(model_pgs[d], tp, m, staged),
                control=Group(control_pg, world, rank))


def param_sharding_specs(model, tp: int, direction_tp: bool = False) -> dict:
    """{parameter name: spec} with tpuasr's rule
    (``tpuasr/train/mesh.py param_sharding_specs``): a spec is a tuple
    of one entry per axis, ``MODEL_AXIS`` on the sharded one, or () for
    a replicated parameter. The leaves of ``TP_SHARDED_LEAVES`` shard
    their last axis where tp divides it; with ``direction_tp`` their
    leading direction axis of size 2 (tp = 2) instead, and replicate
    when they have none. Everything else replicates."""
    specs = {}
    for name, p in model.named_parameters():
        spec = ()
        if tp > 1 and p.dim() >= 1 and name.rsplit(".", 1)[-1] in TP_SHARDED_LEAVES:
            if direction_tp:
                if p.dim() >= 2 and p.shape[0] == tp == 2:
                    spec = (MODEL_AXIS,)
            elif p.shape[-1] % tp == 0:
                spec = (None,) * (p.dim() - 1) + (MODEL_AXIS,)
        specs[name] = spec
    return specs


def local_shard(t: torch.Tensor, axis: int, mesh: Mesh) -> torch.Tensor:
    """This model rank's slice of a whole tensor along ``axis``."""
    n = t.shape[axis] // mesh.tp
    return t.narrow(axis, mesh.model_index * n, n).contiguous()


def broadcast_module_(module: torch.nn.Module, mesh: Mesh) -> None:
    """Every parameter and buffer as rank 0 holds it (before sharding)."""
    if mesh.control is None:
        return
    world = Group(dist.group.WORLD, mesh.world, mesh.rank, mesh.data.staged)
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            broadcast(t.data, world)


def shard_model_(model, mesh: Mesh, direction_tp: bool = False) -> dict:
    """Put ``model`` (a ``DeepSpeech2`` holding whole weights, the same on
    every rank) on the mesh: each leaf that ``param_sharding_specs``
    shards is replaced by this rank's slice, and the model's BatchNorms
    and recurrent cores are given their groups
    (``DeepSpeech2.set_parallel``). Build the optimizer after this.
    Returns {parameter name: shard axis} of the sharded leaves (also
    ``model.sharded``)."""
    sharded = {}
    if mesh.tp > 1:
        for name, spec in param_sharding_specs(model, mesh.tp, direction_tp).items():
            if MODEL_AXIS not in spec:
                continue
            axis = spec.index(MODEL_AXIS)
            owner_name, leaf = name.rsplit(".", 1)
            owner = model.get_submodule(owner_name)
            full = getattr(owner, leaf)
            setattr(owner, leaf, torch.nn.Parameter(local_shard(full.detach(), axis, mesh)))
            sharded[name] = axis
    model.set_parallel(mesh.data, mesh.model if mesh.tp > 1 else None,
                       "direction" if direction_tp and mesh.tp > 1 else "gate", sharded)
    return sharded


def whole_state(model, mesh: Mesh) -> dict:
    """``model``'s state dict with its sharded leaves (``model.sharded``)
    made whole (every model rank calls it)."""
    sd = model.state_dict()
    return {**sd, **whole_tensors({k: sd[k] for k in model.sharded}, model.sharded, mesh)}


def whole_tensors(named: dict, sharded: dict, mesh: Mesh) -> dict:
    """{name: tensor} with each entry of ``sharded`` ({name: axis}) made
    whole, the model ranks' shards joined along its axis (a collective
    of the model group: every model rank calls it)."""
    return {k: torch.cat(list(all_gather(v.detach(), mesh.model).unbind(0)), dim=sharded[k])
            if k in sharded else v for k, v in named.items()}

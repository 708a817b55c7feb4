"""Data and tensor parallelism across ranks (port of
``latteclip_tpu/core/mesh.py``: ``initialize_distributed``, ``make_mesh``,
``_tp_leaf_spec``/``train_state_shardings``, ``shard_train_state``,
``tree_fully_replicated`` and ``gather_replicated``) on
``torch.distributed``.

The JAX package runs one GSPMD program over a ``("data", "model")`` mesh:
each host's ``--batch-size`` is its local batch, the global batch is the
hosts' local batches concatenated, and losses, metrics and the memory
bank's update are taken over the global batch. Here one rank is one process
on one device and plays a JAX host. Of ``world`` ranks under
``--model-parallelism K``, rank ``r`` sits at data index ``r // K`` and model
index ``r % K``: a model group (the K ranks of one data index) reads one
batch, as JAX's mesh keeps the model axis inside a batch group, and the
data group of a model index holds one rank of every model group.

Every rank computes the same global loss from features gathered over its
data group (:func:`gather`, whose backward sums the gathered gradient over
the group and hands each rank its slice, as the reference's
``gather_with_grad``). A rank's parameter gradient is then W times its
share, W the data size, as DDP's are; :meth:`Mesh.sync_gradients` takes
their mean, which gives the gradient of the global loss: over the data
group for a model-sharded leaf, over every rank for a replicated one (its
copies on the ranks of one model group are equal, and the mean over all
ranks keeps them bit-equal whatever order a kernel's atomics took).

Under K > 1 the MLPs of the OpenCLIP blocks (``layers.Mlp``: the vision and
text towers, CoCa's) are Megatron-sharded as JAX's ``_tp_leaf_spec`` shards
``c_fc_w``/``c_fc_b``/``c_proj_w``: ``c_fc`` keeps rows
``[m H/K, (m+1) H/K)`` of its ``[H, D]`` weight and its bias, ``c_proj`` the
same columns of its ``[D, H]`` weight; a hidden width that K does not
divide stays replicated, and so do the timm and EVA trunks' MLPs, whose
leaves are not OpenCLIP's (ROADMAP.md, section 3). The block's MLP input,
and the LayerNorm parameters fused into ``c_fc``, pass through
:func:`copy_to_model` (identity forward, sum over the model group
backward); the partial ``c_proj`` products through :func:`reduce_from_model`
(sum forward, identity backward), and ``c_proj``'s bias is added once, after
the sum. AdamW's moments and the accumulator live on the shards;
:func:`gathered` all-gathers them for eval and the checkpoint.

Every collective runs on every rank in one order: the train step's, eval's
gather and the checkpoint's. On a CUDA device NCCL takes one device a rank;
ranks that share a device run gloo, and a collective that gloo refuses on
CUDA tensors is staged through host memory when ``make_mesh(stage=...)``
names it, never quietly.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from latteclip_torch.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
COLLECTIVES = ("all_reduce", "all_gather", "broadcast", "send_recv")
BUCKET_ELEMENTS = 1 << 24   # 64 MiB of float32 a gradient all-reduce


def initialize_distributed(device="cuda", backend: Optional[str] = None, *,
                           shared_device: bool = False,
                           timeout_s: float = 600.0) -> torch.device:
    """Join the process group that torchrun's environment describes
    (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``)
    and return this rank's device: ``cuda:<LOCAL_RANK>`` (``cuda:0`` with
    ``shared_device``) or the CPU. The backend is NCCL on CUDA and gloo on
    the CPU unless ``backend`` names one (gloo, for ranks that share one
    card). Without ``RANK`` in the environment this is a single process:
    no group, and ``device`` as given. A rank that cannot reach its device
    or its group raises."""
    dev = resolve_device(device)
    if "RANK" not in os.environ or dist.is_initialized():
        return dev
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if dev.type == "cuda":
        dev = torch.device("cuda", 0 if shared_device else int(os.environ.get("LOCAL_RANK", 0)))
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank}: no CUDA device {dev.index} "
                               f"({torch.cuda.device_count()} visible)")
        torch.cuda.set_device(dev)
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                            init_method="env://", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dev


@dataclasses.dataclass(eq=False)
class Mesh:
    """The rank grid ``[world // K, K]`` over ``("data", "model")`` with its
    process groups. ``stage`` names the collectives (of
    :data:`COLLECTIVES`) that run on host copies of CUDA tensors."""

    model_parallelism: int
    rank: int
    world_size: int
    data_group: object
    model_group: object
    stage: frozenset = frozenset()

    @property
    def data_size(self) -> int:
        return self.world_size // self.model_parallelism

    @property
    def data_index(self) -> int:
        return self.rank // self.model_parallelism

    @property
    def model_index(self) -> int:
        return self.rank % self.model_parallelism

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data_size, MODEL_AXIS: self.model_parallelism}

    def __deepcopy__(self, memo):
        return self   # process groups are shared, never copied

    def _run(self, name: str, fn, tensors: Sequence[torch.Tensor]) -> None:
        """``fn(tensors)``, on host copies written back where ``name`` is staged."""
        if name in self.stage and tensors[0].is_cuda:
            host = [t.cpu() for t in tensors]
            fn(host)
            for t, h in zip(tensors, host):
                t.copy_(h)
        else:
            fn(tensors)

    def all_reduce_(self, tensor: torch.Tensor, group=None) -> torch.Tensor:
        """Sum ``tensor`` over ``group`` (every rank by default), in place."""
        self._run("all_reduce", lambda ts: dist.all_reduce(ts[0], group=group), [tensor])
        return tensor

    def all_reduce_many_(self, tensors: Sequence[torch.Tensor], group=None) -> None:
        """Sum each of ``tensors`` (one dtype) over ``group`` in place, as
        flat buckets of at most :data:`BUCKET_ELEMENTS` elements."""
        tensors = list(tensors)
        while tensors:
            bucket, n = [], 0
            while tensors and (not bucket or n + tensors[0].numel() <= BUCKET_ELEMENTS):
                n += tensors[0].numel()
                bucket.append(tensors.pop(0))
            flat = torch.cat([t.reshape(-1) for t in bucket])
            self.all_reduce_(flat, group)
            torch._foreach_copy_(bucket, [f.view_as(t) for f, t in
                                          zip(flat.split([t.numel() for t in bucket]), bucket)])

    def all_gather(self, tensor: torch.Tensor, group) -> List[torch.Tensor]:
        """Every rank's ``tensor`` (same shape on each) in ``group`` order."""
        tensor = tensor.contiguous()
        out = [torch.empty_like(tensor) for _ in range(dist.get_world_size(group))]

        def gather(ts):
            dist.all_gather(ts[1:], ts[0], group=group)

        self._run("all_gather", gather, [tensor] + out)
        return out

    def broadcast_(self, tensors: Sequence[torch.Tensor], src: int = 0) -> None:
        """Rank ``src``'s ``tensors`` on every rank, in place."""
        for t in tensors:
            self._run("broadcast", lambda ts: dist.broadcast(ts[0], src), [t])

    def shift_(self, send: torch.Tensor, recv: torch.Tensor, step: int) -> None:
        """Send ``send`` to the data rank ``step`` places on round the ring
        and receive ``recv`` from the one ``step`` places back."""
        K, D = self.model_parallelism, self.data_size
        to = (self.data_index + step) % D * K + self.model_index
        frm = (self.data_index - step) % D * K + self.model_index

        def exchange(ts):
            ops = [dist.P2POp(dist.isend, ts[0], to, self.data_group),
                   dist.P2POp(dist.irecv, ts[1], frm, self.data_group)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()

        self._run("send_recv", exchange, [send.contiguous(), recv])

    def sync_gradients(self, grads: Sequence[torch.Tensor], sharded: Sequence[bool]) -> None:
        """The gradient of the global loss on every rank, in place: the mean
        over every rank of the replicated leaves' gradients and over the data
        group of the model-sharded ones (module docstring)."""
        for group, size, pick in ((None, self.world_size, False),
                                  (self.data_group, self.data_size, True)):
            chosen = [g for g, s in zip(grads, sharded) if s == pick]
            if chosen:
                self.all_reduce_many_(chosen, group)
                torch._foreach_div_(chosen, float(size))

    def mean(self, value: torch.Tensor) -> torch.Tensor:
        """The mean of a rank-local metric over every rank (a detached copy)."""
        out = value.detach().float().clone()
        return self.all_reduce_(out) / self.world_size


def make_mesh(model_parallelism: int = 1, *, stage: Sequence[str] = ()) -> Mesh:
    """The ``[world // K, K]`` rank grid of the joined process group
    (:func:`initialize_distributed`), its data and model groups created on
    every rank in one order. ``stage``: collectives to run through host
    memory on CUDA tensors (for gloo on a shared card)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: launch with torchrun (or set "
                           "RANK/WORLD_SIZE/MASTER_ADDR/MASTER_PORT) and call "
                           "initialize_distributed first")
    unknown = set(stage) - set(COLLECTIVES)
    if unknown:
        raise ValueError(f"stage names unknown collectives {sorted(unknown)}; "
                         f"choose from {COLLECTIVES}")
    world, rank, K = dist.get_world_size(), dist.get_rank(), model_parallelism
    if K < 1 or world % K:
        raise ValueError(f"--model-parallelism {K} must divide the world size {world}")
    D = world // K
    data_group = model_group = None
    for m in range(K):
        g = dist.new_group([d * K + m for d in range(D)])
        if m == rank % K:
            data_group = g
    for d in range(D):
        g = dist.new_group([d * K + m for m in range(K)])
        if d == rank // K:
            model_group = g
    return Mesh(K, rank, world, data_group, model_group, frozenset(stage))


# -- collectives with autograd --------------------------------------------------

class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return torch.cat(mesh.all_gather(x, mesh.data_group))

    @staticmethod
    def backward(ctx, grad):
        mesh = ctx.mesh
        grad = mesh.all_reduce_(grad.contiguous().clone(), mesh.data_group)
        return grad.chunk(mesh.data_size)[mesh.data_index], None


def gather(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The data group's ``x`` concatenated on dim 0 in data-rank order (the
    global batch); the backward sums the gradient over the group and keeps
    this rank's rows. ``mesh`` None: ``x``."""
    return x if mesh is None else _Gather.apply(x, mesh)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, group):
        ctx.mesh, ctx.group = mesh, group
        return mesh.all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce_(grad.contiguous().clone(), ctx.group), None, None


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        out = torch.empty_like(x)
        mesh.shift_(x, out, 1)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = torch.empty_like(grad)
        ctx.mesh.shift_(grad.contiguous(), out, -1)
        return out, None


def ring_shift(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The previous data rank's ``x`` (ring order); the gradient goes back."""
    return _RingShift.apply(x, mesh)


def data_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` summed over the data group, the gradient summed the same way."""
    return _AllReduceSum.apply(x, mesh, mesh.data_group)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, *xs):
        ctx.mesh = mesh
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        mesh = ctx.mesh
        grads = [None if g is None else g.contiguous().clone() for g in grads]
        for dtype in dict.fromkeys(g.dtype for g in grads if g is not None):  # one order on every rank
            mesh.all_reduce_many_([g for g in grads if g is not None and g.dtype == dtype],
                                  mesh.model_group)
        return (None, *grads)


def copy_to_model(mesh: Mesh, *xs: torch.Tensor):
    """Megatron's ``f``: ``xs`` unchanged, their gradients summed over the
    model group (each shard of ``c_fc`` sees only its part)."""
    return _CopyToModel.apply(mesh, *xs)


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce_(x.clone(), mesh.model_group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Megatron's ``g``: the partial products summed over the model group;
    the gradient passes unchanged."""
    return _ReduceFromModel.apply(x, mesh)


# -- the train state's layout ---------------------------------------------------

def tp_leaf_dims(model: torch.nn.Module, model_size: int) -> Dict[str, int]:
    """JAX ``_tp_leaf_spec`` on the port's names: parameter name -> the dim
    it is split on under ``model_size``-way tensor parallelism (``c_fc``'s
    weight and bias on their rows, ``c_proj``'s weight on its columns) for
    every OpenCLIP block MLP whose hidden width ``model_size`` divides;
    every other parameter is replicated."""
    from latteclip_torch.models.layers import Mlp

    dims: Dict[str, int] = {}
    if model_size <= 1:
        return dims
    for name, module in model.named_modules():
        if isinstance(module, Mlp) and module.c_fc.weight.shape[0] % model_size == 0:
            dims.update({f"{name}.c_fc.weight": 0, f"{name}.c_fc.bias": 0,
                         f"{name}.c_proj.weight": 1})
    return dims


def _set_mlp_mesh(model: torch.nn.Module, mesh: Optional[Mesh], dims: Dict[str, int]) -> None:
    from latteclip_torch.models.layers import Mlp

    for name, module in model.named_modules():
        if isinstance(module, Mlp) and f"{name}.c_fc.weight" in dims:
            module.tp = mesh


def _leaf_tensors(state, moments: bool):
    """(name, dim, [the parameter's tensors to split or gather]) for each
    model-sharded leaf: the parameter, with ``moments`` its AdamW moments
    and its accumulator slot."""
    params = list(state.model.named_parameters())
    acc = state.accum.grads if state.accum is not None else [None] * len(params)
    for (name, p), a in zip(params, acc):
        if name not in state.tp_dims:
            continue
        tensors = [p]
        if moments:
            opt = state.optimizer.state.get(p, {})
            tensors += [opt[k] for k in ("exp_avg", "exp_avg_sq") if k in opt]
            tensors += [a] if a is not None else []
        yield name, state.tp_dims[name], tensors


def _narrow(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    size = t.shape[dim] // mesh.model_parallelism
    return t.narrow(dim, mesh.model_index * size, size).clone()


def shard_train_state(state, mesh: Mesh):
    """Place ``state`` on ``mesh`` (JAX ``shard_train_state``): rank 0's
    parameters, memory bank and step on every rank (a broadcast), then each
    model-sharded leaf of :func:`tp_leaf_dims` cut to this rank's part in
    place, with its moments and accumulator slot; the same Parameter
    objects stay in the model and the optimizer."""
    with torch.no_grad():
        step = torch.tensor([state.step], dtype=torch.float64,
                            device=state.memory_bank.device)
        mesh.broadcast_([p.data for p in state.model.parameters()]
                        + [state.memory_bank, state.prototypes, step])
        state.step = int(step.item())
        state.mesh = mesh
        state.tp_dims = tp_leaf_dims(state.model, mesh.model_parallelism)
        for _name, dim, tensors in _leaf_tensors(state, moments=True):
            for t in tensors:
                t.data = _narrow(t.data, dim, mesh)
        _set_mlp_mesh(state.model, mesh, state.tp_dims)
    return state


def tree_fully_replicated(state) -> bool:
    """True when no leaf of ``state`` is model-sharded."""
    return not getattr(state, "tp_dims", None)


@contextlib.contextmanager
def gathered(state, moments: bool = True):
    """JAX ``gather_replicated``: within the block the model-sharded leaves
    (with ``moments`` their AdamW moments and accumulator too) are whole on
    every rank and the blocks run unsharded; after it each rank holds its
    part again, bit-equal to before. A collective: every rank enters it,
    in the same order. A replicated state passes through."""
    mesh = getattr(state, "mesh", None)
    if tree_fully_replicated(state):
        yield state
        return
    leaves = list(_leaf_tensors(state, moments))
    with torch.no_grad():
        for _name, dim, tensors in leaves:
            for t in tensors:
                t.data = torch.cat(mesh.all_gather(t.data, mesh.model_group), dim=dim)
        _set_mlp_mesh(state.model, None, state.tp_dims)
    try:
        yield state
    finally:
        with torch.no_grad():
            for _name, dim, tensors in leaves:
                for t in tensors:
                    t.data = _narrow(t.data, dim, mesh)
            _set_mlp_mesh(state.model, mesh, state.tp_dims)


def is_master(state_or_mesh) -> bool:
    """Rank 0, or a run without a mesh: the one that writes logs and files."""
    mesh = getattr(state_or_mesh, "mesh", state_or_mesh)
    return mesh is None or mesh.rank == 0

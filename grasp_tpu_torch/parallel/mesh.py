"""The device mesh on ``torch.distributed`` (counterpart of grasp_tpu/parallel/mesh.py).

The JAX package runs one program over a ``("data", "model")`` mesh and lets
GSPMD insert the collectives from the arrays' shardings. Here every mesh
position is one process (a *rank*): rank ``r`` sits at data index ``r // tp``
and model index ``r % tp``, as JAX's ``devices.reshape(dp, tp)`` places its
devices, and the collectives are written where GSPMD puts them:

  - calibration and recovery batches shard their rows over ``data``; a batch
    whose rows do not divide is replicated and counted once;
  - dense projections shard Megatron-style over ``model``: column-parallel
    q/k/v/gate/up (output columns), row-parallel o/down (input rows, one
    ``all_reduce`` of the output over the model group after each);
  - the embedding and lm_head are vocab-parallel; the logits are assembled
    over the model group before loss or sampling;
  - low-rank and full-SVD factors and the norms are replicated, as in JAX; a
    forward takes the columns (column-parallel) or the rows (row-parallel) of
    the factor on the split side (:func:`tp_split`);
  - int8 ``kernel_q``/``kernel_scale`` shard like their kernel;
  - stacked MoE experts shard their leading [E] axis (expert parallelism).

With fewer KV heads than model ranks (``tp % num_key_value_heads == 0``) a
rank holds the KV heads its query heads read, so ranks share KV heads; JAX
splits ``k_proj``'s columns mid-head there instead, which needs no rule.

Gradients follow one rule (the autograd functions below): every replicated
tensor that a rank uses inside its shard of the work passes through
:func:`tp_enter` (identity forward, ``all_reduce`` of the gradient), every
slice of one through :func:`tp_split`, so each replicated tensor's gradient
is whole and equal on every rank, and each sharded tensor's is its shard.

Int4 weights shard like their kernel: ``kernel_q4`` by the projection's
rule, its ``[groups, out]`` scale as ``kernel_scale`` (with the output
columns of a column-parallel projection, whole for a row-parallel one, as in
JAX). A row-parallel rank holds the packed rows of its input columns
followed by the quantizer's zero padding rows, so that every rank's shard
has one shape and tells the group size; a rank whose rows start or end
inside a packed byte holds that whole byte (:func:`int4_byte_span`). A
forward takes the scale rows of the groups it touches and pads a group that
the shard splits with zero rows, and its input with a zero column for a
neighbour's nibble (``models.llama.int4_row_product``).

A mesh may also be one axis named ``"pipe"`` (``make_mesh((n,),
axis_names=("pipe",))``, JAX's ``Mesh(devices, ("pipe",))``), whose stages
exchange activations with :func:`ppermute` and point-to-point sends
(parallel/pipeline.py). Sequence parallelism rotates K/V blocks around an
axis with :func:`ppermute` (parallel/ring_attention.py).

The backend: ranks on distinct CUDA devices take NCCL; ranks that share a
device (NCCL refuses them: "Duplicate GPU detected") or run on the CPU take
gloo, which takes CUDA tensors in its collectives and stages them through
the host (:func:`backend_for`). Point-to-point messages of CUDA tensors on
gloo are staged through host buffers here.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from grasp_tpu_torch.configs import ModelConfig

DATA_AXIS, MODEL_AXIS, PIPE_AXIS = "data", "model", "pipe"
# models.llama's column-parallel projections (models.llama imports this module)
COLUMN_PROJS = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
DEFAULT_TIMEOUT_S = 600.0

Spec = Tuple[Optional[str], ...]  # one mesh axis (or None) per dimension; () replicates


# ---------------------------------------------------------------------------
# The mesh and its process groups
# ---------------------------------------------------------------------------


def backend_for(device_type: str, world: int, device_count: int) -> Tuple[str, str]:
    """(backend, reason) by one rule: ranks on distinct CUDA devices take
    NCCL; ranks that share a device, or run on the CPU, take gloo."""
    if device_type != "cuda":
        return "gloo", f"{world} ranks on the CPU"
    if world <= device_count:
        return "nccl", f"{world} ranks on {world} distinct CUDA devices"
    return "gloo", (f"{world} ranks share {device_count} CUDA device(s); NCCL refuses two "
                    "ranks on one device")


def rank_device(device_type: str, rank: int) -> torch.device:
    """The device of ``rank``: the CPU, or CUDA device ``rank % count``."""
    if device_type != "cuda":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh was asked for, but torch.cuda.is_available() is False")
    return torch.device("cuda", rank % torch.cuda.device_count())


def distributed_init(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *, device: str = "cuda",
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> Tuple[torch.device, str]:
    """Join this process to the others: ``torch.distributed.init_process_group``
    at ``tcp://coordinator_address`` ("host:port") as rank ``process_id`` of
    ``num_processes``, with the backend of :func:`backend_for`. The arguments
    default to torchrun's environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE,
    RANK). Every collective of the group fails after ``timeout_s``. Returns
    (this rank's device, the backend's reason); a second call returns them
    without joining again."""
    if coordinator_address is None:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if num_processes is None:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None:
        process_id = int(os.environ["RANK"])
    dev = rank_device(device, process_id)
    count = torch.cuda.device_count() if dev.type == "cuda" else 0
    backend, reason = backend_for(dev.type, num_processes, count)
    if dist.is_initialized():
        return dev, reason
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw: Dict[str, Any] = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return dev, reason


class Mesh:
    """A ("data", "model") mesh of ``dp x tp`` ranks, one process each, seen
    from this rank: its coordinates, its device and the process groups of
    its data row and model column (None where an axis has one rank). A
    one-axis mesh (``axis_names=("pipe",)``) is the first axis alone, of
    ``dp`` ranks, with ``tp`` 1."""

    def __init__(self, dp: int, tp: int, rank: int, device: torch.device, backend: str,
                 data_group=None, model_group=None,
                 axis_names: Tuple[str, ...] = (DATA_AXIS, MODEL_AXIS)):
        self.dp, self.tp, self.rank = dp, tp, rank
        self.device, self.backend = device, backend
        self.data_group, self.model_group = data_group, model_group
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) == 1 and tp != 1:
            raise ValueError(f"a one-axis mesh {self.axis_names} has no model axis (tp {tp})")

    @property
    def shape(self) -> Dict[str, int]:
        if len(self.axis_names) == 1:
            return {self.axis_names[0]: self.dp}
        return {DATA_AXIS: self.dp, MODEL_AXIS: self.tp}

    @property
    def size(self) -> int:
        return self.dp * self.tp

    @property
    def data_index(self) -> int:
        return self.rank // self.tp

    @property
    def model_index(self) -> int:
        return self.rank % self.tp

    def axis_index(self, axis: str) -> int:
        """This rank's position along ``axis`` (``jax.lax.axis_index``)."""
        self.shape[axis]  # noqa: B018  (an axis of another mesh raises KeyError)
        return self.model_index if axis == MODEL_AXIS else self.data_index

    def axis_rank(self, axis: str, index: int) -> int:
        """The global rank at position ``index`` of this rank's ``axis`` group."""
        if axis == MODEL_AXIS:
            return self.data_index * self.tp + index
        return index * self.tp + self.model_index

    def __repr__(self) -> str:
        axes = ", ".join(f"{k}={v}" for k, v in self.shape.items())
        return f"Mesh({axes}, rank={self.rank}, device={self.device}, backend={self.backend})"

    # -- collectives --------------------------------------------------------

    def all_reduce(self, t: torch.Tensor, axis: Optional[str] = None) -> torch.Tensor:
        """The sum, in place, over one axis's group (``axis`` None: every rank)."""
        group = self._group(axis)
        if group is not False:
            dist.all_reduce(t, group=group)
        return t

    def all_gather(self, t: torch.Tensor, axis: Optional[str]) -> List[torch.Tensor]:
        """Every rank's ``t`` of one axis's group (None: every rank), in
        rank order."""
        group = self._group(axis)
        if group is False:
            return [t]
        parts = [torch.empty_like(t) for _ in range(self.size if axis is None
                                                    else self.shape[axis])]
        dist.all_gather(parts, t.contiguous(), group=group)
        return parts

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``t``, in place, on every rank."""
        if self.size > 1:
            dist.broadcast(t, 0)
        return t

    def agree(self, value: float) -> float:
        """Rank 0's ``value`` on every rank: choices that decide which
        collectives run (a prefix mode, a sweep chunk) must agree."""
        if self.size == 1:
            return value
        t = torch.tensor([float(value)], dtype=torch.float64, device=self._comm_device())
        return float(self.broadcast(t).item())

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier()

    def _staged(self, t: torch.Tensor) -> bool:
        """Whether a point-to-point message of ``t`` goes through a host
        buffer: CUDA tensors on gloo."""
        return self.backend == "gloo" and t.device.type == "cuda"

    def send(self, t: torch.Tensor, axis: str, dst: int, tag: int = 0):
        """Post ``t`` to position ``dst`` of this rank's ``axis`` group
        without waiting: a handle whose ``wait()`` returns once it is sent
        (the handle keeps the buffer alive)."""
        buf = t.detach().contiguous()
        if self._staged(buf):
            buf = buf.cpu()
        return _Sent(dist.isend(buf, self.axis_rank(axis, dst), tag=tag), buf)

    def recv(self, like: torch.Tensor, axis: str, src: int, tag: int = 0) -> torch.Tensor:
        """A tensor of ``like``'s shape, dtype and device from position
        ``src`` of this rank's ``axis`` group (blocking)."""
        buf = torch.empty(like.shape, dtype=like.dtype,
                          device="cpu" if self._staged(like) else like.device)
        dist.recv(buf, self.axis_rank(axis, src), tag=tag)
        return buf.to(like.device)

    def ppermute(self, t: torch.Tensor, axis: str, perm) -> torch.Tensor:
        """``jax.lax.ppermute`` over one axis's group: ``perm`` holds (source,
        destination) positions; each source's ``t`` lands on its destination,
        and a position that no pair sends to gets zeros. Every send and
        receive is posted at once and then waited on, so a ring cannot
        deadlock."""
        idx = self.axis_index(axis)
        pairs = [(int(a), int(b)) for a, b in perm]
        if len({a for a, _ in pairs}) != len(pairs) or len({b for _, b in pairs}) != len(pairs):
            raise ValueError(f"ppermute needs distinct sources and destinations, got {pairs}")
        out = torch.zeros_like(t)
        src = t.detach().contiguous()
        if self._staged(src):
            src = src.cpu()
        buf = torch.empty_like(src)
        ops, received = [], False
        for a, b in pairs:
            if a == idx and b == idx:
                out.copy_(t)
            elif a == idx:
                ops.append(dist.P2POp(dist.isend, src, self.axis_rank(axis, b)))
            elif b == idx:
                ops.append(dist.P2POp(dist.irecv, buf, self.axis_rank(axis, a)))
                received = True
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if received:
            out.copy_(buf)
        return out

    def _comm_device(self) -> torch.device:
        return self.device if self.backend == "nccl" else torch.device("cpu")

    def _group(self, axis: Optional[str]):
        """The group of ``axis`` (None: the default group, every rank), or
        False where the axis holds this rank alone."""
        if axis is None:
            return None if self.size > 1 else False
        n = self.shape[axis]
        if n == 1:
            return False
        return self.model_group if axis == MODEL_AXIS else self.data_group


class _Sent:
    """A posted send and the buffer it reads."""

    def __init__(self, req, buf):
        self.req, self.buf = req, buf

    def wait(self) -> None:
        self.req.wait()


def make_mesh(shape: Optional[Tuple[int, ...]] = None, device=None,
              timeout_s: float = DEFAULT_TIMEOUT_S,
              axis_names: Tuple[str, ...] = (DATA_AXIS, MODEL_AXIS)) -> Mesh:
    """This rank's mesh over the process group that :func:`distributed_init`
    joined (one rank without one).

    ("data", "model"): shape=None is (world, 1), pure data parallel; ``d *
    m`` must equal the world size, else ValueError. One axis (``axis_names``
    of one name, such as ``("pipe",)``): shape=None or ``(world,)``. Every
    rank calls it with the same shape: the groups of each axis are made
    collectively, each of whose collectives fails after ``timeout_s``."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    axis_names = tuple(axis_names)
    if len(axis_names) == 1:
        shape = (world,) if shape is None else tuple(shape)
        if len(shape) != 1:
            raise ValueError(f"a one-axis mesh {axis_names} takes a shape of one size, "
                             f"got {shape}")
        shape = (shape[0], 1)
    elif axis_names != (DATA_AXIS, MODEL_AXIS):
        raise ValueError(f"a mesh's axes are ('data', 'model') or one axis, got {axis_names}")
    if shape is None:
        shape = (world, 1)
    if len(shape) != 2:
        raise ValueError(f"mesh shape {tuple(shape)} incompatible with {world} ranks")
    d, m = (int(x) for x in shape)
    if d < 1 or m < 1 or d * m != world:
        raise ValueError(f"mesh shape {tuple(shape)} incompatible with {world} ranks")
    if device is None:
        device = rank_device("cuda" if torch.cuda.is_available() else "cpu", rank)
    device = torch.device(device)
    backend = dist.get_backend() if dist.is_initialized() else "none"
    data_group = model_group = None
    if world > 1:
        timeout = datetime.timedelta(seconds=timeout_s)
        # every rank makes every group, in the same order
        for j in range(m):
            g = dist.new_group([i * m + j for i in range(d)], timeout=timeout)
            if rank % m == j:
                data_group = g
        for i in range(d):
            g = dist.new_group([i * m + j for j in range(m)], timeout=timeout)
            if rank // m == i:
                model_group = g
    return Mesh(d, m, rank, device, backend, data_group, model_group, axis_names)


# ---------------------------------------------------------------------------
# Tensor-parallel autograd functions
# ---------------------------------------------------------------------------


class _Enter(torch.autograd.Function):
    """Identity; the gradient is summed over one axis's group (a replicated
    input of work split over that axis: shard_map's transpose of a ``P()``
    input)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.meta = (mesh, axis)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, axis = ctx.meta
        return mesh.all_reduce(g.contiguous().clone(), axis), None, None


class _Reduce(torch.autograd.Function):
    """Sum over one axis's group; the gradient passes unchanged (each rank
    differentiates the same total, which its part enters once)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.all_reduce(x.contiguous().clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Split(torch.autograd.Function):
    """``t.narrow(dim, start, n)``; the gradient is placed in a zero tensor of
    ``t``'s shape and summed over the model group, so a replicated ``t``
    gets its whole gradient on every rank (ranks that take the same slice
    add their parts)."""

    @staticmethod
    def forward(ctx, t, dim, start, n, mesh):
        ctx.meta = (t.shape, dim, start, n, mesh)
        return t.narrow(dim, start, n).clone()

    @staticmethod
    def backward(ctx, g):
        shape, dim, start, n, mesh = ctx.meta
        full = g.new_zeros(shape)
        full.narrow(dim, start, n).copy_(g)
        return mesh.all_reduce(full, MODEL_AXIS), None, None, None, None


class _Gather(torch.autograd.Function):
    """One axis's shards concatenated along ``dim`` in position order; the
    gradient is this rank's part of the (equal) whole gradient."""

    @staticmethod
    def forward(ctx, x, dim, mesh, axis):
        ctx.meta = (dim, x.shape[dim], mesh.axis_index(axis))
        return torch.cat(mesh.all_gather(x, axis), dim=dim)

    @staticmethod
    def backward(ctx, g):
        dim, n, idx = ctx.meta
        return g.narrow(dim, idx * n, n).contiguous(), None, None, None


class _Replica(torch.autograd.Function):
    """Identity on a slice that several model ranks hold (the KV heads of
    ``tp % nkv == 0``); the gradient is summed over those ranks."""

    @staticmethod
    def forward(ctx, t, dim, start, full, mesh):
        ctx.meta = (dim, start, full, mesh)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        dim, start, full, mesh = ctx.meta
        shape = list(g.shape)
        shape[dim] = full
        whole = g.new_zeros(shape)
        whole.narrow(dim, start, g.shape[dim]).copy_(g)
        mesh.all_reduce(whole, MODEL_AXIS)
        return whole.narrow(dim, start, g.shape[dim]).contiguous(), None, None, None, None


def _grad_path(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def axis_enter(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """A replicated tensor entering this rank's share of work split over ``axis``."""
    return _Enter.apply(x, mesh, axis) if _grad_path(x) else x


def axis_sum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``jax.lax.psum`` of ``x`` over ``axis``."""
    if _grad_path(x):
        return _Reduce.apply(x, mesh, axis)
    return mesh.all_reduce(x.contiguous().clone(), axis)


def axis_gather(x: torch.Tensor, dim: int, mesh: Mesh, axis: str) -> torch.Tensor:
    """The whole tensor from the shards of ``axis``'s group along ``dim``
    (``out_specs`` that shard ``dim`` over ``axis``)."""
    if _grad_path(x):
        return _Gather.apply(x, dim % x.dim(), mesh, axis)
    return torch.cat(mesh.all_gather(x, axis), dim=dim)


def tp_enter(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A replicated tensor entering this rank's shard of the work."""
    return axis_enter(x, mesh, MODEL_AXIS)


def tp_reduce(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of the model group's partial results."""
    return axis_sum(x, mesh, MODEL_AXIS)


def tp_split(t: torch.Tensor, dim: int, span: Tuple[int, int], mesh: Mesh) -> torch.Tensor:
    """This rank's slice ``[start, stop)`` of a replicated tensor along ``dim``."""
    start, stop = span
    if _grad_path(t):
        return _Split.apply(t, dim % t.dim(), start, stop - start, mesh)
    return t.narrow(dim, start, stop - start)


def tp_gather(x: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """The whole tensor from the model group's shards along ``dim``."""
    return axis_gather(x, dim, mesh, MODEL_AXIS)


def tp_replica(t: torch.Tensor, dim: int, span: Tuple[int, int], full: int,
               mesh: Mesh) -> torch.Tensor:
    """A KV-head slice that several model ranks hold (:func:`kv_span`)."""
    if _grad_path(t):
        return _Replica.apply(t, dim % t.dim(), span[0], full, mesh)
    return t


class _PPermute(torch.autograd.Function):
    """:meth:`Mesh.ppermute`; the gradient goes back along the inverse
    permutation (JAX's transpose of ppermute)."""

    @staticmethod
    def forward(ctx, t, mesh, axis, perm):
        ctx.meta = (mesh, axis, [(b, a) for a, b in perm])
        return mesh.ppermute(t, axis, perm)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, inverse = ctx.meta
        return mesh.ppermute(g.contiguous(), axis, inverse), None, None, None


def ppermute(t: torch.Tensor, mesh: Mesh, axis: str, perm) -> torch.Tensor:
    """``jax.lax.ppermute(t, axis, perm)`` over ``mesh``'s ``axis`` group,
    differentiable (:class:`_PPermute`)."""
    perm = [(int(a), int(b)) for a, b in perm]
    if _grad_path(t):
        return _PPermute.apply(t, mesh, axis, perm)
    return mesh.ppermute(t, axis, perm)


# ---------------------------------------------------------------------------
# Which rows and columns a rank holds
# ---------------------------------------------------------------------------


def even_span(n: int, mesh: Mesh) -> Tuple[int, int]:
    """This rank's even share of ``n`` over the model axis."""
    if n % mesh.tp:
        raise ValueError(f"a dimension of {n} does not divide over {mesh.tp} model ranks")
    k = n // mesh.tp
    return mesh.model_index * k, (mesh.model_index + 1) * k


def kv_replicas(config: ModelConfig, tp: int) -> int:
    """How many model ranks hold each KV head: 1 when the heads divide over
    the ranks, ``tp / nkv`` when the ranks divide over the heads."""
    nkv = config.num_key_value_heads
    if nkv % tp == 0:
        return 1
    if tp % nkv == 0:
        return tp // nkv
    raise ValueError(f"{nkv} KV heads neither divide over nor divide {tp} model ranks")


def kv_span(config: ModelConfig, mesh: Mesh) -> Tuple[int, int]:
    """The KV columns (heads times head_dim) this rank holds: its share of
    the heads, or, with fewer heads than ranks, the one head its query heads
    read."""
    hd, nkv = config.head_dim_, config.num_key_value_heads
    rep = kv_replicas(config, mesh.tp)
    if rep == 1:
        return even_span(nkv * hd, mesh)
    head = mesh.model_index // rep
    return head * hd, (head + 1) * hd


def local_heads(config: ModelConfig, mesh: Optional[Mesh]) -> Tuple[int, int]:
    """(query heads, KV heads) of this rank."""
    if mesh is None or mesh.tp == 1:
        return config.num_attention_heads, config.num_key_value_heads
    if config.num_attention_heads % mesh.tp:
        raise ValueError(f"{config.num_attention_heads} attention heads do not divide over "
                         f"{mesh.tp} model ranks")
    kv_replicas(config, mesh.tp)
    return config.num_attention_heads // mesh.tp, max(config.num_key_value_heads // mesh.tp, 1)


def proj_span(proj: str, config: ModelConfig, mesh: Mesh) -> Tuple[int, int]:
    """The columns (column-parallel) or rows (row-parallel) of ``proj``'s
    full kernel that this rank holds or takes."""
    if proj in ("k_proj", "v_proj"):
        return kv_span(config, mesh)
    n = config.q_dim if proj in ("q_proj", "o_proj") else config.intermediate_size
    return even_span(n, mesh)


# ---------------------------------------------------------------------------
# Sharding rules
# ---------------------------------------------------------------------------

_DENSE_SPECS: Dict[str, Spec] = {
    # column-parallel (output dim sharded)
    "q_proj": (None, MODEL_AXIS),
    "k_proj": (None, MODEL_AXIS),
    "v_proj": (None, MODEL_AXIS),
    "gate_proj": (None, MODEL_AXIS),
    "up_proj": (None, MODEL_AXIS),
    # row-parallel (input dim sharded -> all_reduce of the output)
    "o_proj": (MODEL_AXIS, None),
    "down_proj": (MODEL_AXIS, None),
}

_BIAS_SPECS: Dict[str, Spec] = {
    "q_proj": (MODEL_AXIS,),
    "k_proj": (MODEL_AXIS,),
    "v_proj": (MODEL_AXIS,),
    "gate_proj": (MODEL_AXIS,),
    "up_proj": (MODEL_AXIS,),
    "o_proj": (None,),
    "down_proj": (None,),
}


def _proj_spec(proj_name: str, proj_params: Dict[str, Any]) -> Dict[str, Spec]:
    """Specs of one projection's params, keyed like the params: kernels and
    their int8/int4 forms by the projection's rule, the per-output-channel
    scale along the kernel's output sharding, the bias by its rule; SVD and
    low-rank factors (and their quantized forms) replicate."""
    specs: Dict[str, Spec] = {}
    for key in proj_params:
        if key in ("kernel", "kernel_q", "kernel_q4"):
            specs[key] = _DENSE_SPECS[proj_name]
        elif key == "kernel_scale":
            specs[key] = (None, _DENSE_SPECS[proj_name][1])
        elif key == "bias":
            specs[key] = _BIAS_SPECS[proj_name]
        else:
            specs[key] = ()
    return specs


def moe_specs(moe_params: Dict[str, Any]) -> Dict[str, Any]:
    """Expert parallelism: every stacked expert tensor (dense, low-rank,
    int8, int4 forms, all [E, ...]) shards its leading axis over the model
    axis; the router gate replicates (:func:`leaf_spec`'s rules)."""
    return _walk(moe_params, lambda path, t: leaf_spec("moe." + path, t.dim()))


def leaf_spec(path: str, ndim: int) -> Spec:
    """The spec of one leaf from its dotted path (``layers.3.self_attn.q_proj.kernel``,
    or a recovery subtree's ``3.mlp.down_proj.kernel``): the rules of
    :func:`param_specs`, for trees of any shape (optimizer moments,
    gradients keyed by path)."""
    parts = path.split(".")
    key = parts[-1]
    if parts[0] == "embed_tokens":
        return (MODEL_AXIS, None)
    if parts[0] == "lm_head":
        return (None, MODEL_AXIS) if key in ("kernel", "kernel_q", "kernel_q4",
                                             "kernel_scale") else ()
    if len(parts) >= 2 and parts[-2] == "experts":
        return (MODEL_AXIS,) + (None,) * (ndim - 1)
    if len(parts) >= 2 and parts[-2] in _DENSE_SPECS:
        return _proj_spec(parts[-2], {key: None})[key]
    return ()  # norms, the router gate


def _walk(tree, fn, path: str = ""):
    """``fn(dotted path, leaf)`` over every leaf, the tree rebuilt."""
    if isinstance(tree, list):
        return [_walk(v, fn, f"{path}{i}.") for i, v in enumerate(tree)]
    if isinstance(tree, dict):
        return {k: _walk(v, fn, f"{path}{k}.") for k, v in tree.items()}
    return fn(path[:-1], tree)


def param_specs(params: Dict[str, Any], config: ModelConfig) -> Dict[str, Any]:
    """A tree of specs congruent to ``params``: grasp_tpu's ``param_specs``
    rules (:func:`_proj_spec`, :func:`moe_specs`, vocab-parallel embedding
    and lm_head, norms replicated)."""
    return _walk(params, lambda path, t: leaf_spec(path, t.dim()))


ROW_PROJS = ("o_proj", "down_proj")


def _rule(path: str, t: torch.Tensor, config: ModelConfig, mesh: Mesh):
    """(dim, span of the full length or None for an even share, replicas)
    of a leaf sharded over the model axis, or None for a replicated one;
    span "int4_rows" for a row-parallel int4 kernel (:func:`int4_row_span`)."""
    spec = leaf_spec(path, t.dim())
    if MODEL_AXIS not in spec or mesh.tp == 1:
        return None
    parts = path.split(".")
    dim = spec.index(MODEL_AXIS)
    if len(parts) >= 2 and parts[-2] in ROW_PROJS and parts[-1] == "kernel_q4":
        return dim, "int4_rows", 1
    if len(parts) >= 2 and parts[-2] in ("k_proj", "v_proj"):
        return dim, kv_span(config, mesh), kv_replicas(config, mesh.tp)
    return dim, None, 1


def int4_in_features(proj: str, config: ModelConfig) -> int:
    """The input width of a row-parallel projection."""
    return config.q_dim if proj == "o_proj" else config.intermediate_size


def int4_byte_span(r0: int, r1: int) -> Tuple[int, int]:
    """The packed bytes [start, stop) that hold int4 rows [r0, r1): byte i
    holds rows 2 i and 2 i + 1, so a span that starts or ends inside a byte
    takes that whole byte, its neighbour's nibble with it. Spans of one
    length take one count of bytes wherever they start (an even length its
    half, an odd one its half rounded up)."""
    return r0 // 2, (r1 + 1) // 2


def int4_row_span(proj: str, packed_rows: int, config: ModelConfig,
                  mesh: Mesh) -> Tuple[int, int]:
    """The byte rows [start, stop) of ``proj``'s packed int4 kernel
    (``packed_rows`` rows whole) that hold a row-parallel rank's input
    columns (:func:`int4_byte_span`: a rank whose rows start or end inside a
    byte takes the whole byte, as GSPMD's partition of JAX's packed weight
    reads it); the rows from half the input width to the end are the
    quantizer's zero padding."""
    in_f = int4_in_features(proj, config)
    r0, r1 = proj_span(proj, config, mesh)
    if 2 * packed_rows < in_f:
        raise ValueError(f"an int4 {proj} of {packed_rows} packed rows is narrower than its "
                         f"input of {in_f}")
    return int4_byte_span(r0, r1)


def shard_leaf(path: str, t: torch.Tensor, config: ModelConfig, mesh: Mesh) -> torch.Tensor:
    """This rank's part of the whole leaf at ``path`` (a copy), or the leaf.
    A row-parallel int4 kernel's part is its rows followed by the padding
    rows, alike on every rank (:func:`int4_row_span`)."""
    rule = _rule(path, t, config, mesh)
    if rule is None:
        return t
    dim, span, _ = rule
    if span == "int4_rows":
        proj = path.split(".")[-2]
        b0, b1 = int4_row_span(proj, t.shape[0], config, mesh)
        return torch.cat([t[b0:b1], t[int4_in_features(proj, config) // 2:]]).contiguous()
    start, stop = span or even_span(t.shape[dim], mesh)
    return t.narrow(dim, start, stop - start).clone()


def gather_leaf(path: str, t: torch.Tensor, config: ModelConfig, mesh: Mesh) -> torch.Tensor:
    """The whole leaf at ``path`` from every model rank's part (collective)."""
    rule = _rule(path, t, config, mesh)
    if rule is None:
        return t
    dim, span, rep = rule
    parts = mesh.all_gather(t, MODEL_AXIS)[::rep]
    if span == "int4_rows":  # each rank's bytes, a byte two ranks share once
        k = int4_in_features(path.split(".")[-2], config) // mesh.tp
        pieces, done = [], 0
        for r, p in enumerate(parts):
            b0, b1 = int4_byte_span(r * k, (r + 1) * k)
            pieces.append(p[done - b0:b1 - b0])
            done = b1
        return torch.cat(pieces + [parts[-1][b1 - b0:]])
    return torch.cat(parts, dim=dim)


def shard_params(params: Dict[str, Any], mesh: Mesh, config: ModelConfig) -> Dict[str, Any]:
    """This rank's tree from the full one: each sharded leaf a contiguous
    copy of its slice, each replicated leaf shared with ``params``."""
    if mesh.tp > 1:
        local_heads(config, mesh)  # the head counts must divide
    return _walk(params, lambda path, t: shard_leaf(path, t, config, mesh))


def gather_params(params: Dict[str, Any], mesh: Mesh, config: ModelConfig) -> Dict[str, Any]:
    """The full tree from every rank's shards (:func:`shard_params`'
    inverse), on every rank; a KV head that several ranks hold is taken
    once. Collective: every rank calls it."""
    return _walk(params, lambda path, t: gather_leaf(path, t, config, mesh))


def shard_flat(flat: Dict[str, torch.Tensor], mesh: Mesh,
               config: ModelConfig) -> Dict[str, torch.Tensor]:
    """:func:`shard_params` of a tree flattened to dotted paths."""
    return {p: shard_leaf(p, t, config, mesh) for p, t in flat.items()}


def gather_flat(flat: Dict[str, torch.Tensor], mesh: Mesh,
                config: ModelConfig) -> Dict[str, torch.Tensor]:
    """:func:`gather_params` of a tree flattened to dotted paths."""
    return {p: gather_leaf(p, t, config, mesh) for p, t in flat.items()}


def replicas(path: str, t: torch.Tensor, config: ModelConfig, mesh: Mesh) -> int:
    """How many model ranks hold the same values of a leaf: ``tp`` for a
    replicated one, 1 for a sharded one, the KV heads' share between."""
    rule = _rule(path, t, config, mesh)
    return mesh.tp if rule is None else rule[2]


# ---------------------------------------------------------------------------
# Batches
# ---------------------------------------------------------------------------


def batch_spec() -> Spec:
    """A batch's spec: rows over the data axis."""
    return (DATA_AXIS, None)


def data_rows(n: int, mesh: Optional[Mesh]) -> Optional[slice]:
    """This rank's rows of a batch of ``n`` over the data axis, or None when
    ``n`` does not divide (or there is one data rank): the batch is then
    replicated, and only data index 0 counts it."""
    if mesh is None or mesh.dp == 1 or n % mesh.dp:
        return None
    k = n // mesh.dp
    return slice(mesh.data_index * k, (mesh.data_index + 1) * k)


def shard_batch(batch: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This rank's rows of every array of a batch (its leading axis), or
    the whole batch where the rows do not divide (:func:`data_rows`)."""
    out = {}
    for k, v in batch.items():
        rows = None if v is None else data_rows(int(v.shape[0]), mesh)
        out[k] = v if rows is None else v[rows]
    return out


def replicate(tree, mesh: Mesh):
    """Rank 0's values of every tensor of ``tree`` on every rank (in place)."""
    from grasp_tpu_torch.models.convert import flatten_params

    for t in flatten_params(tree).values():
        if t.device.type == "cuda" or mesh.backend == "gloo":
            mesh.broadcast(t)
        else:  # nccl needs device tensors
            t.copy_(mesh.broadcast(t.to(mesh.device)).cpu())
    return tree

"""The Megatron pair of collectives for packed linears (port of
`pb_llm_tpu/parallel/collectives.py`):

  column-parallel: x replicated → y sharded on oc (no collective)
  row-parallel:    x sharded on ic → partial y → all_reduce over tp

`row_parallel_local` is a rank's row-parallel linear on its LOCAL x and
layer: the port's `pb_matmul` on its block (so every kernel arm sees the
shard's shapes, and the int8 arms quantize the rank's own x columns: a
per-row absmax over the local columns, as JAX's body does), then the
all_reduce, then the bias once.  `runtime.tp_engine` runs every
row-parallel linear through it.

`column_parallel_pb_matmul` and `row_parallel_pb_matmul` keep JAX's names
and take the GLOBAL x and layer on every rank, as JAX's take global arrays:
each cuts this rank's block (`local_linear`: `sharding.shard_params`' rule
with the static ``ic`` / ``oc`` / ``groupsize`` JAX's `_local_meta` gives
the body) and x's columns, then runs the engine's own local code.

Inference across ranks adds three collectives, each with the backend rule
in its body and nowhere else (gloo's send/recv takes CPU tensors only, and
NCCL's collectives CUDA tensors only):

  `broadcast_one_to_all` — a numpy record from rank 0 to every rank (the
      admission record of `runtime.multihost_batching`); under NCCL it
      crosses as a CUDA tensor;
  `ppermute` — a ring send/recv over a group (JAX's `lax.ppermute` with a
      shift); under gloo a CUDA tensor crosses through one host copy;
  `all_sum` — a sum over a group (JAX's `psum`), in place.

Training across ranks (`train.qat` under a mesh) adds the autograd-aware
collectives, `torch.autograd.Function`s over the mesh's groups (JAX's
GSPMD inserts the same collectives into the jitted step):

  `copy_to_tp` — identity forward, all_reduce of the gradient over tp
      backward: the input of a column-parallel linear;
  `reduce_from_tp` — all_reduce over tp forward, identity backward: the
      output of a row-parallel linear (its bias added after it);
  `gather_from_tp` — all_gather of the last dimension over tp forward, the
      rank's slice of the gradient backward: vocab-parallel logits;
  `fsdp_gather` — all_gather over dp along a dimension forward,
      reduce-scatter of the gradient backward: an FSDP-split weight, whose
      gradient is then summed over dp and left in the rank's block;
  `all_reduce_sum` — all_reduce forward and backward: a statistic summed
      over the ranks' blocks whose every rank's use feeds the gradient (a
      row-parallel weight's row mean, `quant.qat`).

Each is the identity over an axis of one rank.  They run under gloo and
NCCL; under gloo a CUDA gradient crosses the reduce-scatter through one
host copy, as `ppermute` does.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch
import torch.distributed as dist

from ..core.pbw import PackedLinear, PackedLinearV2
from ..models.linear import apply_linear
from .mesh import Mesh
from .sharding import COL_PARALLEL, _leaf_spec, _shard, sanitize_specs


def _local_meta(p, col: bool, tp: int, rank: int):
    """The static fields of a rank's block, as inside JAX's body: oc/tp
    (column) or ic/tp and groupsize min(groupsize, ic/tp) (row).  A
    row-parallel PBW-v1 layer's group scales are replicated
    (`sharding._packed_spec`); its block takes the rows of its own groups."""
    if col:
        return dataclasses.replace(p, oc=p.oc // tp)
    ic_l = p.ic // tp
    if isinstance(p, PackedLinearV2):
        return dataclasses.replace(p, ic=ic_l)
    gs, n_groups = p.groupsize, p.low_scale.shape[-2]
    if n_groups > 1:
        if ic_l % gs == 0:
            first, n = rank * ic_l // gs, ic_l // gs
        elif gs % ic_l == 0:
            first, n = rank * ic_l // gs, 1
        else:
            raise ValueError(f"groups of {gs} rows neither tile nor cover a shard of {ic_l} rows")
        d = p.low_scale.dim() - 2
        p = dataclasses.replace(p, low_scale=p.low_scale.narrow(d, first, n).clone(),
                                low_mean=p.low_mean.narrow(d, first, n).clone())
    return dataclasses.replace(p, ic=ic_l, groupsize=min(gs, ic_l))


def check_row_blocks(name: str, p, tp: int) -> None:
    """The bit plane's pack blocks must tile each shard (pack_block | ic/tp),
    or a shard's word-rows would interleave rows of two shards: pack for the
    target tp (a pack_block dividing ic/tp)."""
    if (p.ic // tp) % p.pack_block:
        from ..core.packing import default_pack_block

        raise ValueError(
            f"row-parallel {name} over tp={tp} needs pack_block | ic/tp (ic={p.ic}, "
            f"pack_block={p.pack_block}); repack with a smaller pack_block, e.g. "
            f"{default_pack_block(p.ic // tp, cap=p.pack_block)}")


def local_linear(name: str, p, mesh: Mesh):
    """Rank ``mesh.rank``'s view of the global packed layer ``p`` named
    ``name``: its block and local static fields."""
    spec = sanitize_specs({"lm": p}, {"lm": _leaf_spec(name, p)}, mesh)["lm"]
    return _local_meta(_shard(p, spec, mesh), name in COL_PARALLEL, mesh.tp, mesh.coord("tp"))


def all_gather_last(y: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Concatenate every tp rank's y along the last axis, in rank order."""
    parts: List[torch.Tensor] = [torch.empty_like(y) for _ in range(mesh.tp)]
    dist.all_gather(parts, y.contiguous(), group=mesh.tp_group)
    return torch.cat(parts, dim=-1)


def row_parallel_local(x: torch.Tensor, lin, bias, group=None) -> torch.Tensor:
    """A rank's row-parallel linear: its block ``lin`` (holding no bias)
    times its own x columns, the partial sums all-reduced over ``group``,
    then ``bias`` once."""
    y = apply_linear(lin, x)
    dist.all_reduce(y, group=group)
    return y if bias is None else y + bias.to(y.dtype)


def column_parallel_pb_matmul(x: torch.Tensor, p, mesh: Mesh, gather: bool = False,
                              name: str = "up_proj") -> torch.Tensor:
    """x replicated [m, ic]; planes oc-sharded; y [m, oc/tp], this rank's
    columns (or every rank's, gathered)."""
    y = apply_linear(local_linear(name, p, mesh), x)
    return all_gather_last(y, mesh) if gather else y


def row_parallel_pb_matmul(x: torch.Tensor, p, mesh: Mesh,
                           name: str = "down_proj") -> torch.Tensor:
    """x [m, ic] (this rank takes its ic block); planes ic-sharded; y
    replicated after the all_reduce, the bias added once after it."""
    if not isinstance(p, (PackedLinear, PackedLinearV2)):
        raise TypeError(f"row_parallel_pb_matmul: a packed layer, not {type(p).__name__}")
    check_row_blocks(name, p, mesh.tp)
    p_l = local_linear(name, p, mesh)
    x_l = x.narrow(-1, mesh.coord("tp") * p_l.ic, p_l.ic)
    return row_parallel_local(x_l, dataclasses.replace(p_l, bias=None), p_l.bias, mesh.tp_group)


def _world() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def broadcast_one_to_all(arr: np.ndarray) -> np.ndarray:
    """Rank 0's ``arr`` on every rank (every rank passes an array of the
    same shape and dtype).  The identity without a process group or with a
    world of 1, as JAX's `_broadcast`.  gloo carries it as a CPU tensor,
    NCCL as a tensor on the rank's current card."""
    if _world() == 1:
        return arr
    t = torch.from_numpy(np.ascontiguousarray(arr))
    backend = dist.get_backend()
    if backend == "nccl":
        t = t.to(torch.device("cuda", torch.cuda.current_device()))
    elif backend != "gloo":
        raise NotImplementedError(f"broadcast_one_to_all: backend {backend!r}")
    dist.broadcast(t, src=0)
    return t.cpu().numpy()


def ppermute(t: torch.Tensor, group=None, shift: int = 1) -> torch.Tensor:
    """The ring send/recv of ``group`` (default: the world): the group's
    rank i sends ``t`` to rank i + shift and returns what rank i - shift
    sent (same shape and dtype).  A group of one returns ``t``.  Under
    gloo a CUDA tensor goes through one host copy each way; under NCCL a
    CPU tensor raises."""
    n = dist.get_world_size(group) if _world() > 1 else 1
    if n == 1:
        return t
    backend = dist.get_backend(group)
    if backend == "gloo":
        send = t.detach().to("cpu").contiguous()
    elif backend == "nccl":
        if t.device.type != "cuda":
            raise ValueError(f"ppermute under nccl needs a CUDA tensor, not {t.device}")
        send = t.contiguous()
    else:
        raise NotImplementedError(f"ppermute: backend {backend!r}")
    me = dist.get_rank(group)
    grp = group if group is not None else dist.group.WORLD
    to = dist.get_global_rank(grp, (me + shift) % n)
    frm = dist.get_global_rank(grp, (me - shift) % n)
    recv = torch.empty_like(send)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, send, to, group),
                                   dist.P2POp(dist.irecv, recv, frm, group)])
    for r in reqs:
        r.wait()
    return recv.to(t.device) if recv.device != t.device else recv


def all_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` summed over ``group`` in place (JAX's `psum`); the identity
    without a process group."""
    if _world() > 1:
        dist.all_reduce(t, group=group)
    return t


def _size(group) -> int:
    return dist.get_world_size(group) if _world() > 1 else 1


def _gather_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``t`` of ``group`` concatenated along ``dim``, in rank
    order."""
    parts = [torch.empty_like(t) for _ in range(_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _reduce_scatter_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``t`` summed over ``group``, this rank's block of ``dim`` kept."""
    n = _size(group)
    dev = t.device
    if dist.get_backend(group) == "gloo" and dev.type == "cuda":
        t = t.cpu()
    parts = [c.contiguous() for c in t.chunk(n, dim=dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    return out.to(dev)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherDim(torch.autograd.Function):
    """all_gather along ``dim`` forward; backward the rank's slice of the
    gradient (``scatter=False``: every rank's gradient is the same) or the
    reduce-scatter of the ranks' gradients (``scatter=True``)."""

    @staticmethod
    def forward(ctx, x, dim, group, scatter):
        ctx.dim, ctx.group, ctx.scatter, ctx.n = dim, group, scatter, x.shape[dim]
        return _gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.scatter:
            return _reduce_scatter_dim(g, ctx.dim, ctx.group), None, None, None
        me = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, me * ctx.n, ctx.n).contiguous(), None, None, None


def copy_to_tp(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A column-parallel linear's input: the identity forward, its gradient
    all-reduced over tp backward."""
    return x if mesh.tp == 1 else _CopyToTP.apply(x, mesh.tp_group)


def reduce_from_tp(y: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A row-parallel linear's partial output summed over tp; the gradient
    passes unchanged (every tp rank holds the same one)."""
    return y if mesh.tp == 1 else _ReduceFromTP.apply(y, mesh.tp_group)


def gather_from_tp(y: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Vocab-parallel logits gathered along the last dimension over tp;
    backward each rank keeps its slice of the gradient."""
    return y if mesh.tp == 1 else _GatherDim.apply(y, y.dim() - 1, mesh.tp_group, False)


def fsdp_gather(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """An FSDP block gathered over dp along ``dim`` (the dimension the fsdp
    spec split); backward the gradient is reduce-scattered over dp, so the
    block's gradient is the sum over dp of its rows' gradients."""
    if mesh.dp == 1:
        return t
    if not t.requires_grad:  # a frozen leaf (the outlier mask, the base model)
        return _gather_dim(t, dim, mesh.dp_group)
    return _GatherDim.apply(t, dim, mesh.dp_group, True)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group``, forward and backward (a statistic every
    rank uses in its own way); a new tensor, the identity over one rank."""
    return t if _size(group) == 1 else _AllReduceSum.apply(t, group)

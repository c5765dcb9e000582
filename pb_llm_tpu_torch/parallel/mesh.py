"""The rank mesh (port of `pb_llm_tpu/parallel/mesh.py`): axes

  dp — data parallel (batch)
  tp — tensor parallel (weights, KV heads)

over a `torch.distributed` process group, rank r at (dp, tp) coordinates
(r // tp, r % tp).

Execution model.  JAX runs tensor parallelism as ONE process over a device
mesh: `shard_map` bodies see each device's block, and the collectives are
`psum` / `all_gather` over the mesh axis.  Here each rank is a process of its
own, and the ranks run in lockstep (SPMD):

  * every rank builds the same `runtime.tp_engine.TPEngine` from the same
    UNSHARDED parameter tree, as JAX's constructor takes one, and keeps its
    own block of it (`parallel.sharding.shard_params`);
  * every rank runs the same host-side scheduling (`ContinuousBatcher`) over
    the same requests;
  * the collectives are issued explicitly, as JAX's `shard_map` bodies do:
    `all_reduce` after each row-parallel linear and `all_gather` of
    vocab-sharded logits (`parallel.collectives`).  Both leave the same bits
    on every rank, so with the same seeded `torch.Generator` every rank
    samples the same tokens (the tests assert it);
  * rank 0 prints.

Backend rule (`backend_for`): NCCL when each rank has a card of its own;
otherwise gloo.  Gloo covers the CPU, and ranks that share one card, the only
way to run tp > 1 on a machine with a single card: gloo carries CUDA tensors
through the host.  NCCL's collectives can be captured in the decode step's
CUDA graph; gloo's cannot, so under gloo the step runs eagerly
(`runtime.step_graph`).

`make_mesh` builds the groups of an initialised process group;
`make_sp_mesh` / `make_pp_mesh` build 1-D meshes (`AxisMesh`) over it for
ring attention and the pipeline; `multihost_initialize` initialises one (an
explicit rank, world size and ``tcp://127.0.0.1:<port>``, or torchrun's
environment) with a collective timeout of ``GROUP_TIMEOUT``; `run_ranks`
spawns a world of ranks on this host and collects what each returns.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import queue as queue_mod
import socket
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from .. import resolve_device

# how long a collective waits for its peers before it fails (gloo and NCCL);
# `run_ranks` hands the parent's value to the ranks it spawns
GROUP_TIMEOUT = datetime.timedelta(minutes=10)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (dp, tp) mesh: this rank's place in it and the groups of its row
    (tp) and column (dp).  Without groups it is only a shape, which the
    checks that need no collective read."""

    dp: int
    tp: int
    rank: int = 0
    backend: str = "gloo"
    tp_group: Any = None
    dp_group: Any = None

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp, "tp": self.tp}

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self.rank % self.tp if axis == "tp" else self.rank // self.tp


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh's axes (one entry per dimension: an axis name or
    None); `local` takes this rank's block of a global tensor."""

    mesh: Mesh
    spec: tuple

    def local(self, t: torch.Tensor) -> torch.Tensor:
        return local_block(t, self.spec, self.mesh)


def local_block(t: torch.Tensor, spec: Sequence, mesh: Mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec`` (a view; every spec'd dim
    must divide by its axis size, as `sharding.sanitize_specs` ensures)."""
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        n, idx = 1, 0
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            n, idx = n * mesh.shape[a], idx * mesh.shape[a] + mesh.coord(a)
        size = t.shape[d] // n
        t = t.narrow(d, idx * size, size)
    return t


def backend_for(world_size: int, device) -> str:
    """NCCL when each rank has a card of its own, gloo otherwise (the CPU,
    or ranks sharing a card)."""
    device = torch.device(device)
    if (device.type == "cuda" and dist.is_nccl_available()
            and torch.cuda.device_count() >= world_size):
        return "nccl"
    return "gloo"


def backend_line(world_size: int, device, axis: str = "tp") -> str:
    """The backend rule's outcome for ``world_size`` ranks on ``device``
    along ``axis``, in words (rank 0 prints it first)."""
    device = torch.device(device)
    backend = backend_for(world_size, device)
    if backend == "nccl":
        why = f"a card for each of the {world_size} ranks"
    elif device.type == "cuda":
        why = (f"{world_size} ranks share {torch.cuda.device_count()} card(s), NCCL takes a card "
               "a rank; CUDA tensors cross through the host, and the decode step runs eagerly")
    else:
        why = f"{world_size} ranks on the CPU"
    return f"{axis} backend {backend}: {why}"


def rank_device(rank: int, device) -> torch.device:
    """The device rank ``rank`` runs on: card ``rank`` modulo the cards (one
    each under NCCL; gloo ranks beyond the cards share them), or the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    return torch.device("cuda", rank % torch.cuda.device_count())


def free_address() -> str:
    """``tcp://127.0.0.1:<a free port>`` for a process group's rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"tcp://127.0.0.1:{s.getsockname()[1]}"


def multihost_initialize(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, device=None) -> str:
    """`torch.distributed.init_process_group` for this rank: the JAX
    wrapper's arguments (``coordinator_address`` a ``tcp://host:port``
    address), or with none of them torchrun's environment (``env://``:
    RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT).  The backend follows
    `backend_for` on ``device`` (CUDA unless the caller names another); under
    NCCL the rank's card is made current.  Returns the backend."""
    device = resolve_device(device)
    if coordinator_address is None:
        world, rank, init = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]), "env://"
    else:
        world, rank, init = num_processes, process_id, coordinator_address
    backend = backend_for(world, device)
    kw = {}
    if backend == "nccl":
        dev = rank_device(rank, device)
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                            timeout=GROUP_TIMEOUT, **kw)
    return backend


def make_mesh(dp: int = 1, tp: Optional[int] = None) -> Mesh:
    """The (dp, tp) mesh of the initialised process group; tp defaults to
    all remaining ranks.  dp·tp must be the world size (JAX takes the first
    dp·tp devices; a rank left out of every group would idle)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(parallel.mesh.multihost_initialize)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if tp is None:
        tp = world // dp
    if dp * tp != world:
        raise ValueError(f"mesh {dp}x{tp} needs {dp * tp} ranks, the group has {world}")
    # every rank creates every group, in the same order (new_group's rule)
    tp_group = dp_group = None
    for d in range(dp):
        ranks = list(range(d * tp, (d + 1) * tp))
        g = dist.group.WORLD if dp == 1 else dist.new_group(ranks)
        if rank in ranks:
            tp_group = g
    for t in range(tp):
        ranks = list(range(t, world, tp))
        g = dist.group.WORLD if tp == 1 else dist.new_group(ranks)
        if rank in ranks:
            dp_group = g
    return Mesh(dp, tp, rank, dist.get_backend(), tp_group, dp_group)


@dataclasses.dataclass(frozen=True)
class AxisMesh:
    """A 1-D mesh of ``size`` ranks along ``axis`` ("sp" or "pp"): this
    rank's place in it and its group, whose ranks are ``ranks`` (global
    ranks, in axis order)."""

    axis: str
    size: int
    rank: int = 0
    backend: str = "gloo"
    group: Any = None
    ranks: tuple = (0,)

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis: self.size}

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        if axis != self.axis:
            raise KeyError(f"mesh has axis {self.axis!r}, not {axis!r}")
        return self.ranks.index(self.rank)


def make_axis_mesh(axis: str, size: Optional[int] = None) -> AxisMesh:
    """A 1-D mesh of ``size`` consecutive ranks (default: the world) along
    ``axis``.  A world larger than ``size`` splits into world/size such
    meshes, each rank in one (every rank creates every group, in order)."""
    if not dist.is_initialized():
        raise RuntimeError(f"make_{axis}_mesh needs an initialised process group "
                           "(parallel.mesh.multihost_initialize)")
    world, rank = dist.get_world_size(), dist.get_rank()
    size = size or world
    if world % size:
        raise ValueError(f"{axis}={size} does not divide the world of {world} ranks")
    mine = None
    for g in range(world // size):
        ranks = tuple(range(g * size, (g + 1) * size))
        group = dist.group.WORLD if size == world else dist.new_group(list(ranks))
        if rank in ranks:
            mine = (group, ranks)
    return AxisMesh(axis, size, rank, dist.get_backend(), *mine)


def make_sp_mesh(sp: Optional[int] = None) -> AxisMesh:
    """The sequence-parallel mesh (JAX's `ring_attention.make_sp_mesh`)."""
    return make_axis_mesh("sp", sp)


def make_pp_mesh(pp: Optional[int] = None) -> AxisMesh:
    """The pipeline mesh (JAX's `pipeline.make_pp_mesh`)."""
    return make_axis_mesh("pp", pp)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def shard_batch(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ("dp",))


def _rank_entry(fn, rank: int, world: int, address: str, device, args, results,
                group_timeout=None) -> None:
    global GROUP_TIMEOUT
    try:
        if group_timeout is not None:
            GROUP_TIMEOUT = group_timeout
        multihost_initialize(address, world, rank, device)
        try:
            # pickled here, tensors by value: a tensor put on the queue as it
            # is would travel as a handle to memory this process frees on exit
            out = pickle.dumps(fn(rank, *args))
        finally:
            dist.destroy_process_group()
        results.put((rank, out, None))
    except BaseException:
        results.put((rank, None, traceback.format_exc()))
        raise


def run_ranks(fn: Callable, world: int, args: Sequence = (), device=None,
              timeout: float = 1800.0) -> List[Any]:
    """Run ``fn(rank, *args)`` in ``world`` spawned processes joined in one
    process group (`multihost_initialize` on ``device``, CUDA unless the
    caller names another, a free local port) and return each rank's result,
    by rank.  ``fn`` and ``args`` are
    pickled: a module-level function and plain data.  The ranks' groups
    take this process's ``GROUP_TIMEOUT``.  A rank that raises stops the
    others, and its traceback is raised here."""
    device = resolve_device(device).type
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    address = free_address()
    procs = [ctx.Process(target=_rank_entry, args=(fn, r, world, address, device, args, results,
                                                   GROUP_TIMEOUT))
             for r in range(world)]
    for p in procs:
        p.start()
    out: List[Any] = [None] * world
    received = 0
    deadline = time.monotonic() + timeout
    try:
        for _ in range(world):
            try:
                rank, value, err = results.get(timeout=max(1.0, deadline - time.monotonic()))
            except queue_mod.Empty:
                raise TimeoutError(f"run_ranks: no result within {timeout} s") from None
            if err is not None:
                raise RuntimeError(f"rank {rank} failed:\n{err}")
            out[rank] = pickle.loads(value)  # bytes its own rank process wrote
            received += 1
    finally:
        for p in procs:
            p.join(timeout=30 if received == world else 1)
            if p.is_alive():
                p.kill()
                p.join()
    return out

"""The ranks of a sharded prove and their two collectives: the
counterpart of `make_mesh` and `shard_batch` of `pcd_tpu/parallel/mesh.py`
on torch.distributed.

A `Mesh` is one rank's view: a process group, the rank, the group's size
and the rank's device.  Every rank runs the same program on its own shard
(the SPMD shape of the reference's shard_map, written out), and the two
collectives call the group object's own methods, so a group built outside
the default one (`thread_meshes`) works as well as `dist.group.WORLD`:

  all_gather(t)                          -> (size, *t.shape)
  all_to_all(t, split_dim, concat_dim)   the tiled jax.lax.all_to_all

Under NCCL the tensors stay on the card.  gloo moves CPU tensors only for
these two collectives, so a gloo group stages a CUDA tensor through host
memory: that is how gloo carries data, not a fallback.

`make_mesh` joins the default group (initialised by the caller, or from
torchrun's RANK, WORLD_SIZE and LOCAL_RANK, or else NCCL at world size 1
on the card); `thread_meshes` gives n gloo ranks in one process, one a
thread, the counterpart of the reference tests' 8-device virtual CPU mesh,
and `run_ranks` runs one function on each of them.

The reference's `sharded_msm`, `sharded_window_sums` and
`sharded_msm_windows` shard the legacy scan MSM (ops/msm_tensor.py), a
tier the port does not have: its stream tier (parallel/stream_dist.py)
takes every curve of the five configurations.
"""

from __future__ import annotations

import os
import threading
import time
from datetime import timedelta

import torch
import torch.distributed as dist

from ..device import resolve_device


class Mesh:
    """One rank of a process group: `pg` the group object, `rank` and
    `size` its place and extent, `device` where the rank's shards live,
    `backend` "nccl" or "gloo"."""

    def __init__(self, pg, rank: int, size: int, device, backend: str):
        if backend not in ("nccl", "gloo"):
            raise ValueError(f"Mesh: backend 'nccl' or 'gloo', not "
                             f"{backend!r}")
        self.pg = pg
        self.rank, self.size = rank, size
        self.device = torch.device(device)
        self.backend = backend

    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.device.type == "cuda"

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(size, *t.shape): row j is rank j's t, on t's device."""
        x = t.contiguous()
        src = x.cpu() if self._staged(x) else x
        outs = [torch.empty_like(src) for _ in range(self.size)]
        self.pg.allgather([outs], [src]).wait()
        return torch.stack(outs).to(x.device)

    def all_to_all(self, t: torch.Tensor, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
        """The tiled all_to_all: t cut into `size` equal chunks along
        split_dim, chunk j sent to rank j, and the chunks received from
        ranks 0, 1, ... joined along concat_dim.  One alltoall_base over
        the chunks stacked into one contiguous buffer."""
        if t.shape[split_dim] % self.size:
            raise ValueError(f"all_to_all: dim {split_dim} of {tuple(t.shape)}"
                             f" does not split over {self.size} ranks")
        inp = torch.stack(t.chunk(self.size, split_dim))
        src = inp.cpu() if self._staged(inp) else inp
        out = torch.empty_like(src)
        self.pg.alltoall_base(out, src, [], []).wait()
        return torch.cat(out.to(t.device).unbind(0), concat_dim)

    def any(self, flag) -> bool:
        """Whether `flag` (a bool, or a one-element tensor on the rank's
        device) holds on any rank: every rank gets the same answer."""
        t = torch.as_tensor(flag, device=self.device).reshape(1).to(
            torch.int32)
        return bool(self.all_gather(t).any())


def make_mesh(device=None) -> Mesh:
    """The Mesh of this process in the default group.  With no group
    initialised: from torchrun's environment (RANK, WORLD_SIZE and
    LOCAL_RANK; the card LOCAL_RANK for each rank), or else at world size
    1 through a HashStore.  The backend is NCCL for the card, gloo for
    the CPU.  device: None means the card; asking for a card that is not
    there raises."""
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        if all(k in os.environ for k in ("RANK", "WORLD_SIZE")):
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1)
    # a group the caller made over both backends names both
    # ("cpu:gloo,cuda:nccl"): the rank's device picks one
    names = dist.get_backend()
    backend = backend if backend in names else names
    return Mesh(dist.group.WORLD, dist.get_rank(), dist.get_world_size(),
                dev, backend)


def thread_meshes(n: int, device="cpu", timeout_s: float = 60.0) -> list:
    """n gloo ranks over one HashStore in this process, one Mesh each, for
    n threads that each take one (`run_ranks`).  All ranks share `device`
    (the CPU, or one card, whose tensors gloo stages through host
    memory).  A collective that waits longer than timeout_s raises."""
    dev = resolve_device(device)
    store = dist.PrefixStore("thread_meshes", dist.HashStore())
    out = [None] * n
    errors = []

    def join(r):
        try:
            out[r] = Mesh(dist.ProcessGroupGloo(
                store, r, n, timedelta(seconds=timeout_s)), r, n, dev,
                "gloo")
        except Exception as e:
            errors.append(e)

    # the group's constructor waits for all n ranks to join
    ts = [threading.Thread(target=join, args=(r,), daemon=True)
          for r in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout_s)
    if errors:
        raise errors[0]
    if any(m is None for m in out):
        raise TimeoutError(f"thread_meshes: {n} ranks did not join")
    return out


def run_ranks(meshes, fn, timeout_s: float = 300.0) -> list:
    """fn(mesh) on every rank of `meshes`, one thread each; returns their
    results in rank order.  When any rank raised, raises the lowest
    rank's exception; a rank still running after timeout_s raises
    TimeoutError (its thread is a daemon and is left behind)."""
    res = [None] * len(meshes)
    errs = [None] * len(meshes)

    def body(r):
        try:
            res[r] = fn(meshes[r])
        except BaseException as e:
            errs[r] = e

    ts = [threading.Thread(target=body, args=(r,), daemon=True)
          for r in range(len(meshes))]
    for t in ts:
        t.start()
    end = time.monotonic() + timeout_s
    for t in ts:
        t.join(max(0.0, end - time.monotonic()))
    late = [r for r, t in enumerate(ts) if t.is_alive()]
    first = next((e for e in errs if e is not None), None)
    if first is not None:
        raise first
    if late:
        raise TimeoutError(f"run_ranks: ranks {late} still running after "
                           f"{timeout_s} s")
    return res


def shard_batch(t: torch.Tensor, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """This rank's block of t along `dim` (equal blocks, in rank order),
    on the rank's device."""
    if t.shape[dim] % mesh.size:
        raise ValueError(f"shard_batch: dim {dim} of {tuple(t.shape)} does "
                         f"not split over {mesh.size} ranks")
    return t.chunk(mesh.size, dim)[mesh.rank].contiguous().to(mesh.device)

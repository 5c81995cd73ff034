"""Meshes over the live ``torch.distributed`` process group (the reference's
``repro/launch/mesh.py``).

A :class:`Mesh` names the ranks of the world as a grid, ``("data",
"model")`` or ``("pod", "data", "model")``, rank ``r`` at the row-major
coordinates of ``r``, over a ``torch.distributed.device_mesh.DeviceMesh``
with those dim names, whose per-dim process groups carry the collectives.
``mesh.shape`` maps each axis name to its size, as a JAX mesh's does, so
the placement functions of ``distributed/sharding.py`` read it alike.

The production meshes are the reference's: 16 x 16 = 256 ranks (data,
model), or 2 x 16 x 16 = 512 (pod, data, model); on a smaller world they
raise, naming the ranks they need. The counterpart of
``force_host_device_count`` is :func:`run_local_ranks`, which starts N
local processes in one gloo world (the CPU stand-in for a mesh of cards,
and N ranks sharing one card); under ``torchrun`` :func:`init_from_env`
takes the world from its environment.
"""
from __future__ import annotations

import math
import os
import socket
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist


class Mesh:
    """The world as a named grid of ranks, over a ``DeviceMesh`` of the
    backend's device type ("cuda" for NCCL; "cpu" for gloo, whose groups
    also take CUDA tensors)."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str]):
        from torch.distributed.device_mesh import init_device_mesh
        shape, axes = tuple(int(s) for s in shape), tuple(axes)
        need = math.prod(shape)
        world = dist.get_world_size() if dist.is_initialized() else 1
        if not dist.is_initialized() or need != world:
            raise ValueError(
                f"a {'x'.join(map(str, shape))} mesh {axes} needs {need} ranks, but the "
                f"process group has {world if dist.is_initialized() else 'none'}: start "
                f"{need} ranks (torchrun --nproc-per-node, or --host-devices {need})")
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
        self.device_mesh = init_device_mesh(device_type, shape, mesh_dim_names=axes)
        self.shape = dict(zip(axes, shape))
        self.rank = dist.get_rank()
        coords, r = [], self.rank
        for s in reversed(shape):
            coords.append(r % s)
            r //= s
        self.coords = dict(zip(axes, reversed(coords)))

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def coord(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def make_mesh(shape, axes) -> Mesh:
    return Mesh(shape, axes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_host_mesh(model_parallel: int = 1) -> Mesh:
    """(world // model_parallel, model_parallel) over the live world."""
    n = world_size()
    if n % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide {n} ranks")
    return make_mesh((n // model_parallel, model_parallel), ("data", "model"))


def parse_mesh_shape(spec: str, n: Optional[int] = None) -> tuple:
    """'4x2' -> (data=4, model=2); 'auto' splits the ``n`` ranks (default:
    the live world) into (n // m, m) with the model axis as wide a power of
    two as divides n, capped at 8, as the reference does."""
    if spec == "auto":
        n = world_size() if n is None else n
        m = 1
        while m < 8 and n % (m * 2) == 0:
            m *= 2
        return n // m, m
    d, _, m = spec.partition("x")
    return int(d), int(m)


def make_serving_mesh(spec: str = "auto") -> Mesh:
    """(data, model) mesh for ``ServeEngine(..., mesh=...)``."""
    return make_mesh(parse_mesh_shape(spec), ("data", "model"))


# ---------------------------------------------------------------------------
# starting ranks
# ---------------------------------------------------------------------------

def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_world(rank: int, world: int, port: int, backend: str = "gloo") -> None:
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)


def init_from_env() -> bool:
    """Join the world ``torchrun`` describes (``WORLD_SIZE``, ``RANK``,
    ``MASTER_ADDR``, ``MASTER_PORT``): NCCL with a card, one card a rank
    (``LOCAL_RANK``), gloo without. False when no such world is set."""
    if dist.is_initialized():
        return True
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        return False
    backend = "gloo"
    if torch.cuda.is_available():
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        backend = "nccl"
    dist.init_process_group(backend)
    return True


def _rank_main(rank: int, world: int, port: int, threads: int, fn, args, queue):
    torch.set_num_threads(threads)
    try:
        init_world(rank, world, port)
        out = fn(rank, *args)
        queue.put((rank, "ok", out))
    except Exception:                                       # reported to the parent
        queue.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_local_ranks(n: int, fn: Callable[..., Any], *args, threads: int = 1,
                    timeout: float = 600.0) -> List[Any]:
    """Run ``fn(rank, *args)`` in ``n`` spawned processes joined in one gloo
    world on this host (``threads`` intra-op threads each); returns each
    rank's result, by rank. ``fn`` and its results must pickle. A rank that
    raises makes this raise with its traceback."""
    import queue as queue_mod

    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, n, port, threads, fn, args, q))
             for r in range(n)]
    for p in procs:
        p.start()
    results: dict = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < n:
            try:
                rank, status, out = q.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs) if r not in results
                        and p.exitcode is not None]
                if dead or time.monotonic() > deadline:
                    raise RuntimeError(
                        f"local ranks {dead or 'all'} gave no result "
                        f"({'exited' if dead else f'in {timeout} s'}; "
                        f"{sorted(results)} answered)") from None
                continue
            if status != "ok":
                raise RuntimeError(f"rank {rank} of {n} failed:\n{out}")
            results[rank] = out
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(n)]

"""Run one function on every rank of a one-host mesh.

``spawn(fn, nranks, args)`` starts ``nranks`` processes (``spawn`` start
method), joins them into a ``gloo`` process group (file rendezvous in a
temporary directory), maps the shared host pool of the ``cxl`` backend
when asked, and calls ``fn(ctx, *args)`` on each with a
:class:`RankContext`.  ``groups`` adds level groups (the ranks of one
level of a hierarchical mesh, ``launch.mesh.level_groups``): every rank
creates each one's process group, in the same order, and with a pool
each group maps a pool of its own with one partition per member, since
a pool's epochs agree only among ranks that issue the same collectives.
Rank r runs on ``cuda:(r % device_count)`` - the ranks of a one-card
host share that card - or on the CPU.  Results come back in rank order;
a rank that raises, dies or outlives the deadline fails the call, and
every process is stopped before it returns.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import queue
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence

import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.pool import SharedPool, create_backing


@dataclasses.dataclass
class RankContext:
    rank: int
    nranks: int
    device: torch.device
    pool: Optional[SharedPool]          # the pool of all the ranks
    # level group (a tuple of ranks) -> (its process group, its pool or
    # None), for each group of ``spawn(groups=...)`` this rank is in
    groups: dict = dataclasses.field(default_factory=dict)


def _rank_main(rank: int, nranks: int, fn: Callable, args: tuple,
               device: str, init_file: str, pool_path: Optional[str],
               groups: tuple, group_paths: tuple, partition_bytes: int,
               timeout_s: float, results) -> None:
    import torch.distributed as dist
    pool = None
    pools: list = []
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{init_file}", world_size=nranks,
            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
        if device == "cuda":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        else:
            dev = torch.device("cpu")
            # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // nranks))
        if pool_path is not None:
            pool = SharedPool(pool_path, nranks, rank, partition_bytes, dev,
                              timeout_s=timeout_s)
            pools.append(pool)
        mine: dict = {}
        for members, path in zip(groups, group_paths):
            # every rank creates every group, in the same order
            pg = dist.new_group(list(members),
                                timeout=datetime.timedelta(seconds=timeout_s))
            if rank not in members:
                continue
            gpool = None
            if path is not None:
                gpool = SharedPool(path, len(members), members.index(rank),
                                   partition_bytes, dev, timeout_s=timeout_s)
                pools.append(gpool)
            mine[members] = (pg, gpool)
        out = fn(RankContext(rank, nranks, dev, pool, mine), *args)
        results.put((rank, out, None))
    except Exception:   # the boundary of a rank: report, then exit
        results.put((rank, None, traceback.format_exc()))
    finally:
        for p in pools:
            p.close()
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, nranks: int, args: tuple = (), *,
          device: str, partition_bytes: int = 0,
          groups: Sequence[tuple] = (), world_pool: bool = True,
          poolless: Sequence[tuple] = (), timeout_s: float = 600.0,
          wait_s: Optional[float] = None) -> list:
    """``fn(ctx, *args)`` on ``nranks`` ranks; returns the results in
    rank order.  ``device`` ("cuda" or "cpu") has no default: a caller
    states where its ranks run, so none lands on the CPU by omission.  ``partition_bytes > 0`` maps a shared pool with that
    partition per rank (``ctx.pool``; not with ``world_pool=False``)
    and one per level group of ``groups`` (tuples of ranks; see
    :class:`RankContext`) but those in ``poolless``, which get a
    process group only.  ``fn`` and ``args`` must pickle (``fn`` a
    module-level function).  ``timeout_s`` bounds every wait of a rank
    (process group, pool); ``wait_s`` (default ``timeout_s``) is how
    long this process waits for the next rank to finish."""
    import torch.multiprocessing as mp
    if device == "cuda":
        resolve_device("cuda")          # raises without a card
    wait_s = timeout_s if wait_s is None else wait_s
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    groups = tuple(tuple(int(r) for r in g) for g in groups)
    fds: list = []
    procs = []

    def backing(n: int) -> Optional[str]:
        if partition_bytes <= 0:
            return None
        path, fd = create_backing(SharedPool.total_bytes(n,
                                                         partition_bytes))
        fds.append(fd)
        return path

    with tempfile.TemporaryDirectory(prefix="repro-ranks-") as tmp:
        try:
            pool_path = backing(nranks) if world_pool else None
            bare = {tuple(int(r) for r in g) for g in poolless}
            group_paths = tuple(None if g in bare else backing(len(g))
                                for g in groups)
            procs = [ctx.Process(
                target=_rank_main,
                args=(r, nranks, fn, args, device,
                      os.path.join(tmp, "rdzv"), pool_path, groups,
                      group_paths, partition_bytes, timeout_s, results))
                for r in range(nranks)]
            for p in procs:
                p.start()
            got: dict = {}
            t_end = time.monotonic() + wait_s
            while len(got) < nranks:
                try:
                    rank, res, err = results.get(timeout=2.0)
                except queue.Empty:
                    dead = [p.exitcode for p in procs
                            if p.exitcode not in (None, 0)]
                    if dead or time.monotonic() > t_end:
                        raise RuntimeError(f"ranks lost (exit codes "
                                           f"{dead})") from None
                    continue
                if err is not None:
                    raise RuntimeError(f"rank {rank} failed:\n{err}")
                got[rank] = res
                t_end = time.monotonic() + wait_s
            for p in procs:
                p.join(timeout=60)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=30)
            for fd in fds:
                os.close(fd)
    return [got[r] for r in range(nranks)]

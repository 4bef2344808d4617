"""Run one function on every rank of a one-host mesh.

``spawn(fn, nranks, args)`` starts ``nranks`` processes (``spawn`` start
method), joins them into a ``gloo`` process group (file rendezvous in a
temporary directory), maps the shared host pool of the ``cxl`` backend
when asked, and calls ``fn(ctx, *args)`` on each with a
:class:`RankContext`.  Rank r runs on ``cuda:(r % device_count)`` - the
ranks of a one-card host share that card - or on the CPU.  Results come
back in rank order; a rank that raises, dies or outlives the deadline
fails the call, and every process is stopped before it returns.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import queue
import tempfile
import time
import traceback
from typing import Callable, Optional

import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.pool import SharedPool, create_backing


@dataclasses.dataclass
class RankContext:
    rank: int
    nranks: int
    device: torch.device
    pool: Optional[SharedPool]


def _rank_main(rank: int, nranks: int, fn: Callable, args: tuple,
               device: str, init_file: str, pool_path: Optional[str],
               partition_bytes: int, timeout_s: float, results) -> None:
    import torch.distributed as dist
    pool = None
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
        out = fn(RankContext(rank, nranks, dev, pool), *args)
        results.put((rank, out, None))
    except Exception:   # the boundary of a rank: report, then exit
        results.put((rank, None, traceback.format_exc()))
    finally:
        if pool is not None:
            pool.close()
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, nranks: int, args: tuple = (), *,
          device: str = "cpu", partition_bytes: int = 0,
          timeout_s: float = 600.0,
          wait_s: Optional[float] = None) -> list:
    """``fn(ctx, *args)`` on ``nranks`` ranks; returns the results in
    rank order.  ``partition_bytes > 0`` maps a shared pool with that
    partition per rank.  ``fn`` and ``args`` must pickle (``fn`` a
    module-level function).  ``timeout_s`` bounds every wait of a rank
    (process group, pool); ``wait_s`` (default ``timeout_s``) is how
    long this process waits for the next rank to finish."""
    import torch.multiprocessing as mp
    if device == "cuda":
        resolve_device("cuda")          # raises without a card
    wait_s = timeout_s if wait_s is None else wait_s
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    fd = None
    procs = []
    with tempfile.TemporaryDirectory(prefix="repro-ranks-") as tmp:
        pool_path = None
        if partition_bytes > 0:
            pool_path, fd = create_backing(
                SharedPool.total_bytes(nranks, partition_bytes))
        try:
            procs = [ctx.Process(
                target=_rank_main,
                args=(r, nranks, fn, args, device,
                      os.path.join(tmp, "rdzv"), pool_path,
                      partition_bytes, timeout_s, results))
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
            if fd is not None:
                os.close(fd)
    return [got[r] for r in range(nranks)]

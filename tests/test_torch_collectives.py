"""The port's flat collectives against the reference ``Communicator``.

Every flat primitive (``repro_torch.launch.collectives.PRIMITIVES``: all
eight, all-reduce in both modes, and the p2p shift) runs under ``ring``
and ``cxl`` on 4 gloo CPU ranks (``repro_torch.launch.ranks``; the cxl
ranks share one host pool) and, on the same numpy inputs, through
``repro.core.api.Communicator`` under ``shard_map`` over 4 forced host
devices (in a subprocess, so the device count never leaks into this
process).  Data movement must match bitwise; reductions to f32 rounding
of a 4-term sum taken in another order (rtol 1e-6, atol 1e-6).  The
ledger's per-primitive wire bytes of each call must equal the
reference's ``ledger.snapshot()`` of the same call.  The pool's
partition is 4 KiB, so the 10 KiB cases stream through it in rounds.
The ranks and the reference each run once per module; the tests assert
on their results.

Also runnable as a script: ``python tests/test_torch_collectives.py
--reference OUT.npz CASES.npz`` writes the reference's results.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT_DIR = os.path.dirname(HERE)
NR = 4
REDUCING = ("reduce_scatter", "all_reduce_faithful", "all_reduce_two_phase",
            "reduce")


def _cases() -> list:
    """(primitive, backend, input shape, slicing factor) per case."""
    from repro_torch.launch.collectives import PRIMITIVES
    out = [(name, b, (8, 6), 4) for name in PRIMITIVES
           for b in ("ring", "cxl")]
    out += [(name, "cxl", shape, sf)
            for name, shape, sf in (
                ("all_reduce_two_phase", (5, 3), 4),   # padded to 16
                ("all_reduce_faithful", (6, 5), 4),    # 6 rows: 1 chunk
                ("all_gather", (12, 7), 3),
                ("reduce_scatter", (12, 7), 2),
                ("broadcast", (3, 7), 1),
                ("p2p", (4, 9), 2),
                # 10 KiB buffers through a 4 KiB partition: in rounds
                ("all_gather", (64, 40), 4),
                ("reduce_scatter", (64, 40), 4),
                ("all_to_all", (64, 40), 4),
                ("scatter", (64, 40), 4))]
    return out


def _case_id(case) -> str:
    name, backend, shape, sf = case
    return f"{name}-{backend}-{'x'.join(map(str, shape))}-sf{sf}"


CASES = _cases()


def _inputs(case, i) -> list:
    rng = np.random.default_rng(100 + i)
    return [rng.standard_normal(case[2]).astype(np.float32)
            for _ in range(NR)]


def reference_main(out_path: str, cases_path: str) -> None:
    """The reference side, in a process with 4 forced host devices."""
    import jax
    from jax.sharding import PartitionSpec as P

    from repro.core import ledger
    from repro.core.api import Communicator
    from repro_torch.launch.collectives import PRIMITIVES, ROOT, ROOTED

    mesh = jax.make_mesh((NR,), ("data",))
    out = {}
    with np.load(cases_path) as f:
        data = {k: f[k] for k in f.files}
    for i, (name, backend, _shape, sf) in enumerate(CASES):
        method, mode = PRIMITIVES[name]
        comm = Communicator(backend=backend, slicing_factor=sf,
                            allreduce_mode=mode or "two_phase")

        def fn(x, comm=comm, method=method, name=name):
            if name in ROOTED:
                return getattr(comm, method)(x, "data", root=ROOT)
            return getattr(comm, method)(x, "data")

        ledger.reset()
        f = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=P("data"),
                                  out_specs=P("data"), check_vma=False))
        y = np.asarray(f(data[f"x{i}"]))
        for r, part in enumerate(np.split(y, NR)):
            out[f"y{i}_{r}"] = part
        for kind, b in ledger.snapshot()["wire_bytes"].items():
            out[f"wire{i}_{kind}"] = np.float64(b)
    np.savez(out_path, **out)


def _run_port(cases_inputs) -> list:
    from repro_torch.launch import collectives, ranks
    cases = [dict(name=c[0], backend=c[1], slicing_factor=c[3], x=xs)
             for c, xs in cases_inputs]
    return ranks.spawn(collectives.rank_cases, NR, (cases,), device="cpu",
                       partition_bytes=1 << 12, timeout_s=120.0)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_collectives")
    cases_path, ref_path = str(tmp / "cases.npz"), str(tmp / "ref.npz")
    inputs = [_inputs(c, i) for i, c in enumerate(CASES)]
    np.savez(cases_path, **{f"x{i}": np.concatenate(xs)
                            for i, xs in enumerate(inputs)})
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(ROOT_DIR, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    ref = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                            "--reference", ref_path, cases_path], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
    try:
        mine = _run_port(list(zip(CASES, inputs)))
        log, _ = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, log[-3000:]
    with np.load(ref_path) as f:
        reference = {k: f[k] for k in f.files}
    return inputs, mine, reference


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[_case_id(c) for c in CASES])
def test_collective_matches_reference_and_oracle(results, i):
    from repro_torch.launch.collectives import oracle
    inputs, mine, reference = results
    name = CASES[i][0]
    for r in range(NR):
        got, _ = mine[r][i]
        want = reference[f"y{i}_{r}"]
        assert got.shape == want.shape and got.dtype == want.dtype
        if name in REDUCING:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(got, oracle(name, inputs[i], r),
                                       rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got, oracle(name, inputs[i], r))


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[_case_id(c) for c in CASES])
def test_collective_books_the_reference_wire_bytes(results, i):
    _, mine, reference = results
    prefix = f"wire{i}_"
    want = {k[len(prefix):]: float(v) for k, v in reference.items()
            if k.startswith(prefix)}
    assert want
    for r in range(NR):
        assert mine[r][i][1] == want


@pytest.mark.parametrize("backend", ["ring", "cxl"])
@pytest.mark.parametrize("name", ["reduce_scatter", "all_to_all",
                                  "scatter"])
def test_leading_dim_must_divide_the_axis(backend, name):
    """The reference's ValueError, raised before anything moves (so one
    process with a 4-rank axis and no process group can show it)."""
    from repro_torch.core.api import Communicator
    from repro_torch.core.mesh_collectives import AxisGroup
    from repro_torch.launch.collectives import call
    comm = Communicator(backend=backend,
                        axes={"data": AxisGroup("data", 0, NR)})
    with pytest.raises(ValueError, match="must divide axis"):
        call(comm, name, torch.zeros((6, 3)))


def test_split_chunks_follows_the_reference_rule():
    from repro_torch.core.mesh_collectives import _split_chunks
    x = torch.arange(24.).reshape(8, 3)
    assert [c.shape[0] for c in _split_chunks(x, 4)] == [2, 2, 2, 2]
    assert len(_split_chunks(x, 3)) == 1          # 8 rows: no split
    assert len(_split_chunks(x, 1)) == 1
    assert len(_split_chunks(torch.tensor(1.), 4)) == 1


def _pool_pair(partition_bytes: int, timeout_s: float):
    from repro_torch.core.pool import SharedPool, create_backing
    path, fd = create_backing(SharedPool.total_bytes(2, partition_bytes))
    return fd, [SharedPool(path, 2, r, partition_bytes, "cpu",
                           timeout_s=timeout_s) for r in range(2)]


def test_shared_pool_exchange_in_rounds_between_two_handles():
    """Two ranks' handles on one pool (threads in this process): each
    publishes a 10 KiB buffer through a 4 KiB partition (3 rounds, each
    one epoch) in 3 chunks a round and retrieves the other's, twice, so
    the second call reuses every doorbell and done word."""
    import threading
    fd, pools = _pool_pair(4096, 20.0)
    try:
        rng = np.random.default_rng(0)
        for call in range(2):
            src = [torch.as_tensor(rng.integers(0, 256, 10240,
                                                dtype=np.uint8))
                   for _ in range(2)]
            dst = [torch.zeros(10240, dtype=torch.uint8) for _ in range(2)]
            errs = []

            def run(r):
                try:
                    pools[r].exchange(src[r], 10240, [(1 - r, 0, dst[r])],
                                      3)
                except Exception as exc:      # reported below
                    errs.append(exc)
            threads = [threading.Thread(target=run, args=(r,))
                       for r in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            assert not any(t.is_alive() for t in threads) and not errs
            for r in range(2):
                assert torch.equal(dst[r], src[1 - r])
                assert pools[r].epoch == 3 * (call + 1)
    finally:
        os.close(fd)


def test_shared_pool_lost_rank_raises_at_the_deadline():
    from repro_torch.core.pool import PoolAccessError
    fd, pools = _pool_pair(4096, 0.2)
    try:
        buf = torch.zeros(64, dtype=torch.uint8)
        with pytest.raises(PoolAccessError, match="doorbell of rank 1"):
            pools[0].exchange(buf, 64, [(1, 0, buf.clone())], 1)
        # the next call may not overwrite the partition before rank 1
        # has finished the previous epoch
        with pytest.raises(PoolAccessError, match="done word of rank 1"):
            pools[0].exchange(buf, 64, [], 1)
    finally:
        os.close(fd)


def test_shared_pool_consults_the_fault_hook():
    from repro_torch.core import pool as pool_mod

    def hook(op, info):
        if op == "write":
            raise pool_mod.PoolAccessError(f"injected at rank {info['rank']}")
    fd, pools = _pool_pair(4096, 1.0)
    pool_mod.set_fault_hook(hook)
    try:
        with pytest.raises(pool_mod.PoolAccessError, match="injected"):
            pools[0].exchange(torch.zeros(64, dtype=torch.uint8), 64, [], 1)
    finally:
        pool_mod.clear_fault_hook()
        os.close(fd)


def test_bench_times_ring_only_up_to_ring_max_mb():
    """``launch.collectives.bench(ring_max_mb=...)`` times the gloo ring
    only up to that size a rank and cxl at every size, each result
    held to the oracle."""
    from repro_torch.launch import collectives
    rows = collectives.bench(2, (1, 2), reps=1, device="cpu",
                             names=("all_gather", "reduce_scatter"),
                             ring_max_mb=1)
    assert sorted((r["mb"], r["backend"]) for r in rows) == sorted(
        [(1, "ring"), (1, "cxl"), (2, "cxl")] * 2)
    assert all(r["ok"] for r in rows)


def test_bench_all_runs_both_tables_on_one_spawn():
    """``launch.collectives.bench_all``: the flat table and the tuple
    table over ("pod", "data") = (2, 2) from one spawn of the ranks, the
    cells of ``bench`` and ``bench_tuple``, each result held to the
    oracle and each tuple result to the flat axis'."""
    from repro_torch.launch import collectives
    names = ("all_gather", "reduce_scatter")
    flat, tup = collectives.bench_all(4, (1, 2), (1,), reps=1, device="cpu",
                                      ring_max_mb=1, names=names,
                                      tuple_names=("all_reduce_two_phase",))
    assert sorted((r["primitive"], r["mb"], r["backend"]) for r in flat) \
        == sorted((n, mb, b) for n in names
                  for mb, b in ((1, "ring"), (1, "cxl"), (2, "cxl")))
    assert sorted((r["backend"], r["axis"]) for r in tup) == sorted(
        (b, a) for b in collectives.tuple_backends(1)
        for a in ("flat", "tuple"))
    assert all(r["ok"] for r in flat + tup)
    assert all(r["equal_flat"] for r in tup if r["axis"] == "tuple")


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--reference":
        reference_main(sys.argv[2], sys.argv[3])
    else:
        print("usage: --reference OUT.npz CASES.npz")
        sys.exit(2)

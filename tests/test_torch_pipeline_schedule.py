"""The port's pipeline schedules against the reference's: the 13 cases of
``tests/test_pipeline_schedule.py`` on ``repro_torch.training.pipeline``,
each over the whole grid the reference's property draws from (S in 1-6
and M in 1-12 for 1F1B; S in 1-4, M = k S with k in 1-3 and v in 2-4
interleaved), and at every point the port's op lists, simulated spans,
bubble counts and fractions equal the reference's (errors and deadlocks
too).  The schedules are copied, so equality is exact."""
import itertools

import pytest

from repro.training import pipeline as ref
from repro_torch.training import pipeline as port
from repro_torch.training.pipeline import (Op, PipelineDeadlock,
                                           bubble_count, bubble_fraction,
                                           make_schedule, schedule_1f1b,
                                           schedule_interleaved, simulate)

GRID_1F1B = list(itertools.product(range(1, 7), range(1, 13)))
GRID_INTERLEAVED = [(S, k * S, v) for S in range(1, 5) for k in range(1, 4)
                    for v in range(2, 5)]


def _ops(per_stage) -> list:
    return [[(o.kind, o.microbatch, o.chunk) for o in ops]
            for ops in per_stage]


def _same_1f1b(S, M) -> list:
    got = schedule_1f1b(S, M)
    assert _ops(got) == _ops(ref.schedule_1f1b(S, M)), (S, M)
    return got


def _same_interleaved(S, M, v) -> list:
    got = schedule_interleaved(S, M, n_chunks=v)
    assert _ops(got) == _ops(ref.schedule_interleaved(S, M, n_chunks=v))
    return got


# --------------------------------------------------------------------- #
# 1F1B
# --------------------------------------------------------------------- #

def test_1f1b_deadlock_free_with_closed_form_span():
    for S, M in GRID_1F1B:
        span = simulate(_same_1f1b(S, M))
        assert span == ref.simulate(ref.schedule_1f1b(S, M))
        assert span == 2 * M + 2 * (S - 1)


def test_1f1b_each_stage_runs_every_microbatch_once():
    for S, M in GRID_1F1B:
        for ops in _same_1f1b(S, M):
            assert len(ops) == 2 * M
            assert sorted(o.microbatch for o in ops if o.kind == "F") == \
                list(range(M))
            assert sorted(o.microbatch for o in ops if o.kind == "B") == \
                list(range(M))
            assert all(o.chunk == 0 for o in ops)


def test_1f1b_forward_precedes_backward():
    for S, M in GRID_1F1B:
        for ops in _same_1f1b(S, M):
            seen_f = set()
            for o in ops:
                if o.kind == "F":
                    seen_f.add(o.microbatch)
                else:
                    assert o.microbatch in seen_f, (o, ops)


def test_1f1b_bubble_reconciles_with_span():
    for S, M in GRID_1F1B:
        span = simulate(_same_1f1b(S, M))
        assert span - 2 * M == bubble_count(S, M, "1f1b") \
            == ref.bubble_count(S, M, "1f1b")
        assert bubble_fraction(S, M, "1f1b") == \
            ref.bubble_fraction(S, M, "1f1b")
        assert bubble_fraction(S, M, "1f1b") == pytest.approx(
            (span - 2 * M) / span)


def test_1f1b_warmup_depth_bounds_live_activations():
    for S, M in GRID_1F1B:
        for s, ops in enumerate(_same_1f1b(S, M)):
            live = peak = 0
            for o in ops:
                live += 1 if o.kind == "F" else -1
                peak = max(peak, live)
            assert peak == min(S - s, M), (S, M, s, peak)


# --------------------------------------------------------------------- #
# interleaved
# --------------------------------------------------------------------- #

def test_interleaved_deadlock_free_with_closed_form_span():
    for S, M, v in GRID_INTERLEAVED:
        span = simulate(_same_interleaved(S, M, v), n_chunks=v)
        assert span == ref.simulate(
            ref.schedule_interleaved(S, M, n_chunks=v), n_chunks=v)
        assert span == 2 * M * v + 2 * (S - 1)


def test_interleaved_forward_precedes_backward_per_chunk():
    for S, M, v in GRID_INTERLEAVED:
        for ops in _same_interleaved(S, M, v):
            assert len(ops) == 2 * M * v
            seen = set()
            for o in ops:
                assert 0 <= o.chunk < v
                if o.kind == "F":
                    assert (o.microbatch, o.chunk) not in seen
                    seen.add((o.microbatch, o.chunk))
                else:
                    assert (o.microbatch, o.chunk) in seen, (o, ops)


def test_interleaved_bubble_shrinks_by_chunk_count():
    for S, M, v in GRID_INTERLEAVED:
        span = simulate(_same_interleaved(S, M, v), n_chunks=v)
        assert span - 2 * M * v == bubble_count(S, M, "interleaved", v) \
            == ref.bubble_count(S, M, "interleaved", v)
        frac = bubble_fraction(S, M, "interleaved", v)
        assert frac == ref.bubble_fraction(S, M, "interleaved", v)
        assert frac == pytest.approx((span - 2 * M * v) / span)
        if S > 1:
            assert frac < bubble_fraction(S, M, "1f1b")


def test_interleaved_requires_divisible_microbatches():
    for mod in (port, ref):
        with pytest.raises(ValueError, match="microbatches % stages"):
            mod.schedule_interleaved(3, 4, n_chunks=2)


def test_interleaved_single_chunk_is_1f1b():
    assert schedule_interleaved(3, 6, n_chunks=1) == schedule_1f1b(3, 6)
    assert _ops(schedule_interleaved(3, 6, n_chunks=1)) == \
        _ops(ref.schedule_interleaved(3, 6, n_chunks=1))


# --------------------------------------------------------------------- #
# dispatcher + simulator
# --------------------------------------------------------------------- #

def test_make_schedule_dispatch_and_validation():
    assert make_schedule("1f1b", 2, 4) == schedule_1f1b(2, 4)
    assert make_schedule("interleaved", 2, 4, n_chunks=2) == \
        schedule_interleaved(2, 4, n_chunks=2)
    assert port.SCHEDULES == ref.SCHEDULES
    for mod in (port, ref):
        with pytest.raises(ValueError, match="unknown schedule"):
            mod.make_schedule("gpipe", 2, 4)
        with pytest.raises(ValueError):
            mod.schedule_1f1b(0, 4)
        with pytest.raises(ValueError):
            mod.schedule_1f1b(2, 0)
        with pytest.raises(ValueError):
            mod.bubble_count(2, 4, "gpipe")
        with pytest.raises(ValueError, match="n_chunks"):
            mod.schedule_interleaved(2, 4, n_chunks=0)


def test_simulate_detects_deadlock():
    bad = [[("F", 0), ("B", 1), ("F", 1), ("B", 0)],
           [("F", 0), ("B", 0), ("F", 1), ("B", 1)]]
    for mod in (port, ref):
        with pytest.raises(mod.PipelineDeadlock, match="wedged"):
            mod.simulate([[mod.Op("B", 0), mod.Op("F", 0)]])
        with pytest.raises(mod.PipelineDeadlock):
            mod.simulate([[mod.Op(*o) for o in ops] for ops in bad])
    with pytest.raises(PipelineDeadlock) as got:
        simulate([[Op(*o) for o in ops] for ops in bad])
    with pytest.raises(ref.PipelineDeadlock) as want:
        ref.simulate([[ref.Op(*o) for o in ops] for ops in bad])
    # the same tick and ops left (the stuck ops print their own package)
    assert str(got.value).split(":")[0] == str(want.value).split(":")[0]


def test_simulate_degenerate_single_stage():
    assert simulate(schedule_1f1b(1, 5)) == 10 == \
        ref.simulate(ref.schedule_1f1b(1, 5))
    assert bubble_count(1, 5) == 0 == ref.bubble_count(1, 5)
    assert bubble_fraction(1, 5) == 0.0 == ref.bubble_fraction(1, 5)

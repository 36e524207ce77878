"""The ``program`` phase (benchmark/program_trace.py) and the readers of the
program's counters: the idle sweep and the readings on hand-built phases
with known shares, the readers against known counts and against a program
without counters, and the tiny CPU cells traced with the phase."""

import time

import pytest
import torch

from benchmark import harness, program_trace
from benchmark.program_trace import OUTSIDE, ProgramSummary, sweep
from benchmark.registry import Registry
from benchmark.tests.tiny import SEED, run_tiny, tiny_overrides
from ganmf_tpu_torch.utils import profiling
from ganmf_tpu_torch.utils.profiling import Span

S = 1e-9  # seconds in a nanosecond


def _spans(*rows):
    """Spans from (name, start, end, parent); roots are found from parents."""
    out = []
    for i, (name, a, b, parent) in enumerate(rows):
        out.append(Span(name, a, b, parent, i if parent < 0 else out[parent].root))
    return out


def test_sweep_gives_idle_to_the_innermost_span():
    spans = _spans(("A", 0, 90, -1), ("B", 5, 30, 0), ("C", 40, 70, 0))
    got = sweep((0, 100), [(10, 20), (50, 60)], spans)
    assert got == pytest.approx({"A": 35 * S, "B": 15 * S, "C": 20 * S, OUTSIDE: 10 * S})


def test_sweep_splits_at_shared_edges_and_clips_to_the_window():
    # C ends where D starts, R ends where E starts, F starts with its parent E
    spans = _spans(("R", 0, 200, -1), ("C", 10, 20, 0), ("D", 20, 30, 0), ("E", 200, 250, -1),
                   ("F", 200, 210, 3))
    got = sweep((5, 230), [], spans)
    assert got == pytest.approx({"R": (5 + 170) * S, "C": 10 * S, "D": 10 * S, "E": 20 * S, "F": 10 * S})
    assert sum(got.values()) == pytest.approx(225 * S)


def _train_phase():
    # two epochs of 100 ns; in each the shuffle, one D and one G step
    rows = []
    for e in range(2):
        t = 100 * e
        r = len(rows)
        rows.append(("train.epoch", t, t + 100, -1))
        rows.append(("train.shuffle", t, t + 10, r))
        for step, a in (("train.d_step", 10), ("train.g_step", 55)):
            s = len(rows)
            rows.append((step, t + a, t + a + 45, r))
            rows.append(("train.rows", t + a, t + a + 5, s))
            rows.append(("train.grad", t + a + 5, t + a + 30, s))
            rows.append(("train.update", t + a + 30, t + a + 45, s))
    busy = [(100 * e + a, 100 * e + a + 20) for e in range(2) for a in (15, 60)]  # in each step's grad
    return ProgramSummary((0, 200), busy, _spans(*rows), {"host_sync.train.shuffle": 2, "train.epoch.calls": 2})


def test_readings_of_a_training_phase():
    p = _train_phase()
    r = p.readings()
    assert r["units"] == 2 and p.root() == "train.epoch"
    # grad [a+5, a+30) holds the busy [a+5, a+25): 5 ns idle a step, 4 steps
    assert r["train.idle_in_grad"] == pytest.approx(100 * 20 / 200)
    assert r["train.idle_in_update"] == pytest.approx(100 * 60 / 200)
    assert r["host_syncs_per_unit"] == 1.0
    assert r["idle_named_share"] == pytest.approx(100.0)
    assert "eval.idle_in_prep" not in r and "serve.idle_in_call_us" not in r
    assert p.idle_s == pytest.approx((200 - 80) * S)
    lines = p.table()
    assert any(line.startswith("train.grad ") for line in lines)
    assert "counter host_sync.train.shuffle: 1.0 per unit" in lines


def test_readings_of_an_evaluation_phase():
    rows = [("eval.evaluate", 0, 100, -1), ("eval.order", 0, 10, 0), ("eval.block", 10, 90, 0),
            ("eval.prep", 10, 30, 2), ("eval.rank", 30, 60, 2), ("eval.metrics", 60, 90, 2),
            ("eval.finalize", 90, 100, 0)]
    p = ProgramSummary((0, 120), [(30, 60), (95, 100)], _spans(*rows),
                       {"host_sync.eval.uids": 1, "host_sync.eval.valid": 1, "host_sync.eval.sums": 1})
    r = p.readings()
    assert r["eval.idle_in_prep"] == pytest.approx(100 * 30 / 120)
    assert r["eval.idle_in_metrics"] == pytest.approx(100 * 30 / 120)
    assert r["host_syncs_per_unit"] == 3.0
    assert r["idle_by_span"][OUTSIDE] == pytest.approx(20 * S)
    assert r["idle_named_share"] == pytest.approx(100 * (85 - 20) / 85)


def test_readings_of_a_serving_phase():
    rows, busy = [], []
    for c, idle in enumerate((30, 10, 20)):  # idle ns inside each 50 ns call
        t = 100 * c
        rows.append(("serve.recommend", t, t + 50, -1))
        rows.append(("serve.rank", t + 10, t + 40, len(rows) - 1))
        busy.append((t, t + 50 - idle))
    p = ProgramSummary((0, 300), busy, _spans(*rows), {"host_sync.serve.ids": 3, "serve.recommend.calls": 3})
    r = p.readings()
    assert r["serve.idle_in_call_us"] == pytest.approx(20 / 1e3)
    assert r["host_syncs_per_unit"] == 1.0


def test_an_empty_phase_reads_nothing():
    p = ProgramSummary((0, 100), [(0, 50)], [], {})
    r = p.readings()
    assert p.root() is None and r["units"] == 0 and r["host_syncs_per_unit"] is None
    assert r["idle_named_share"] == pytest.approx(0.0)


@pytest.mark.parametrize("metric,root,want", [
    ("train.host_syncs_per_epoch", "train.epoch", 1.0),
    ("eval.host_syncs_per_evaluation", "eval.evaluate", 78.0),
    ("serve.host_syncs_per_call", "serve.recommend", 3.0),
])
def test_host_sync_readers(metric, root, want, monkeypatch):
    reader = Registry().reader(metric)
    layer = root.split(".")[0]
    counts = {f"{root}.calls": 4, f"host_sync.{layer}.a": int(want * 4) - 1, f"host_sync.{layer}.b": 1,
              "host_sync.other.c": 5, "k1.launches": 99}
    monkeypatch.setattr(profiling, "counters", lambda: dict(counts))
    assert reader.read({}) == want
    counts[f"{root}.calls"] = 0
    assert reader.read({}) is None
    monkeypatch.delattr(profiling, "counters")  # a program without the counters
    assert reader.read({}) is None


#: the registered metric of each cell and its value at the tiny size (one
#: evaluation block: its two uploads and the two reads back)
HOST_SYNCS = {"ganmf-ml20m.train": ("train.host_syncs_per_epoch", 1.0),
              "ganmf-ml20m.eval": ("eval.host_syncs_per_evaluation", 4.0),
              "ganmf-ml1m.serve": ("serve.host_syncs_per_call", 3.0)}
ROOT_OF = {"ganmf-ml20m.train": "train.epoch", "ganmf-ml20m.eval": "eval.evaluate",
           "ganmf-ml1m.serve": "serve.recommend"}


@pytest.mark.parametrize("cell", list(HOST_SYNCS))
def test_tiny_cells_traced_with_the_program_phase(cell):
    result, program = program_trace.run_cell(Registry(), cell, SEED, 0.3, torch.device("cpu"),
                                             time.perf_counter(), overrides=tiny_overrides(cell))
    assert result["correct"]
    r = result["program"]
    metric, want = HOST_SYNCS[cell]
    assert program.root() == ROOT_OF[cell] and r["units"] > 0
    assert r["host_syncs_per_unit"] == want
    assert result["metrics"][metric]["value"] == want
    names = {s.name for s in program.spans}
    assert {"train": {"train.shuffle", "train.d_step", "train.g_step", "train.grad", "train.update"},
            "eval": {"eval.order", "eval.block", "eval.prep", "eval.rank", "eval.metrics", "eval.finalize"},
            "serve": {"serve.ids", "serve.mask", "serve.rank", "serve.readback", "serve.lists"},
            }[cell.split(".")[1]] <= names
    assert r["idle_s"] == pytest.approx(program.window_s)  # no card: all idle
    assert profiling.span("x") is profiling.span("y")  # the recorder is off again
    assert harness.Tracer is program_trace.Tracer


def test_plain_traced_run_reads_the_host_syncs():
    result = run_tiny("ganmf-ml1m.serve", trace=True)
    assert result["metrics"]["serve.host_syncs_per_call"] == {"value": 3.0, "unit": "syncs/call"}
    assert {"serve.mfu", "serve.device_idle"} <= set(result["metrics"])
    assert "program" not in result


def test_the_tool_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert program_trace.main(["--workload", "ganmf-ml1m.serve", "--seed", "1", "--seconds", "1"]) == 2

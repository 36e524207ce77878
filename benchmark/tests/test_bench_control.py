"""The comparison that decides ``correct``: a sound run passes, and the
control and every fault a cell can have fail, each driven through the rest
of a run at a size a test run holds (the harness's look for a card
skipped). The training control, TF32 in the program's own products, exists
only on a card."""

import contextlib
import math
import time

import pytest
import torch

from benchmark import faults, harness
from benchmark.registry import Registry
from benchmark.tests.tiny import SEED, TINY, cuda_device, run_tiny, tiny_overrides  # noqa: F401  (a fixture)

CELLS = ["ganmf-ml20m.train", "ganmf-ml20m.eval", "ganmf-ml1m.serve"]
#: the faults each cell can have (one card: no exchange between chips)
FAULTS = {
    "ganmf-ml20m.train": ["unchanged", "half_batch"],
    "ganmf-ml20m.eval": ["half_batch", "altered"],
    "ganmf-ml1m.serve": ["altered"],
}


def _numbers(result):
    return {k: v["value"] for k, v in result["check"].items()}


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    result = run_tiny(cell)
    assert result["correct"], _numbers(result)
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "check"


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS for f in FAULTS[c]])
def test_fault_is_caught(cell, fault):
    with faults.plant(fault):
        result = run_tiny(cell)
    assert not result["correct"], _numbers(result)


@pytest.mark.parametrize("cell", ["ganmf-ml20m.eval", "ganmf-ml1m.serve"])
def test_control_fails(cell):
    result = run_tiny(cell, control=True)
    assert not result["correct"], _numbers(result)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["ganmf-ml20m.train"])
def test_training_control_fails_on_the_card(cell, cuda_device):
    result = harness.run_cell(Registry(), cell, SEED, 0.3, False, cuda_device, time.perf_counter(),
                              control=True, overrides=tiny_overrides(cell))
    assert not result["correct"], _numbers(result)


def test_unchanged_state_reads_one():
    with faults.plant("unchanged"):
        result = run_tiny("ganmf-ml20m.train")
    assert math.isclose(_numbers(result)["change_gap"], 1.0)
    assert math.isclose(_numbers(result)["window_change_gap"], 1.0)


#: a fault of each cell that can set in once the checked and warm-up work is done
LATE = {"ganmf-ml20m.train": "half_batch", "ganmf-ml20m.eval": "altered", "ganmf-ml1m.serve": "altered"}


@pytest.mark.parametrize("cell", CELLS)
def test_fault_from_the_window_on_is_caught(cell, monkeypatch):
    stack = contextlib.ExitStack()
    setup_done = harness.Run.setup_done

    def late(self):
        setup_done(self)
        stack.enter_context(faults.plant(LATE[cell]))

    monkeypatch.setattr(harness.Run, "setup_done", late)
    with stack:
        result = run_tiny(cell)
    assert not result["correct"], _numbers(result)
    window = {k: v for k, v in _numbers(result).items() if k.startswith("window_") or k == "list_gap"}
    limits = result["check"]
    assert any(v > limits[k]["limit"] for k, v in window.items()), window


def test_one_altered_list_an_evaluation_is_caught(monkeypatch):
    """One user's list altered in each evaluation moves the mean metrics by
    little; the sampled lists catch it."""
    from ganmf_tpu_torch.eval import evaluator

    topk = evaluator.masked_topk_scores

    def one_row(U, V, mask, k, *args, **kwargs):
        vals, ids = topk(U, V, mask, k, *args, **kwargs)
        ids = ids.clone()
        ids[0, 0] = (ids[0, 0] + 1) % V.shape[0]
        return vals, ids

    monkeypatch.setattr(evaluator, "masked_topk_scores", one_row)
    every_list = {"config": TINY["config"], "traffic": dict(TINY["traffic"], list_stride=1)}
    result = harness.run_cell(Registry(), "ganmf-ml20m.eval", SEED, 0.3, False, torch.device("cpu"),
                              time.perf_counter(), overrides=every_list)
    assert not result["correct"]
    assert result["check"]["list_gap"]["value"] > result["check"]["list_gap"]["limit"]


def test_sampled_places_cover_every_user():
    from benchmark.drivers.evaluations import ListRecorder

    class Evaluator:
        def _fused_block(self, *args):
            return args

    rec = ListRecorder(Evaluator(), 100, 3, 32, 1, 5, torch.device("cpu"))
    assert {rec.phase(j) for j in range(32)} == set(range(32))


def test_traced_run_prints_per_layer_metrics():
    result = run_tiny("ganmf-ml1m.serve", trace=True)
    assert result["correct"]
    assert {"serve.mfu", "serve.device_idle"} <= set(result["metrics"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert result["device"]["window_s"] > 0

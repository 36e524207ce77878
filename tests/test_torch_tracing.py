"""The port's spans and counters (ganmf_tpu_torch/utils/profiling.py).

The recorder off and on, nesting and root ids, the clock the profiler's
events use, the spans in a Chrome trace, and the spans and host-sync counts
of the paths the benchmark times: a GANMF (and DisGANMF) epoch, a CFGAN
epoch in both storages, a holdout evaluation and ``recommend``, on the CPU
at small sizes.
"""

import contextlib
import json
from collections import Counter

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from ganmf_tpu_torch.eval import EvaluatorHoldout
from ganmf_tpu_torch.models import CFGAN, GANMF
from ganmf_tpu_torch.models.disganmf import DisGANMF
from ganmf_tpu_torch.utils import profiling

torch.set_num_threads(1)
CPU = torch.device("cpu")
N_USERS, N_ITEMS, BATCH = 40, 30, 16


@pytest.fixture(scope="module")
def split():
    rng = np.random.RandomState(7)
    dense = (rng.rand(N_USERS, N_ITEMS) < 0.3).astype(np.float32)
    test = dense * (rng.rand(N_USERS, N_ITEMS) < 0.3)
    return sps.csr_matrix(dense - test), sps.csr_matrix(test)


def _syncs(changed):
    """The host-sync counts among a drain's counter changes, by site."""
    return {k[len("host_sync."):]: v for k, v in changed.items() if k.startswith("host_sync.")}


def _children(spans, i):
    return [s.name for s in spans if s.parent == i]


def test_off_is_one_shared_noop_and_counters_count():
    assert profiling.span("a") is profiling.span("b")
    before = profiling.counters()
    with profiling.span("a"):
        profiling.count("test.things", 3)
    with profiling.root("test.layer"):
        pass
    after = profiling.counters()
    assert after["test.things"] - before.get("test.things", 0) == 3
    assert after["test.layer.calls"] - before.get("test.layer.calls", 0) == 1
    with profiling.recording():
        pass
    assert profiling.drain() == ([], {})


def test_nesting_parents_and_roots():
    with profiling.recording():
        with profiling.root("r"):
            with profiling.span("a"):
                with profiling.span("b"):
                    pass
            with profiling.span("c"):
                profiling.count("test.inside", 2)
        with profiling.span("r2"):
            pass
    spans, changed = profiling.drain()
    assert [s.name for s in spans] == ["r", "a", "b", "c", "r2"]
    assert [s.parent for s in spans] == [-1, 0, 1, 0, -1]
    assert [s.root for s in spans] == [0, 0, 0, 0, 4]
    assert all(s.start_ns <= s.end_ns for s in spans)
    assert spans[0].start_ns <= spans[1].start_ns <= spans[2].end_ns <= spans[1].end_ns <= spans[3].start_ns
    assert spans[3].end_ns <= spans[0].end_ns <= spans[4].start_ns
    assert changed == {"r.calls": 1, "test.inside": 2}
    assert profiling.drain() == ([], {})


def test_recording_does_not_nest_and_drains_after():
    with profiling.recording():
        with pytest.raises(RuntimeError):
            with profiling.recording():
                pass
        with pytest.raises(RuntimeError):
            profiling.drain()
    profiling.drain()


def test_counters_copy_and_reset():
    profiling.count("test.copy")
    snap = profiling.counters()
    snap["test.copy"] = -1
    assert profiling.counters()["test.copy"] >= 1
    saved = profiling.counters()
    profiling.reset_counters()
    assert profiling.counters() == {}
    for k, v in saved.items():
        profiling.count(k, v)


def test_span_shares_the_profilers_clock():
    """A span around a CPU operation contains that operation's event in a
    profile taken at the same time."""
    x = torch.randn(256, 256)
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    with profiling.recording():
        with profiling.span("around"):
            y = x @ x
    prof.stop()
    spans, _ = profiling.drain()
    (s,) = spans
    mm = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert mm and y.shape == (256, 256)
    assert s.start_ns <= mm[0].start_ns() and mm[0].end_ns() <= s.end_ns


def test_device_trace_holds_the_spans(tmp_path):
    with profiling.device_trace(str(tmp_path)):
        with profiling.span("outer.part"):
            with profiling.span("inner.part"):
                torch.ones(64).sum()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    by_name = {e["name"]: e for e in events if e.get("name") in ("outer.part", "inner.part")}
    outer, inner = by_name["outer.part"], by_name["inner.part"]
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert profiling.span("x") is profiling.span("y")  # off again


@pytest.mark.parametrize("kind,storage", [("GANMF", "dense"), ("GANMF", "csr"), ("DisGANMF", "dense")])
def test_training_spans_and_syncs(split, kind, storage):
    train, _ = split
    epochs = 2
    n_batches = -(-N_USERS // BATCH)
    if kind == "GANMF":
        model = GANMF(train, seed=3, is_experiment=True, device=CPU)
        fit = dict(num_factors=4, emb_dim=8)
    else:
        model = DisGANMF(train, seed=3, is_experiment=True, device=CPU)
        fit = dict(num_factors=4, d_nodes=8)
    with profiling.recording():
        model.fit(**fit, epochs=epochs, batch_size=BATCH, urm_storage=storage)
    spans, changed = profiling.drain()
    roots = [i for i, s in enumerate(spans) if s.parent == -1]
    assert [spans[i].name for i in roots] == ["train.epoch"] * epochs
    assert changed["train.epoch.calls"] == epochs
    for i in roots:
        steps = _children(spans, i)
        assert steps == ["train.shuffle"] + ["train.d_step"] * n_batches + ["train.g_step"] * n_batches
    for i, s in enumerate(spans):
        if s.name in ("train.d_step", "train.g_step"):
            assert _children(spans, i) == ["train.rows", "train.grad", "train.update"]
    assert _syncs(changed) == {"train.shuffle": epochs}


CFGAN_FIT = dict(d_nodes=4, g_nodes=8, d_layers=2, g_hidden_act="tanh", scheme="ZR", zr_ratio=0.45,
                 zr_coefficient=0.05, d_batch_size=8, g_batch_size=BATCH)


@pytest.mark.parametrize("storage", ["dense", "csr"])
def test_cfgan_spans_and_counts(split, storage):
    """Each minibatch a step span with its parts, the csr storage's masks
    drawn in each minibatch, the dense storage's once an epoch; every
    minibatch counted; no host sync."""
    train, _ = split
    epochs, d_n, g_n = 2, -(-N_USERS // 8), -(-N_USERS // BATCH)
    model = CFGAN(train, seed=3, is_experiment=True, device=CPU)
    with profiling.recording():
        model.fit(**CFGAN_FIT, epochs=epochs, urm_storage=storage)
    spans, changed = profiling.drain()
    roots = [i for i, s in enumerate(spans) if s.parent == -1]
    assert [spans[i].name for i in roots] == ["train.epoch"] * epochs
    first = ["train.masks"] if storage == "dense" else []
    parts = ["train.rows", "train.masks", "train.grad", "train.update"] if storage == "csr" else \
        ["train.rows", "train.grad", "train.update"]
    for i in roots:
        assert _children(spans, i) == first + ["train.d_step"] * d_n + ["train.g_step"] * g_n
    for i, s in enumerate(spans):
        if s.name in ("train.d_step", "train.g_step"):
            assert _children(spans, i) == parts
    assert changed["cfgan.minibatches"] == epochs * (d_n + g_n)
    assert changed["train.epoch.calls"] == epochs
    assert _syncs(changed) == {}


@pytest.mark.parametrize("storage", ["dense", "csr"])
def test_cfgan_spans_leave_results_unchanged(split, storage):
    """A CFGAN fit with the recorder on gives the same bits as with it off."""
    train, _ = split
    out = []
    for on in (False, True):
        model = CFGAN(train, seed=5, is_experiment=True, device=CPU)
        with profiling.recording() if on else contextlib.nullcontext():
            model.fit(**CFGAN_FIT, epochs=2, urm_storage=storage)
        profiling.drain()
        out.append([p.detach().clone() for p in model.params.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*out))


def _evaluator(test, block_rows):
    ev = EvaluatorHoldout(test, [2, 5], device=CPU)
    ev.block_rows = lambda: block_rows
    return ev


def _loaded_ganmf(train):
    model = GANMF(train, seed=3, is_experiment=True, device=CPU)
    model.fit(num_factors=4, emb_dim=8, epochs=1, batch_size=BATCH)
    return model


@pytest.mark.parametrize("block_rows", [8, 64])
def test_evaluation_spans_and_syncs(split, block_rows):
    train, test = split
    model = _loaded_ganmf(train)
    ev = _evaluator(test, block_rows)
    n_blocks = -(-len(ev.usersToEvaluate) // block_rows)
    want, _ = ev.evaluateRecommender(model)  # builds the block plan: its uploads
    with profiling.recording():
        got, _ = ev.evaluateRecommender(model)
        ev.evaluateRecommender(model)
    spans, changed = profiling.drain()
    assert got == want
    roots = [i for i, s in enumerate(spans) if s.parent == -1]
    assert [spans[i].name for i in roots] == ["eval.evaluate"] * 2
    for i in roots:
        assert _children(spans, i) == ["eval.order"] + ["eval.block"] * n_blocks + ["eval.finalize"]
    blocks = [i for i, s in enumerate(spans) if s.name == "eval.block"]
    assert all(_children(spans, i) == ["eval.prep", "eval.rank", "eval.metrics"] for i in blocks)
    assert changed["eval.evaluate.calls"] == 2
    assert changed["eval.blocks.cpu"] == 2 * n_blocks and "k3.launches" not in changed
    # the plan kept from the first evaluation: no upload, only the two reads back
    assert changed["eval.plan.hits"] == 2 and "eval.plan.builds" not in changed
    assert _syncs(changed) == {"eval.sums": 2, "eval.diversity": 2}


def test_recommend_spans_and_syncs(split):
    train, _ = split
    model = _loaded_ganmf(train)
    model.recommend(0, cutoff=5)
    calls = [3, [1, 2, 5], 7]
    with profiling.recording():
        lists = [model.recommend(u, cutoff=5) for u in calls]
    spans, changed = profiling.drain()
    assert len(lists[1]) == 3
    roots = [i for i, s in enumerate(spans) if s.parent == -1]
    assert [spans[i].name for i in roots] == ["serve.recommend"] * len(calls)
    for i in roots:
        assert _children(spans, i) == ["serve.ids", "serve.mask", "serve.rank", "serve.readback", "serve.lists"]
    assert Counter(s.name for s in spans) == Counter(
        {n: len(calls) for n in ("serve.recommend", "serve.ids", "serve.mask", "serve.rank", "serve.readback",
                                 "serve.lists")})
    assert changed["serve.recommend.calls"] == len(calls)
    assert _syncs(changed) == {"serve.ids": 3, "serve.vals": 3, "serve.top_ids": 3}


def test_spans_leave_results_unchanged(split):
    """A fit and its lists with the recorder on equal those with it off."""
    train, _ = split
    lists = []
    for on in (False, True):
        model = GANMF(train, seed=5, is_experiment=True, device=CPU)
        with profiling.recording() if on else contextlib.nullcontext():
            model.fit(num_factors=4, emb_dim=8, epochs=2, batch_size=BATCH, urm_storage="csr")
            lists.append(model.recommend(np.arange(N_USERS), cutoff=5))
        profiling.drain()
    assert lists[0] == lists[1]

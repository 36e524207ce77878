"""Serving latency (ganmf_tpu_torch/cli/serving_latency.py, the counterpart
of scripts/serving_latency.py), on the CPU.

- the ML-1M-shaped split is bench.py's fallback split, bitwise, and the
  LastFM-shaped one has LastFM's shape and density;
- on the ML-1M-shaped split, for each family at the JAX script's settings
  (a few calls a row), the timed calls' users are the JAX script's draws
  from ``RandomState(0)`` and their lists equal ``recommend``'s on the same
  users; a list that differs between the timed and the untimed call raises;
- the rows carry the JAX script's PERF row names, in its order, and its
  notes (their numbers aside), with p50 <= p99;
- ``main`` writes every family's rows for a dataset and refuses a dataset
  whose split the repository does not hold.
"""

import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ganmf_tpu.models import PureSVDRecommender as JaxPureSVD
from ganmf_tpu_torch.cli import serving_latency as sl

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))
import serving_latency as jax_latency  # noqa: E402  (the JAX script; imports JAX only inside main)

torch.set_num_threads(1)
CPU = torch.device("cpu")
N_SINGLE, N_BATCH = 6, 3


@pytest.fixture(scope="module")
def ml1m():
    return sl.SPLITS["1M"]()


@pytest.fixture(scope="module")
def fitted(ml1m):
    train, _ = ml1m
    return {family: sl.fit_family(family, train, CPU) for family in sl.FAMILIES}


@pytest.fixture
def few_calls(monkeypatch):
    monkeypatch.setattr(sl, "N_SINGLE", N_SINGLE)
    monkeypatch.setattr(sl, "N_BATCH", N_BATCH)
    monkeypatch.setattr(jax_latency, "N_SINGLE", N_SINGLE)
    monkeypatch.setattr(jax_latency, "N_BATCH", N_BATCH)


def test_ml1m_split_is_bench_pys(monkeypatch):
    """The ML-1M-shaped split is bench.py's fallback (bench.py:49-66), bitwise."""
    import bench
    import ganmf_tpu.data

    def absent(name):
        raise FileNotFoundError(name)

    monkeypatch.setattr(ganmf_tpu.data, "load_reference_splits", absent)
    for got, want in zip(sl.SPLITS["1M"](), bench._load_ml1m()):
        assert got.shape == want.shape == (6040, 3706) and got.dtype == want.dtype
        for part in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(got, part), getattr(want, part))


def test_lastfm_split_has_lastfms_shape():
    train, test = sl.SPLITS["LastFM"]()
    assert train.shape == test.shape == (1884, 17632)
    density = (train.nnz + test.nnz) / (1884 * 17632)
    assert abs(density - 0.00279) < 1e-4 and 0.78 < train.nnz / (train.nnz + test.nnz) < 0.82
    assert train.multiply(test).nnz == 0


@pytest.mark.parametrize("family", sl.FAMILIES)
def test_timed_lists_are_recommends(family, fitted, ml1m, few_calls, monkeypatch):
    model, n_users = fitted[family], ml1m[0].shape[0]
    seen = []
    timed = sl._timed_calls

    def spy(m, draws):
        out = timed(m, draws)
        seen.append((draws, out[1]))
        return out

    monkeypatch.setattr(sl, "_timed_calls", spy)
    rows = sl.measure(model, family, "1M", n_users, CPU, "cpu", log=lambda line: None)
    rng = np.random.RandomState(0)  # the JAX script's draws: a warm-up of each shape first
    rng.randint(n_users), rng.randint(0, n_users, size=sl.BATCH)
    singles = [int(rng.randint(n_users)) for _ in range(N_SINGLE)]
    batches = [rng.randint(0, n_users, size=sl.BATCH) for _ in range(N_BATCH)]
    assert seen[0][0] == singles
    assert all(np.array_equal(a, b) for a, b in zip(seen[1][0], batches)) and len(seen[1][0]) == N_BATCH
    for draws, lists in seen:
        for users, got in zip(draws, lists):
            want = model.recommend(users, cutoff=20, remove_seen_flag=True)
            assert got == want
            assert all(len(one) == 20 for one in (want if np.ndim(users) else [want]))
    assert [r["n"] for r in rows] == [N_SINGLE, N_BATCH]
    assert rows[0]["route"] == ("dense" if family == "ItemKNN" else "K1 fused")
    assert all(r["lists_equal_untimed"] and 0 < r["p50_ms"] <= r["p99_ms"] for r in rows)


def test_a_changed_list_raises(fitted, ml1m, few_calls, monkeypatch):
    model = fitted["MF"]
    calls = {"n": 0}
    recommend = type(model).recommend

    def drifting(self, users, **kw):
        calls["n"] += 1
        out = recommend(self, users, **kw)
        return out[::-1] if calls["n"] == 2 + N_SINGLE + 1 else out  # the first untimed call

    monkeypatch.setattr(type(model), "recommend", drifting)
    with pytest.raises(RuntimeError, match="untimed recommend's lists differ"):
        sl.measure(model, "MF", "1M", ml1m[0].shape[0], CPU, "cpu", log=lambda line: None)


def _masked(text):
    return re.sub(r"[0-9][0-9,.]*", "#", text)


def test_rows_are_the_jax_scripts(fitted, few_calls, monkeypatch):
    small = sl.SPLITS["1M"]()[0][:300, :200].tocsr()
    jm = JaxPureSVD(small)
    jm.fit(num_factors=20)
    recorded = []
    monkeypatch.setattr(jax_latency, "_record", lambda name, seconds, note="": recorded.append((name, seconds, note)))
    jax_latency.measure(jm, "MF", "1M", small.shape[0])
    rows = sl.measure(fitted["MF"], "MF", "1M", 6040, CPU, "cpu", log=lambda line: None)
    assert [r["name"] for r in rows] == [name for name, _, _ in recorded] == [
        "Latency[1M] MF recommend b=1", "Latency[1M] MF recommend b=32"]
    assert [_masked(r["note"]) for r in rows] == [_masked(note) for _, _, note in recorded]
    for r in rows:
        assert r["seconds"] == pytest.approx(r["p50_ms"] / 1e3) and r["card"] == "cpu"
    assert rows[1]["users_per_s_at_p50"] == pytest.approx(sl.BATCH / rows[1]["seconds"])


def test_main_writes_every_familys_rows(few_calls, tmp_path, capsys):
    out = tmp_path / "latency.json"
    assert sl.main(["1M", "--out", str(out)], device="cpu") == 0
    rows = json.loads(out.read_text())["rows"]
    assert [r["name"] for r in rows] == [f"Latency[1M] {f} recommend b={b}" for f in sl.FAMILIES for b in (1, 32)]
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert printed == rows
    with pytest.raises(SystemExit):
        sl.main(["hetrec2011", "--out", str(out)], device="cpu")

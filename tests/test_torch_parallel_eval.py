"""EvaluatorHoldout(mesh_plan=...) on gloo processes against JAX's sharded
evaluator, on the CPU.

One spawn of 4 ranks (tests/test_torch_parallel.py's ``spawn``) evaluates
every case below on a (data 2, model 2) mesh, and the factor route also on
(slice 2, data 1, model 2); the pytest process runs JAX's
``EvaluatorHoldout(mesh_plan=make_mesh(...))`` on the same models and
compares every metric at cutoffs [5, 20] within rel 1e-5 / abs 1e-7
(tests/test_parallel.py:83-100):

- the K1 route: GANMF with JAX's initial weights, in user and item mode
  (K1's plain version ranks each rank's item shard, ``merge_shard_topk``
  merges the shards' candidates; JAX ranks the dense scores with
  ``sharded_topk``);
- the dense route: a model of random scores without factors (JAX's
  ``_RandomScorer`` of tests/test_parallel.py);
- 81 items, which 2 model ranks do not divide: every model rank ranks every
  item, on both routes;
- ``diversity_object`` on both models;
- ``per_user_ap`` under the plan against the one-process evaluator's.
"""

import os
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_parallel import RANK_ENV, csr_arrays, csr_from, spawn, urm_split, worker_main  # noqa: E402

SEED = 42
K, E = 8, 16
CUTOFFS = [5, 20]
MESHES = {"2x2": dict(n_data=2, n_model=2), "s2x1x2": dict(n_data=1, n_model=2, n_slices=2)}
#: name: (mesh, items, model, mode, with a diversity object)
CASES_EVAL = {
    "k1_user": ("2x2", 80, "ganmf", "user", False),
    "k1_item": ("2x2", 80, "ganmf", "item", False),
    "k1_user_sliced": ("s2x1x2", 80, "ganmf", "user", False),
    "dense": ("2x2", 80, "random", "user", False),
    "k1_81_items": ("2x2", 81, "ganmf", "user", False),
    "dense_81_items": ("2x2", 81, "random", "user", False),
    "diversity_ganmf": ("2x2", 80, "ganmf", "user", True),
    "diversity_dense": ("2x2", 80, "random", "user", True),
}


def _split(n_items):
    return urm_split(50, n_items, seed=3 if n_items == 80 else 5)


def _scores(shape):
    return np.random.RandomState(0).randn(*shape).astype(np.float32)


def _diversity(n_items):
    M = np.random.RandomState(1).rand(n_items, n_items).astype(np.float32)
    return (M + M.T) / 2


# -- the rank's side ---------------------------------------------------------------

def _case_eval(inputs, workdir):
    from ganmf_tpu_torch.eval import EvaluatorHoldout
    from ganmf_tpu_torch.models import GANMF, Recommender
    from ganmf_tpu_torch.models.ganmf import params_from_jax
    from ganmf_tpu_torch.ops import scorer
    from ganmf_tpu_torch.parallel import make_mesh

    cpu = torch.device("cpu")

    class RandomScores(Recommender):
        def __init__(self, train, scores):
            super().__init__(train, device=cpu)
            self._scores = torch.from_numpy(scores)

        def score_device(self, user_ids):
            return self._scores.index_select(0, user_ids)

    plans = {name: make_mesh(**kw, device="cpu") for name, kw in MESHES.items()}
    counted = []
    real = scorer.masked_topk_scores
    scorer_calls = lambda U, V, M, k, id_offset=0: counted.append((V.shape[0], id_offset)) or real(  # noqa: E731
        U, V, M, k, id_offset)
    import ganmf_tpu_torch.eval.evaluator as ev_mod

    ev_mod.masked_topk_scores = scorer_calls
    out = {}
    for name, (mesh, n_items, kind, mode, diverse) in CASES_EVAL.items():
        train, test = csr_from(inputs, f"train{n_items}"), csr_from(inputs, f"test{n_items}")
        if kind == "ganmf":
            model = GANMF(train, mode=mode, seed=SEED, device=cpu)
            model.params = params_from_jax([inputs[f"{mode}{n_items}_p{i}"] for i in range(6)], cpu)
        else:
            model = RandomScores(train, inputs[f"scores{n_items}"])
        kw = dict(diversity_object=inputs[f"div{n_items}"]) if diverse else {}
        ev = EvaluatorHoldout(test, CUTOFFS, mesh_plan=plans[mesh], device=cpu, **kw)
        del counted[:]
        results, _ = ev.evaluateRecommender(model)
        out[f"{name}/keys"] = np.asarray(list(results[CUTOFFS[0]]))
        out[f"{name}/values"] = np.asarray([list(results[c].values()) for c in CUTOFFS], np.float64)
        out[f"{name}/k1"] = np.asarray(counted, np.int64).reshape(-1, 2)
        if name == "k1_user":
            users, ap = ev.per_user_ap(model, 20)
            single_users, single_ap = EvaluatorHoldout(test, CUTOFFS, device=cpu).per_user_ap(model, 20)
            out["ap/users"], out["ap/values"] = users, ap
            out["ap/single_users"], out["ap/single_values"] = single_users, single_ap
    return out


CASES = {"eval": _case_eval}

if __name__ == "__main__":
    worker_main(CASES)
elif not os.environ.get(RANK_ENV):
    # -- the pytest side ---------------------------------------------------------
    import jax
    import jax.numpy as jnp
    import pytest

    from ganmf_tpu.eval import EvaluatorHoldout as JaxEvaluatorHoldout
    from ganmf_tpu.models import GANMF as JaxGANMF
    from ganmf_tpu.models import ganmf as jgm
    from ganmf_tpu.parallel import make_mesh as jax_make_mesh

    class _JaxRandomScorer:
        """tests/test_parallel.py's minimal recommender, with given scores."""

        def __init__(self, train, scores):
            self._train = train
            self._scores = jnp.asarray(scores)
            self._mask = jnp.asarray(np.asarray(train.todense()) > 0)

        def get_URM_train(self):
            return self._train

        def score_device(self, uids):
            return jnp.take(self._scores, uids, axis=0)

        def device_train_mask(self):
            return self._mask

    def _init(mode, n_items):
        shape = (50, n_items) if mode == "user" else (n_items, 50)
        return [np.asarray(t) for t in jgm._init_params(jax.random.PRNGKey(SEED), *shape, K, E)]

    @pytest.fixture(scope="module")
    def runs(tmp_path_factory):
        inputs = {}
        for n_items in (80, 81):
            train, test = _split(n_items)
            inputs.update(csr_arrays(f"train{n_items}", train))
            inputs.update(csr_arrays(f"test{n_items}", test))
            inputs[f"scores{n_items}"] = _scores(train.shape)
            inputs[f"div{n_items}"] = _diversity(n_items)
            for mode in ("user", "item"):
                inputs.update({f"{mode}{n_items}_p{i}": a for i, a in enumerate(_init(mode, n_items))})
        return spawn("eval", inputs, tmp_path_factory.mktemp("eval"), script=Path(__file__))

    def _jax_results(name):
        mesh, n_items, kind, mode, diverse = CASES_EVAL[name]
        train, test = _split(n_items)
        if kind == "ganmf":
            model = JaxGANMF(train, mode=mode, seed=SEED)
            model.params = jgm.GANMFParams(*[jnp.asarray(a) for a in _init(mode, n_items)])
        else:
            model = _JaxRandomScorer(train, _scores(train.shape))
        kw = dict(diversity_object=_diversity(n_items)) if diverse else {}
        ev = JaxEvaluatorHoldout(test, CUTOFFS, mesh_plan=jax_make_mesh(**MESHES[mesh]), **kw)
        return ev.evaluateRecommender(model)[0]

    @pytest.mark.parametrize("name", list(CASES_EVAL))
    def test_mesh_evaluator_matches_jax_mesh_evaluator(runs, name):
        want = _jax_results(name)
        for res in runs:  # every rank finalizes the same reduced sums
            assert res[f"{name}/keys"].tolist() == list(want[CUTOFFS[0]])
            for ci, c in enumerate(CUTOFFS):
                for metric, value, got in zip(want[c], want[c].values(), res[f"{name}/values"][ci]):
                    assert got == pytest.approx(value, rel=1e-5, abs=1e-7, nan_ok=True), (c, metric)

    @pytest.mark.parametrize("name", list(CASES_EVAL))
    def test_each_case_takes_its_route(runs, name):
        """K1 ranks each rank's item shard (40 items at offsets 0 and 40)
        where the items divide, every item where they do not, and never on
        the dense route or with a diversity object."""
        mesh, n_items, kind, mode, diverse = CASES_EVAL[name]
        for rank, res in enumerate(runs):
            calls = res[f"{name}/k1"]
            if kind != "ganmf" or diverse:
                assert len(calls) == 0
                continue
            assert len(calls) > 0
            width, offset = (40, 40 * (rank % 2)) if n_items == 80 else (81, 0)
            assert calls.tolist() == [[width, offset]] * len(calls)

    def test_per_user_ap_under_the_plan(runs):
        for res in runs:
            np.testing.assert_array_equal(res["ap/users"], res["ap/single_users"])
            np.testing.assert_allclose(res["ap/values"], res["ap/single_values"], rtol=1e-6, atol=1e-9)

"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA device and skips without one. The file imports
no JAX, so it also runs on a machine without it (where tests/conftest.py,
which imports jax, is skipped):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: K1 values within rtol 1e-5 / atol 1e-6 of the plain version's
(float32 products summed in another order than cuBLAS); ids equal at every
finite slot (the inputs leave no near-ties; exact ties go to the lowest id).
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from ganmf_tpu_torch.eval import EvaluatorHoldout
from ganmf_tpu_torch.models import GANMF, init_params
from ganmf_tpu_torch.ops import scorer
from ganmf_tpu_torch.ops.scorer import masked_topk_scores, masked_topk_scores_reference

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _inputs(case, B, I, K, seed=0):
    rng = np.random.RandomState(seed)
    if case == "ties":
        # duplicated item rows on a grid of eighths: every dot product is
        # exact in float32, so duplicates tie bitwise in any summation order
        U = rng.randint(-4, 5, (B, K)).astype(np.float32) / 8
        base = rng.randint(-4, 5, (max(I // 4, 1), K)).astype(np.float32) / 8
        V = base[rng.randint(0, len(base), I)]
    else:
        U = rng.randn(B, K).astype(np.float32)
        V = rng.randn(I, K).astype(np.float32)
    mask = rng.rand(B, I) < 0.2
    if case == "masked_rows":
        mask[1] = True  # fully masked
        mask[6] = True
        mask[6, ::9] = False  # fewer unmasked items than k when I < 9k
    return U, V, mask


@pytest.mark.parametrize("case", ["random", "ties", "masked_rows"])
@pytest.mark.parametrize("I,k", [(3706, 50), (1001, 20), (96, 5), (257, 64)])
def test_kernel_matches_plain(cuda, I, k, case):
    U, V, mask = (torch.from_numpy(a).to(cuda) for a in _inputs(case, 37, I, 64))
    before = scorer.LAUNCHES
    vals, ids = masked_topk_scores(U, V, mask, k)
    assert scorer.LAUNCHES == before + 1
    ref_vals, ref_ids = masked_topk_scores_reference(U, V, mask, k)
    vals, ids = vals.cpu().numpy(), ids.cpu().numpy()
    ref_vals, ref_ids = ref_vals.cpu().numpy(), ref_ids.cpu().numpy()
    fin = np.isfinite(ref_vals)
    np.testing.assert_array_equal(np.isfinite(vals), fin)
    np.testing.assert_allclose(vals[fin], ref_vals[fin], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ids[fin], ref_ids[fin])
    assert ids.min() >= 0 and ids.max() < I  # -inf tails hold real items


def test_kernel_rejects_what_it_does_not_take(cuda):
    U, V, mask = (torch.from_numpy(a).to(cuda) for a in _inputs("random", 4, 100, 8))
    with pytest.raises(ValueError):
        masked_topk_scores(U, V, mask, scorer.MAX_K + 1)
    with pytest.raises(ValueError):
        masked_topk_scores(U, V.T.contiguous().T, mask, 5)  # not contiguous
    with pytest.raises(ValueError):
        masked_topk_scores(U, V.cpu(), mask, 5)  # devices differ


def test_slice_on_card_matches_plain_cpu_path(cuda):
    """GANMF's recommend, serve_all and evaluation on the card (through K1)
    against the same weights on the CPU (plain version), in both modes."""
    rng = np.random.RandomState(0)
    full = (rng.rand(300, 500) < 0.05).astype(np.float32)
    held = rng.rand(300, 500) < 0.2
    train, test = sps.csr_matrix(full * ~held), sps.csr_matrix(full * held)
    cpu = torch.device("cpu")
    for mode in ("user", "item"):
        card = GANMF(train, mode=mode, device=cuda)
        n_rows, n_cols = card._train_matrix().shape
        card.params = init_params(n_rows, n_cols, 16, 32, torch.Generator().manual_seed(3), cuda)
        plain = GANMF(train, mode=mode, device=cpu)
        plain.params = init_params(n_rows, n_cols, 16, 32, torch.Generator().manual_seed(3), cpu)

        before = scorer.LAUNCHES
        users = np.arange(20)
        assert card.recommend(users, cutoff=10) == plain.recommend(users, cutoff=10)
        idx, vals = card.serve_all(cutoff=20, block=128)
        pidx, pvals = plain.serve_all(cutoff=20, block=128)
        np.testing.assert_array_equal(idx, pidx)
        np.testing.assert_allclose(vals, pvals, rtol=1e-5, atol=1e-6)
        got, _ = EvaluatorHoldout(test, [5, 10, 20, 50], device=cuda).evaluateRecommender(card)
        want, _ = EvaluatorHoldout(test, [5, 10, 20, 50], device=cpu).evaluateRecommender(plain)
        assert scorer.LAUNCHES >= before + 1 + 3 + 1  # recommend, 3 serve blocks, eval
        for c in want:
            for metric, value in want[c].items():
                assert got[c][metric] == pytest.approx(value, abs=1e-5), (mode, c, metric)

"""K1, the fused masked top-k scorer: the port against the JAX kernel.

On CPU tensors the port's ``masked_topk_scores`` takes its plain version
(matmul, masked_fill, stable top-k); it is held against the JAX Pallas
kernel run in interpret mode, as tests/test_pallas_scorer.py runs it.

Tolerances: finite values within rtol 1e-5 / atol 1e-6 (float32 dot
products summed in another order); ids equal at every finite slot (the
inputs leave no near-ties, and exact ties must go to the lowest id). The
CUDA kernel is held against the plain version on the card in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ganmf_tpu.ops.pallas_scorer import masked_topk_scores as jax_masked_topk_scores
from ganmf_tpu_torch.ops.scorer import masked_topk_scores
from ganmf_tpu_torch.ops.topk import topk_lowest_index
from ganmf_tpu_torch.utils import profiling

torch.set_num_threads(1)


def _counter(name: str) -> int:
    """A counter of the port (ganmf_tpu_torch/utils/profiling.py)."""
    return profiling.counters().get(name, 0)


def _inputs(case, B, I, K, seed=0):
    rng = np.random.RandomState(seed)
    if case == "ties":
        # duplicated item rows on a grid of eighths: every dot product is
        # exact in float32, so duplicates tie bitwise in any summation order
        U = rng.randint(-4, 5, (B, K)).astype(np.float32) / 8
        base = rng.randint(-4, 5, (I // 4, K)).astype(np.float32) / 8
        V = base[rng.randint(0, len(base), I)]
    else:
        U = rng.randn(B, K).astype(np.float32)
        V = rng.randn(I, K).astype(np.float32)
    mask = rng.rand(B, I) < 0.2
    if case == "masked_rows":
        mask[1] = True  # fully masked
        mask[5] = True
        mask[6] = True
        mask[6, ::9] = False  # fewer unmasked items than k=50
    return U, V, mask


def _assert_topk_equal(vals, ids, ref_vals, ref_ids):
    fin = np.isfinite(ref_vals)
    np.testing.assert_array_equal(np.isfinite(vals), fin)
    np.testing.assert_allclose(vals[fin], ref_vals[fin], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ids[fin], ref_ids[fin])


@pytest.mark.parametrize("case", ["random", "ties", "masked_rows"])
@pytest.mark.parametrize("k", [5, 50])
@pytest.mark.parametrize("I", [64, 96])  # 96 is not a multiple of the tile: padding
def test_masked_topk_matches_jax_kernel(I, k, case):
    B, K = 8, 16
    U, V, mask = _inputs(case, B, I, K)
    jv, ji = jax_masked_topk_scores(
        jnp.asarray(U), jnp.asarray(V), jnp.asarray(mask.astype(np.int8)), k=k, tile=32, interpret=True
    )
    before = _counter("k1.launches")
    vals, ids = masked_topk_scores(torch.from_numpy(U), torch.from_numpy(V), torch.from_numpy(mask), k)
    assert _counter("k1.launches") == before  # CPU tensors never reach the kernel
    assert vals.dtype == torch.float32 and ids.dtype == torch.int64
    assert tuple(vals.shape) == (B, k) and tuple(ids.shape) == (B, k)
    _assert_topk_equal(vals.numpy(), ids.numpy(), np.asarray(jv), np.asarray(ji))
    # masked items never rank, and -inf tails keep ids inside the catalog
    assert not np.take_along_axis(mask, ids.numpy(), axis=1)[np.isfinite(vals.numpy())].any()
    assert ids.min() >= 0 and ids.max() < I


def test_topk_lowest_index_breaks_ties_by_index():
    x = torch.tensor([[1.0, 3.0, 3.0, float("-inf"), 3.0, 2.0, float("-inf")]])
    vals, idx = topk_lowest_index(x, 6)
    assert idx.tolist() == [[1, 2, 4, 5, 0, 3]]
    assert vals[0, :5].tolist() == [3.0, 3.0, 3.0, 2.0, 1.0]


def test_wrapper_rejects_what_the_kernel_does_not_take():
    U, V, mask = (torch.from_numpy(a) for a in _inputs("random", 4, 20, 8))
    with pytest.raises(ValueError):
        masked_topk_scores(U, V[:, :5], mask, 3)  # factor widths differ
    with pytest.raises(ValueError):
        masked_topk_scores(U, V, mask[:, :10], 3)  # mask shape
    with pytest.raises(TypeError):
        masked_topk_scores(U.double(), V, mask, 3)
    with pytest.raises(TypeError):
        masked_topk_scores(U, V, mask.to(torch.uint8), 3)
    with pytest.raises(ValueError):
        masked_topk_scores(U, V, mask, 21)  # k > I
    # a device that is neither CPU nor CUDA raises instead of falling back
    meta = [t.to("meta") for t in (U, V, mask)]
    with pytest.raises(ValueError):
        masked_topk_scores(*meta, 3)

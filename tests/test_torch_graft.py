"""The port's graft entry points (ganmf_tpu_torch/graft.py) against
__graft_entry__.py, on the CPU.

- ``entry``'s fn on JAX's parameters (through ``params_from_jax``) and JAX's
  inputs: both losses within rtol 1e-5 of JAX's ``entry`` fn; on its own
  example arguments, finite float32 scalars;
- ``dryrun_multichip(4, device="cpu")``: four gloo ranks run the dry run on
  the (data 2, model 2) plan and on (slice 2, data 1, model 2);
- without a card, ``entry()`` and ``dryrun_multichip(4)`` raise rather than
  fall back to the CPU; ranks past the timeout are killed and the call
  raises with their logs.
"""

import numpy as np
import pytest
import torch

import __graft_entry__ as jax_graft
from ganmf_tpu_torch import graft
from ganmf_tpu_torch.models.ganmf import params_from_jax

CPU = torch.device("cpu")


def test_entry_losses_match_jax():
    jfn, jargs = jax_graft.entry()
    want = [float(x) for x in jfn(*jargs)]
    fn, args = graft.entry(device=CPU)
    params = params_from_jax([np.asarray(p) for p in jargs[0]], CPU)
    uids, real, w = (torch.from_numpy(np.array(a)) for a in jargs[1:])
    got = [float(x) for x in fn(params, uids.long(), real, w)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert [tuple(t.shape) for t in args[0].parameters()] == [tuple(np.shape(p)) for p in jargs[0]]
    assert [tuple(a.shape) for a in args[1:]] == [tuple(np.shape(a)) for a in jargs[1:]]


def test_entry_runs_on_its_own_arguments():
    fn, args = graft.entry(device=CPU)
    out = fn(*args)
    assert len(out) == 2 and all(x.dtype == torch.float32 and x.dim() == 0 and torch.isfinite(x) for x in out)
    real = args[2]
    assert set(real.unique().tolist()) <= {0.0, 1.0} and 0.1 < float(real.mean()) < 0.3


def test_dryrun_multichip_on_cpu_ranks():
    graft.dryrun_multichip(4, device="cpu")


def test_without_a_card_the_entry_points_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        graft.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft.dryrun_multichip(4)


def test_a_rank_past_the_timeout_raises_with_its_log(monkeypatch):
    """Ranks still running at the timeout are killed, and the call raises
    RuntimeError with each failed rank's output (JAX __graft_entry__.py:149-153)."""
    monkeypatch.setattr(graft, "DRYRUN_TIMEOUT", 0.01)
    with pytest.raises(RuntimeError, match=r"failed on 2 of 2 ranks \(cpu\)\n--- rank 0 \(rc=-9\)"):
        graft.dryrun_multichip(2, device="cpu")

"""CFGAN's csr epoch in the port against the benchmark's plain reference
(benchmark/reference/cfgan.py), on the CPU at a small size: 300 x 220, G
220 -> 32 (tanh) -> 220, D 440 -> 4 x5 (linear) -> 1, minibatches of 32
(D) and 64 (G) rows, each phase's last one padded, scheme ZR, from seeded
random weights.

Tolerances, each with its reason:
- every minibatch's loss within rtol 2e-6: float32 sums in another order
  (the port's BCE is PyTorch's, the reference's written out) read up to
  ~2.5e-7 here; TF32-rounded products read 3.8e-5 or more;
- every leaf after two epochs within 2e-5 of the distance the epochs moved
  it, and its first Adam moment within 2e-5 of the moment's norm (norms, so
  that an element whose gradient sits at rounding level and flips Adam's
  step sign counts by its size): 150 steps of float32 round-off read up to
  ~3e-6; TF32-rounded products read 2.5e-3 or more;
- the ZR masks and the keyed uniforms bitwise: the same keys and the same k
  through an exact selection, ties to the lowest column;
- the reference resumed from its own state bitwise its uninterrupted run
  (the same operations on the same tensors).
"""

import pytest
import torch

from benchmark.data import movielens_shaped
from benchmark.reference import cfgan as ref_cfgan
from benchmark.reference import round_tf32
from ganmf_tpu_torch.models import cfgan as pcf
from ganmf_tpu_torch.models.cfgan import CFGAN
from ganmf_tpu_torch.ops import keyed

torch.set_num_threads(1)
CPU = torch.device("cpu")
DATA = dict(n_users=300, n_items=220, n_ratings=12000, min_per_user=20, max_per_user=120, n_clusters=8,
            activity_lognormal=[4.0, 1.0], zipf_exponent=0.9, cluster_boost=60.0, test_share=0.2)
FIT = dict(g_nodes=32, g_layers=1, g_hidden_act="tanh", d_nodes=4, d_layers=5, d_hidden_act="linear", scheme="ZR",
           zr_ratio=0.4515475140394092, zr_coefficient=0.05049684341469494, d_batch_size=32, g_batch_size=64,
           d_lr=1e-3, g_lr=1e-3, d_reg=1e-4, g_reg=1e-4, d_steps=1, g_steps=1)
SEED = 11
LOSS_RTOL, LEAF_RTOL = 2e-6, 2e-5
# Random123's kat_vectors for philox4x32_10: (counter, key, result)
KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.fixture(scope="module")
def train():
    return movielens_shaped.generate(DATA, 4, CPU).train


def _fit_program(train, epochs, monkeypatch):
    """The port's fit over ``epochs``, its every minibatch's loss and its
    every ZR mask by G minibatch, in order."""
    losses, masks = ([], []), []
    d_loss, g_loss, negative_mask = pcf.d_loss, pcf.g_loss, pcf.negative_mask

    def tap(fn, out):
        def wrapped(*args, **kwargs):
            loss = fn(*args, **kwargs)
            out.append(float(loss.detach()))
            return loss
        return wrapped

    def mask_tap(block, u, ratio):
        mask = negative_mask(block, u, ratio)
        masks.append(mask != 0)
        return mask

    monkeypatch.setattr(pcf, "d_loss", tap(d_loss, losses[0]))
    monkeypatch.setattr(pcf, "g_loss", tap(g_loss, losses[1]))
    monkeypatch.setattr(pcf, "negative_mask", mask_tap)
    model = CFGAN(train, mode="user", seed=SEED, device=CPU, is_experiment=True)
    model.fit(**FIT, epochs=epochs, urm_storage="csr")
    monkeypatch.undo()
    return model, losses, masks


def _adam_state(model):
    state = dict(model._d_opt.state)
    state.update(model._g_opt.state)
    return {k: state[p] for k, p in model.params.named_parameters()}


def _gaps(model, losses, ref, init, ref_losses):
    """(the worst minibatch loss's relative gap, the worst leaf's gap over
    the distance it moved, the worst first moment's gap over its norm)."""
    rd = [x for d, _ in ref_losses for x in d]
    rg = [x for _, g in ref_losses for x in g]
    assert (len(losses[0]), len(losses[1])) == (len(rd), len(rg))
    loss = max(abs(p - r) / abs(r) for p, r in zip(losses[0] + losses[1], rd + rg))
    state = _adam_state(model)
    leaf = moment = 0.0
    for k, p in model.params.named_parameters():
        leaf = max(leaf, float((p.detach() - ref.params[k]).norm() / (ref.params[k] - init[k]).norm()))
        moment = max(moment, float((state[k]["exp_avg"] - ref.m[k]).norm() / ref.m[k].norm()))
    return loss, leaf, moment


@pytest.mark.parametrize("ctr,key,want", KAT)
def test_reference_philox_known_answers(ctr, key, want):
    got = ref_cfgan.philox([torch.tensor([c], dtype=torch.int64) for c in ctr], key)
    assert tuple(int(w) for w in got) == want


@pytest.mark.parametrize("seed,epoch,stream,n_cols", [(11, 1, 0, 220), ((5 << 32) | 17, 3, 1, 97),
                                                     ((1 << 31) + 12345, 9, 0, 26744)])
def test_reference_uniforms_are_the_ports_plain_version(seed, epoch, stream, n_cols):
    rows = torch.tensor([0, 1, 299, 64, 138492, 7])
    assert torch.equal(ref_cfgan.uniforms(seed, epoch, stream, rows, n_cols),
                       keyed.keyed_uniforms_reference(seed, epoch, stream, rows, n_cols))


def test_two_epochs_agree_and_masks_are_bitwise(train, monkeypatch):
    model, losses, masks = _fit_program(train, 2, monkeypatch)
    ref = ref_cfgan.Trainer(train, FIT, SEED, CPU)
    init = {k: v.clone() for k, v in ref.params.items()}
    g_n = -(-train.shape[0] // FIT["g_batch_size"])
    ref_losses, ref_masks = [], []
    for _ in range(2):
        ref_losses.append(ref.run_epoch(keep_masks=range(g_n)))
        ref_masks += [ref.kept_masks[i] for i in range(g_n)]
    assert len(masks) == len(ref_masks) == 2 * g_n
    for got, want in zip(masks, ref_masks):
        assert torch.equal(got, want)
    assert not torch.equal(masks[0], masks[g_n])  # each epoch draws anew
    loss, leaf, moment = _gaps(model, losses, ref, init, ref_losses)
    assert loss <= LOSS_RTOL and leaf <= LEAF_RTOL and moment <= LEAF_RTOL, (loss, leaf, moment)


def test_tf32_rounded_products_fail_the_tolerances(train, monkeypatch):
    """The reference with every product's operands rounded to TF32, as the
    cell's control runs the program, misses each tolerance."""
    model, losses, _ = _fit_program(train, 2, monkeypatch)

    def rounded(x):
        return x + (round_tf32(x.detach()) - x).detach()

    monkeypatch.setattr(ref_cfgan, "_matmul", lambda a, b: rounded(a) @ rounded(b))
    ref = ref_cfgan.Trainer(train, FIT, SEED, CPU)
    init = {k: v.clone() for k, v in ref.params.items()}
    ref_losses = [ref.run_epoch(), ref.run_epoch()]
    loss, leaf, moment = _gaps(model, losses, ref, init, ref_losses)
    assert loss > LOSS_RTOL and leaf > LEAF_RTOL and moment > LEAF_RTOL, (loss, leaf, moment)


def _state(params, m, v, t):
    out = {}
    for k in params:
        out[f"p.{k}"], out[f"m.{k}"], out[f"v.{k}"] = params[k].clone(), m[k].clone(), v[k].clone()
        out[f"t.{k}"] = torch.tensor(float(t[k]))
    return out


def test_resumed_epoch_equals_the_uninterrupted_one(train, monkeypatch):
    """The reference resumed after epoch 1 from its own state runs epoch 2
    bitwise as its uninterrupted run; resumed from the port's state after
    epoch 1, it meets the port's epoch 2 within the tolerances."""
    whole = ref_cfgan.Trainer(train, FIT, SEED, CPU)
    whole.run_epoch()
    after_one = _state(whole.params, whole.m, whole.v, whole.t)
    want = whole.run_epoch()
    resumed = ref_cfgan.Trainer(train, FIT, SEED, CPU)
    resumed.resume(after_one, 1)
    assert resumed.run_epoch() == want
    for k in whole.names:
        assert torch.equal(resumed.params[k], whole.params[k]) and torch.equal(resumed.m[k], whole.m[k])

    model, _, _ = _fit_program(train, 1, monkeypatch)
    state = _adam_state(model)
    prog_one = _state({k: p.detach() for k, p in model.params.named_parameters()},
                      {k: s["exp_avg"] for k, s in state.items()}, {k: s["exp_avg_sq"] for k, s in state.items()},
                      {k: int(s["step"]) for k, s in state.items()})
    model, losses, _ = _fit_program(train, 2, monkeypatch)
    from_prog = ref_cfgan.Trainer(train, FIT, SEED, CPU)
    from_prog.resume(prog_one, 1)
    ref_losses = [from_prog.run_epoch()]
    d_n = len(ref_losses[0][0])
    g_n = len(ref_losses[0][1])
    second = (losses[0][d_n:], losses[1][g_n:])
    loss, leaf, moment = _gaps(model, second, from_prog, {k: prog_one[f"p.{k}"] for k in whole.names}, ref_losses)
    assert loss <= LOSS_RTOL and leaf <= LEAF_RTOL and moment <= LEAF_RTOL, (loss, leaf, moment)

"""What the serving and evaluation drivers share: the data and a GANMF
model loaded with tensors made from the seed (no training)."""

from __future__ import annotations

from benchmark.data import ganmf_weights, movielens_shaped
from benchmark.harness import Run


def tensors(run: Run, data):
    cfg = run.cell.config
    U, I = data.train.shape
    return ganmf_weights.make(U, I, cfg["fit"]["num_factors"], cfg["fit"]["emb_dim"], data.user_cluster,
                              data.item_cluster, run.seed, run.device)


def loaded_model(run: Run):
    """(data, model): the cell's data, and GANMF on its training matrix with
    the seed's tensors handed over through the program's parameter module."""
    from ganmf_tpu_torch.models.ganmf import GANMF, GANMFParams

    cfg = run.cell.config
    if cfg["mode"] != "user":
        raise ValueError("the loaded model serves in user mode")
    data = movielens_shaped.generate(cfg["data"], run.seed, run.device)
    params = [t.clone() for t in tensors(run, data)]
    run.mark("data and tensors made")
    run.reset_peak()
    model = GANMF(data.train, mode="user", seed=run.model_seed, device=run.device, is_experiment=True)
    model.params = GANMFParams(*params)
    run.mark("model loaded")
    return data, model

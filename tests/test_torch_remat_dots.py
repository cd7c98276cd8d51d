"""``remat_policy='dots'`` (``models/dmt.py``): the blocks' backward keeps
the outputs of their 2-D weight products and recomputes the rest. The loss
and every gradient under ``'dots'`` equal ``'full'``'s and ``'none'``'s
(f32, 1e-6 relative), dropout on, so the per-block seeds replay their
masks; the backward under ``'dots'`` runs as many 2-D products as under
``'none'`` (none recomputed), and ``'full'`` more; an unknown policy
raises."""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from diffspectra_tpu_torch import configs, run_lib
from diffspectra_tpu_torch.data.pipeline import get_batch_iterator, get_dataset
from diffspectra_tpu_torch.diffusion.schedule import NoiseScheduleVP
from diffspectra_tpu_torch.models.dmt import DMT
from diffspectra_tpu_torch.training.losses import draw, get_sde_graph_loss_fn
from diffspectra_tpu_torch.training.train_state import params_of
from diffspectra_tpu_torch.utils.scalers import get_data_scaler
from diffspectra_tpu_torch.warm_state import init_variables, load_model_state

torch.set_num_threads(2)
PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


class CountProducts(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in PRODUCTS
        return func(*args, **(kwargs or {}))


def _loss_and_grads(config, batch, draws, policy):
    config.model.remat_policy = policy
    model = DMT.from_config(config)
    load_model_state(model, init_variables(model, seed=0))
    params = params_of(model.train())
    loss_fn = get_sde_graph_loss_fn(NoiseScheduleVP.from_config(config),
                                    get_data_scaler(config), config)
    loss = loss_fn(model, batch, draws)
    with CountProducts() as count:
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return loss.item(), dict(zip(params, grads)), count.n


@pytest.mark.parametrize("use_sc", [True, False])
def test_dots_matches_full_and_none(use_sc):
    config = configs.apply_overrides(configs.get_smoke_config(), {
        "model.nf": 32, "model.n_layers": 2, "model.n_heads": 4, "model.dropout": 0.1,
        "data.synthetic_size": 96})
    _, train_ds, _, _, _ = get_dataset(config)
    batch = run_lib.batch_to_device(next(get_batch_iterator(train_ds, 4, "ir", seed=0)),
                                    torch.device("cpu"))
    draws = draw(torch.Generator().manual_seed(1), torch.Generator().manual_seed(2), batch,
                 config.model.n_layers, True)
    draws["use_sc"] = use_sc
    out = {p: _loss_and_grads(config, batch, draws, p) for p in ("dots", "full", "none")}
    loss, grads, products = out["dots"]
    for policy in ("full", "none"):
        want_loss, want_grads, _ = out[policy]
        np.testing.assert_allclose(loss, want_loss, rtol=1e-6)
        for k, w in want_grads.items():
            g = grads[k]
            assert (g is None) == (w is None), k
            if w is not None:
                err = (g - w).abs().max().item()
                assert err <= 1e-6 * max(w.abs().max().item(), 1e-30), (policy, k, err)
    assert products == out["none"][2] < out["full"][2], {p: o[2] for p, o in out.items()}


def test_unknown_policy_raises():
    config = configs.apply_overrides(configs.get_smoke_config(),
                                     {"model.remat_policy": "dots_with_batch"})
    with pytest.raises(ValueError, match="remat_policy"):
        DMT.from_config(config)

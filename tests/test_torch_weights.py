"""The JAX pytree <-> timm state dict maps of the port."""

import jax
import numpy as np
import pytest

from ssl4polyp_tpu.models import vit as jax_vit
from ssl4polyp_tpu.models.import_torch import mae_params_from_torch
from ssl4polyp_tpu_torch.models.vit import ViT, ViTConfig
from ssl4polyp_tpu_torch.models.weights import jax_from_state_dict, state_dict_from_jax

TINY = dict(img_size=32, patch_size=8, embed_dim=64, depth=3, num_heads=4)


def _jax_params(num_classes, pos_embed):
    cfg = jax_vit.ViTConfig(num_classes=num_classes, pos_embed=pos_embed, **TINY)
    params = jax.tree_util.tree_map(np.asarray, jax_vit.init_vit(jax.random.PRNGKey(3), cfg))
    return params, cfg


def _assert_trees_equal(a, b, path=()):
    assert isinstance(a, dict) == isinstance(b, dict), path
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for key in a:
            _assert_trees_equal(a[key], b[key], path + (key,))
    else:
        assert a.shape == b.shape and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))


@pytest.mark.parametrize("num_classes, pos_embed", [(2, "learned"), (None, "sincos")])
def test_round_trip_is_exact(num_classes, pos_embed):
    params, _ = _jax_params(num_classes, pos_embed)
    cfg = ViTConfig(num_classes=num_classes, pos_embed=pos_embed, **TINY)
    state = state_dict_from_jax(params, cfg)
    _assert_trees_equal(jax_from_state_dict(state, cfg), params)
    # The names and shapes are the port model's own.
    import torch

    model = ViT(cfg, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()
    }


def test_jax_importer_reads_the_port_state_dict():
    # The JAX package's own reader of timm-named MAE checkpoints maps the
    # port's state dict back to the encoder tree: an independent check of
    # the names and layouts.
    params, jcfg = _jax_params(None, "sincos")
    state = state_dict_from_jax(params, ViTConfig(pos_embed="sincos", **TINY))
    numpy_state = {k: v.numpy() for k, v in state.items()}
    _assert_trees_equal(mae_params_from_torch(numpy_state, jcfg), params)

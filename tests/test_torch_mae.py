"""The port's MAE against the JAX ``mae_forward``: loss and every gradient.

A tiny MAE (img 32, patch 8, D 64, 2 blocks of 4 heads; decoder 32 wide, 1
block of 2 heads) with the JAX package's weights carried over by
``mae_state_dict_from_jax``, the same uint8 batch, and the masking noise the
JAX key draws (``jax.random.uniform(key, (B, L))``) handed to the port.  The
JAX side runs its XLA path, the port its plain torch path (on the CPU),
through the gradient function of its pretrain step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl4polyp_tpu.data.augment import normalize_batch as jax_normalize
from ssl4polyp_tpu.models import mae as jax_mae
from ssl4polyp_tpu.models import vit as jax_vit
from ssl4polyp_tpu.models.import_torch import mae_params_from_torch
from ssl4polyp_tpu_torch.models.factory import LAYOUT_KEYS
from ssl4polyp_tpu_torch.models.mae import (
    MAE,
    MAEConfig,
    mae_loss,
    patchify,
    random_masking,
    unpatchify,
)
from ssl4polyp_tpu_torch.models.vit import ViTConfig
from ssl4polyp_tpu_torch.models.weights import jax_from_mae_state_dict, mae_state_dict_from_jax
from ssl4polyp_tpu_torch.training.pretrain import init_pretrain_state, loss_and_grads

ENCODER = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4)
DECODER = dict(decoder_embed_dim=32, decoder_depth=1, decoder_num_heads=2, mask_ratio=0.75)
# fp32: the same math in another order (XLA fusions, summation order).
# bf16: the JAX XLA path takes the softmax in bf16 with the scale on the
# scores, the port in fp32 with the scale folded into q (the kernel's
# recipe), and XLA keeps some elementwise chains in fp32 between
# roundings: a few bf16 ulps through 3 blocks, forward and backward.  The
# loss is compared relatively, each gradient as the relative L2 distance.
LOSS_RTOL = {torch.float32: 1e-6, torch.bfloat16: 1e-3}
GRAD_RTOL = {torch.float32: 1e-5, torch.bfloat16: 5e-2}


def tiny_pair(dtype, seed=0):
    """(JAX params, JAX cfg, port model) with the same weights."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    f32 = dtype == torch.float32
    jcfg = jax_mae.MAEConfig(
        encoder=jax_vit.ViTConfig(compute_dtype=jdt, attention_softmax_f32=f32, **ENCODER),
        **DECODER,
    )
    params = jax.tree_util.tree_map(np.asarray, jax_mae.init_mae(jax.random.PRNGKey(seed), jcfg))
    cfg = MAEConfig(encoder=ViTConfig(compute_dtype=dtype, attention_softmax_f32=f32, **ENCODER),
                    **DECODER)
    model = MAE(cfg, torch.Generator().manual_seed(seed))
    model.load_state_dict(mae_state_dict_from_jax(params, cfg))
    return params, jcfg, model


def _relative_l2(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_loss_and_gradients_match_jax(dtype):
    params, jcfg, model = tiny_pair(dtype)
    B, L = 3, jcfg.encoder.num_patches
    images = np.random.default_rng(1).integers(0, 256, (B, 32, 32, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(7)
    noise = np.array(jax.random.uniform(key, (B, L)))

    def jax_loss(p):
        x = jax_normalize(jnp.asarray(images), jcfg.encoder.compute_dtype)
        return jax_mae.mae_forward(p, x, key, jcfg)[0]

    ref_loss, ref_grads = jax.value_and_grad(jax_loss)(params)
    ref_grads = mae_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, ref_grads), model.cfg)

    loss, grads = loss_and_grads(init_pretrain_state(model), torch.from_numpy(images)[None],
                                 torch.from_numpy(noise)[None])
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=LOSS_RTOL[dtype])
    assert sorted(grads) == sorted(ref_grads)
    for name, g in grads.items():
        got, want = g.numpy(), ref_grads[name].numpy()
        assert g.dtype == torch.float32 and got.shape == want.shape, name
        if name.endswith("attn.qkv.bias"):
            # The K slice's exact gradient is zero (the softmax ignores a
            # shift of the scores along k): both sides hold rounding noise.
            d = got.shape[0] // 3
            got, want = np.concatenate([got[:d], got[2 * d:]]), np.concatenate([want[:d], want[2 * d:]])
        assert _relative_l2(got, want) < GRAD_RTOL[dtype], (name, _relative_l2(got, want))


def test_norm_pix_loss_matches_jax():
    images = np.random.default_rng(6).standard_normal((2, 32, 32, 3)).astype(np.float32)
    pred = np.random.default_rng(7).standard_normal((2, 16, 192)).astype(np.float32)
    mask = (np.random.default_rng(8).random((2, 16)) < 0.75).astype(np.float32)
    _, jcfg, model = tiny_pair(torch.float32)
    jcfg = dataclasses.replace(jcfg, norm_pix_loss=True)
    cfg = dataclasses.replace(model.cfg, norm_pix_loss=True)
    ref = jax_mae.mae_loss(jnp.asarray(images), jnp.asarray(pred), jnp.asarray(mask), jcfg)
    ours = mae_loss(torch.from_numpy(images), torch.from_numpy(pred), torch.from_numpy(mask), cfg)
    np.testing.assert_allclose(ours.item(), float(ref), rtol=LOSS_RTOL[torch.float32])


def test_random_masking_matches_jax():
    x = np.random.default_rng(2).standard_normal((4, 16, 8)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    ref = jax_mae.random_masking(jnp.asarray(x), key, 4)
    ours = random_masking(torch.from_numpy(x), torch.from_numpy(np.array(jax.random.uniform(key, (4, 16)))), 4)
    for got, want in zip(ours, ref):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_patchify_round_trip_matches_jax():
    images = np.random.default_rng(4).standard_normal((2, 16, 16, 3)).astype(np.float32)
    patches = patchify(torch.from_numpy(images), 8)
    np.testing.assert_array_equal(patches.numpy(), np.asarray(jax_mae.patchify(jnp.asarray(images), 8)))
    np.testing.assert_array_equal(unpatchify(patches, 8).numpy(), images)


def _assert_trees_equal(a, b, path=()):
    assert isinstance(a, dict) == isinstance(b, dict), path
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for key in a:
            _assert_trees_equal(a[key], b[key], path + (key,))
    else:
        assert a.shape == b.shape and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_weight_map_round_trip_and_jax_importer():
    params, jcfg, model = tiny_pair(torch.float32, seed=5)
    state = mae_state_dict_from_jax(params, model.cfg)
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()
    }
    _assert_trees_equal(jax_from_mae_state_dict(state, model.cfg), params)
    # The JAX package's own reader of timm-named MAE checkpoints maps the
    # port's state dict back to the full tree, decoder included.
    numpy_state = {k: v.numpy() for k, v in state.items()}
    _assert_trees_equal(
        mae_params_from_torch(numpy_state, jcfg.encoder, include_decoder=True,
                              decoder_depth=jcfg.decoder_depth),
        params,
    )


def test_frozen_tables_and_layout_keys():
    _, jcfg, model = tiny_pair(torch.float32)
    frozen = {n for n, p in model.named_parameters() if not p.requires_grad}
    assert frozen == {"pos_embed", "decoder_pos_embed"}
    # The JAX MAE config's fields all have counterparts: the padding fields
    # decide where the fusion knobs apply (the port never pads), and the
    # classifier factory, which they do not concern, discards them.
    jax_only = {f.name for f in dataclasses.fields(jcfg)} - {
        f.name for f in dataclasses.fields(model.cfg)}
    assert jax_only == set() and {"encoder_pad_to", "decoder_pad_to"} <= LAYOUT_KEYS
    assert (model.cfg.encoder_pad_to, model.cfg.decoder_pad_to) == (None, None)

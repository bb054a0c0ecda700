"""The whole slice: the port's ViT against the JAX ``vit_forward``.

A tiny ViT (img 32, patch 8, D 64, depth 2, 4 heads, 2 classes) with the
JAX package's weights, carried over by ``state_dict_from_jax``; the JAX side
runs its XLA path, the port its plain torch path (on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl4polyp_tpu.models import vit as jax_vit
from ssl4polyp_tpu_torch.models.vit import ViT, ViTConfig
from ssl4polyp_tpu_torch.models.weights import state_dict_from_jax

TINY = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4, num_classes=2)
# fp32: same math, different summation order and XLA fusion, through two
# blocks.  bf16: both round at every op boundary, but XLA keeps some fused
# elementwise chains (normalize, residual adds) in fp32 between roundings;
# a few bf16 ulps (2^-8 relative) at logits of magnitude ~2 after 2 blocks.
TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}


def tiny_pair(pos_embed, out_token, dtype, seed=0):
    """(JAX params, JAX cfg, port model) with the same weights."""
    jax_dtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jcfg = jax_vit.ViTConfig(pos_embed=pos_embed, out_token=out_token,
                             compute_dtype=jax_dtype, **TINY)
    params = jax.tree_util.tree_map(np.asarray, jax_vit.init_vit(jax.random.PRNGKey(seed), jcfg))
    if pos_embed == "learned":
        # init_vit's learned table is random; sincos is fixed, same on both sides.
        assert params["pos_embed"].std() > 0
    cfg = ViTConfig(pos_embed=pos_embed, out_token=out_token, compute_dtype=dtype, **TINY)
    model = ViT(cfg, torch.Generator().manual_seed(seed))
    model.load_state_dict(state_dict_from_jax(params, cfg))
    return params, jcfg, model


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("out_token", ["cls", "spatial"])
@pytest.mark.parametrize("pos_embed", ["sincos", "learned"])
def test_vit_forward_matches_jax(pos_embed, out_token, dtype):
    params, jcfg, model = tiny_pair(pos_embed, out_token, dtype)
    images = np.random.default_rng(1).standard_normal((3, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(jax_vit.vit_forward(params, jnp.asarray(images), jcfg))
    with torch.inference_mode():
        ours = model(torch.from_numpy(images)).numpy()
    assert ours.shape == (3, 2) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, rtol=TOL[dtype], atol=TOL[dtype])


def test_build_classifier_dispatch_and_layout_keys(tmp_path):
    from ssl4polyp_tpu_torch.models.factory import LAYOUT_KEYS, build_classifier

    layout = {"unroll_blocks": True, "remat": True, "fused_layernorm": True,
              "use_pallas_attention": True, "encoder_pad_to": 56, "decoder_pad_to": 200}
    assert set(layout) == LAYOUT_KEYS
    # The padding and the fusion knobs are config fields: they decide which
    # kernels run (tests/test_torch_fusion_knobs.py).
    small = dict(TINY, **layout, pad_tokens_to=24, mlp_fusion="full", qkv_ln_fusion=True)
    small.pop("num_classes")
    gen = torch.Generator().manual_seed(0)
    mae = build_classifier(gen, {"ss_framework": "mae", "key": "ssl_colon"}, **small)
    timm = build_classifier(gen, {"pretraining": "ImageNet_class"}, **small)
    plain = build_classifier(gen, {}, **small)
    assert (mae.cfg.pos_embed, mae.scheme) == ("sincos", "ssl_colon")
    assert (timm.cfg.pos_embed, timm.scheme) == ("learned", "random")
    assert plain.cfg == timm.cfg and plain.cfg.num_classes == 2
    for built in (mae, timm, plain):
        assert (built.cfg.pad_tokens_to, built.cfg.mlp_fusion, built.cfg.qkv_ln_fusion) == (
            24, "full", True)
        # D 64 is no width the JAX package flattens: the default kernels run.
        assert {(b.mlp_route, b.qkv_ln) for b in built.model.blocks} == {("fc1", False)}
    with pytest.raises(NotImplementedError):
        build_classifier(gen, {"dense": True}, **small)
    (tmp_path / "w.npz").write_bytes(b"")
    with pytest.raises(NotImplementedError):
        build_classifier(gen, {"checkpoint": "w.npz"}, checkpoint_root=tmp_path, **small)

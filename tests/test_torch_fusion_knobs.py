"""``mlp_fusion``, ``qkv_ln_fusion`` and the ``BENCH_ATTN_PROJ=1`` projection
fold are validated and honoured on exactly the stacks of blocks where the
JAX package honours them (its flattened stream).

The JAX side runs its own forward with the kernels switched on
(``use_pallas_attention``) and the blocks unrolled (one call per block), so
that its own padding and ``run_blocks`` decide.  Its attention, MLP and
LayerNorm functions are replaced by stand-ins that record which kernel each
block asked for and keep the shapes (the Pallas kernels do not run on the
CPU outside interpret mode).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl4polyp_tpu.models import factory as jax_factory
from ssl4polyp_tpu.models import layers as jax_layers
from ssl4polyp_tpu.models import mae as jax_mae
from ssl4polyp_tpu.models import vit as jax_vit
from ssl4polyp_tpu.training import pretrain as jax_pretrain
from ssl4polyp_tpu_torch.models.factory import build_classifier
from ssl4polyp_tpu_torch.models.layers import block_route
from ssl4polyp_tpu_torch.models.mae import MAE, MAEConfig
from ssl4polyp_tpu_torch.models.vit import ViTConfig
from ssl4polyp_tpu_torch.training import pretrain

SHAPES = dict(img_size=32, patch_size=8, depth=2, num_heads=4)  # 16 patches, 17 tokens
KNOBS = [dict(), dict(mlp_fusion="off"), dict(mlp_fusion="fc1"), dict(mlp_fusion="full"),
         dict(mlp_fusion="full_ln"), dict(qkv_ln_fusion=True),
         dict(mlp_fusion="full_ln", qkv_ln_fusion=True), dict(mlp_fusion="full", qkv_ln_fusion=True)]
KNOB_IDS = ["default", "off", "fc1", "full", "full_ln", "qkv_ln", "full_ln+qkv_ln", "full+qkv_ln"]


@pytest.fixture
def jax_routes(monkeypatch):
    """The (MLP route, qkv_ln) of each block the JAX package runs, in order;
    the JAX "off" and "fc1" are both the port's "fc1"."""
    calls = []

    def attention(x, p, num_heads, *, ln=None, **kwargs):
        calls.append({"qkv_ln": ln is not None})
        return jnp.zeros_like(x)

    def mlp(x, p, kernel="off"):
        calls[-1]["mlp"] = "full" if kernel == "full" else "fc1"
        return jnp.zeros_like(x)

    def mlp_ln(x, ln, p, eps=1e-6):
        calls[-1]["mlp"] = "full_ln"
        return x

    monkeypatch.setattr(jax_layers, "attention", attention)
    monkeypatch.setattr(jax_layers, "mlp", mlp)
    monkeypatch.setattr(jax_layers, "mlp_ln", mlp_ln)
    monkeypatch.setattr(jax_layers, "layernorm", lambda x, *args, **kwargs: x)
    return calls


def _routes(blocks):
    return [(block.mlp_route, block.qkv_ln) for block in blocks]


def _recorded(calls):
    return [(call["mlp"], call["qkv_ln"]) for call in calls]


@pytest.mark.parametrize("pad", [None, 0, 24], ids=["factory-pad", "pad-off", "pad-24"])
@pytest.mark.parametrize("dim", [128, 64], ids=["D128", "D64"])
@pytest.mark.parametrize("knobs", KNOBS, ids=KNOB_IDS)
def test_classifier_routes_match_the_jax_stack(jax_routes, knobs, dim, pad):
    pads = {} if pad is None else {"pad_tokens_to": pad}
    jcfg = jax_factory._vit_b(2, "cls", "learned", embed_dim=dim, use_pallas_attention=True,
                              unroll_blocks=True, compute_dtype=jnp.float32, **SHAPES, **knobs,
                              **pads)
    params = jax_vit.init_vit(jax.random.PRNGKey(0), jcfg)
    jax_vit.vit_features(params, jnp.zeros((1, 32, 32, 3)), jcfg)
    ours = build_classifier(torch.Generator().manual_seed(0), {}, device="cpu",
                            embed_dim=dim, **SHAPES, **knobs, **pads)
    assert _routes(ours.model.blocks) == _recorded(jax_routes)
    # The knobs reach the kernels only where the stream is flattened: the
    # factory pads 17 tokens to 24 unless told not to, and D 64 is never flat.
    flat = pad != 0 and dim == 128
    expect_default = not flat or knobs.get("mlp_fusion") in (None, "off", "fc1")
    assert (_routes(ours.model.blocks)[0][0] == "fc1") == expect_default


@pytest.mark.parametrize("pads", [(None, None), (None, 24), (8, 24), (8, None)],
                         ids=["unpadded", "decoder-padded", "both-padded", "encoder-padded"])
@pytest.mark.parametrize("knobs", KNOBS, ids=KNOB_IDS)
def test_mae_routes_match_the_jax_stacks(jax_routes, knobs, pads):
    encoder_pad, decoder_pad = pads
    dec = dict(decoder_embed_dim=128, decoder_depth=1, decoder_num_heads=4)
    jcfg = jax_mae.MAEConfig(
        encoder=jax_vit.ViTConfig(embed_dim=128, use_pallas_attention=True, unroll_blocks=True,
                                  compute_dtype=jnp.float32, **SHAPES, **knobs),
        encoder_pad_to=encoder_pad, decoder_pad_to=decoder_pad, **dec)
    params = jax_mae.init_mae(jax.random.PRNGKey(0), jcfg)
    latent, _, ids_restore = jax_mae.mae_encode(params, jnp.zeros((1, 32, 32, 3)),
                                                jax.random.PRNGKey(1), jcfg)
    jax_mae.mae_decode(params, latent, ids_restore, jcfg)
    cfg = MAEConfig(encoder=ViTConfig(embed_dim=128, **SHAPES, **knobs),
                    encoder_pad_to=encoder_pad, decoder_pad_to=decoder_pad, **dec)
    model = MAE(cfg, torch.Generator().manual_seed(0))
    assert _routes(model.blocks) + _routes(model.decoder_blocks) == _recorded(jax_routes)


@pytest.fixture
def jax_folds(monkeypatch):
    """Whether each block's attention, as the JAX package runs it with its
    kernels on, went through the attention+projection kernel.  That kernel
    runs for real, in interpret mode (``attn_proj._FORCE_INTERPRET``, as the
    JAX package's own test runs it); the attention kernels it would have
    called otherwise do not run on the CPU outside interpret mode, and the
    MLP and LayerNorm are not the point: stand-ins keep their shapes."""
    from ssl4polyp_tpu.ops import attn_proj as jax_attn_proj
    from ssl4polyp_tpu.ops import qkv_attention as jax_qkv_attention

    calls = []
    real = jax_attn_proj.fused_attention_proj

    def folded(qkv, w, b, *args):
        calls.append(True)
        return real(qkv, w, b, *args)

    def core(qkv, *args):
        calls.append(False)
        return jnp.zeros(qkv.shape[:2] + (qkv.shape[2] // 3,), qkv.dtype)

    monkeypatch.setattr(jax_attn_proj, "_FORCE_INTERPRET", True)
    monkeypatch.setattr(jax_attn_proj, "fused_attention_proj", folded)
    monkeypatch.setattr(jax_qkv_attention, "fused_qkv_attention", core)
    monkeypatch.setattr(jax_qkv_attention, "fused_qkv_bias_attention",
                        lambda qkv, bias, *args: core(qkv))
    monkeypatch.setattr(jax_layers, "mlp", lambda x, p, kernel="off": jnp.zeros_like(x))
    monkeypatch.setattr(jax_layers, "mlp_ln", lambda x, ln, p, eps=1e-6: x)
    monkeypatch.setattr(jax_layers, "layernorm", lambda x, *args, **kwargs: x)
    return calls


def _folds(blocks):
    return [block.attn.proj_fold for block in blocks]


@pytest.mark.parametrize("knob", ["1", "0", None], ids=["fold", "knob-0", "knob-unset"])
@pytest.mark.parametrize("pad", [None, 0, 24], ids=["factory-pad", "pad-off", "pad-24"])
@pytest.mark.parametrize("dim", [128, 64], ids=["D128", "D64"])
def test_classifier_fold_matches_the_jax_stack(jax_folds, monkeypatch, dim, pad, knob):
    if knob is None:
        monkeypatch.delenv("BENCH_ATTN_PROJ", raising=False)
    else:
        monkeypatch.setenv("BENCH_ATTN_PROJ", knob)
    pads = {} if pad is None else {"pad_tokens_to": pad}
    jcfg = jax_factory._vit_b(2, "cls", "learned", embed_dim=dim, use_pallas_attention=True,
                              unroll_blocks=True, compute_dtype=jnp.float32, **SHAPES, **pads)
    params = jax_vit.init_vit(jax.random.PRNGKey(0), jcfg)
    jax_vit.vit_features(params, jnp.zeros((1, 32, 32, 3)), jcfg)
    ours = build_classifier(torch.Generator().manual_seed(0), {}, device="cpu", embed_dim=dim,
                            **SHAPES, **pads)
    assert _folds(ours.model.blocks) == jax_folds
    # The fold needs the knob and the flattened stream: the factory pads 17
    # tokens to 24 unless told not to, and D 64 is never flat.
    assert all(_folds(ours.model.blocks)) == (knob == "1" and pad != 0 and dim == 128)


@pytest.mark.parametrize("pads", [(None, None), (None, 24), (8, 24), (8, None)],
                         ids=["unpadded", "decoder-padded", "both-padded", "encoder-padded"])
def test_mae_fold_matches_the_jax_stacks(jax_folds, monkeypatch, pads):
    monkeypatch.setenv("BENCH_ATTN_PROJ", "1")
    encoder_pad, decoder_pad = pads
    dec = dict(decoder_embed_dim=128, decoder_depth=1, decoder_num_heads=4)
    jcfg = jax_mae.MAEConfig(
        encoder=jax_vit.ViTConfig(embed_dim=128, use_pallas_attention=True, unroll_blocks=True,
                                  compute_dtype=jnp.float32, **SHAPES),
        encoder_pad_to=encoder_pad, decoder_pad_to=decoder_pad, **dec)
    params = jax_mae.init_mae(jax.random.PRNGKey(0), jcfg)
    latent, _, ids_restore = jax_mae.mae_encode(params, jnp.zeros((1, 32, 32, 3)),
                                                jax.random.PRNGKey(1), jcfg)
    jax_mae.mae_decode(params, latent, ids_restore, jcfg)
    cfg = MAEConfig(encoder=ViTConfig(embed_dim=128, **SHAPES),
                    encoder_pad_to=encoder_pad, decoder_pad_to=decoder_pad, **dec)
    model = MAE(cfg, torch.Generator().manual_seed(0))
    assert _folds(model.blocks) + _folds(model.decoder_blocks) == jax_folds
    # Each stack on its own: 5 encoder and 17 decoder tokens fold only padded.
    assert all(_folds(model.blocks)) == (encoder_pad is not None)
    assert all(_folds(model.decoder_blocks)) == (decoder_pad is not None)


def test_the_pretrain_recipe_folds_the_decoder_and_not_the_encoder(monkeypatch):
    monkeypatch.setenv("BENCH_ATTN_PROJ", "1")
    cfg = pretrain.model_config(pretrain.PretrainSettings())
    enc = cfg.encoder
    assert not block_route(1 + cfg.len_keep, cfg.encoder_pad_to, enc.embed_dim, None, False)[2]
    assert block_route(1 + enc.num_patches, cfg.decoder_pad_to, cfg.decoder_embed_dim, None,
                       False)[2]


def test_pretrain_recipe_pads_the_decoder_as_the_jax_engine_does():
    # With its kernels on, the JAX engine pads the decoder's 197 tokens to 200
    # and leaves the encoder's 50 alone (pretrain.py:134-141).
    jcfg = jax_pretrain.model_config(jax_pretrain.PretrainSettings(use_pallas_attention=True))
    cfg = pretrain.model_config(pretrain.PretrainSettings())
    assert (cfg.decoder_pad_to, cfg.encoder_pad_to) == (jcfg.decoder_pad_to, jcfg.encoder_pad_to)
    assert cfg.decoder_pad_to == 200


def test_a_mistyped_mlp_fusion_raises_as_in_the_jax_package():
    with pytest.raises(ValueError, match="mlp_fusion"):
        jax_layers.run_blocks(jnp.zeros((1, 8, 128)), {}, 4, mlp_fusion="ful")
    with pytest.raises(ValueError, match="mlp_fusion"):
        build_classifier(torch.Generator(), {}, device="cpu", **SHAPES, mlp_fusion="ful")
    with pytest.raises(ValueError, match="mlp_fusion"):
        build_classifier(torch.Generator(), {"ss_framework": "mae"}, device="cpu", **SHAPES,
                         mlp_fusion="FULL")
    with pytest.raises(ValueError, match="mlp_fusion"):
        MAEConfig(encoder=ViTConfig(**SHAPES, mlp_fusion="ful"))


@pytest.mark.parametrize("fold", [False, True], ids=["unfolded", "fold"])
def test_fused_routes_compute_the_default_routes_function_in_fp32(monkeypatch, fold):
    # The knobs choose kernels, not the model: on the CPU in fp32 every
    # route, with or without the projection fold, gives the default route's
    # logits to fp32 round-off.
    images = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 32, 32, 3))
                              .astype(np.float32))
    logits = []
    for i, knobs in enumerate(KNOBS):
        monkeypatch.setenv("BENCH_ATTN_PROJ", "1" if fold and i else "0")  # the first: default
        model = build_classifier(torch.Generator().manual_seed(0), {}, device="cpu",
                                 embed_dim=128, compute_dtype=torch.float32, **SHAPES, **knobs).model
        assert all(b.attn.proj_fold == bool(fold and i) for b in model.blocks)
        with torch.inference_mode():
            logits.append(model(images))
    for got in logits[1:]:
        torch.testing.assert_close(got, logits[0], rtol=1e-5, atol=1e-5)

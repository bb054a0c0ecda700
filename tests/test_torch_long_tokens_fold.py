"""Attention with the output projection (row 9/9b) and the QKV projection
with attention (row 10/10b) past 256 tokens: the port against the JAX
package, on the CPU.

On the card, bf16 calls of these functions past 256 tokens run
compositions on the key tiles (``csrc/attn_proj.cu``,
``csrc/attention_block.cu``), whose plain versions (the CPU path, and their
reference on the card) are the same functions at every token count.  Here
those plain versions are held against the JAX Pallas kernels in interpret
mode, forward and vjp, and a tiny classifier and a tiny MAE whose blocks
fold the projection past 256 tokens (``BENCH_ATTN_PROJ=1``) against the JAX
models under the same knob, their kernels in interpret mode.  Inputs are
made with numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl4polyp_tpu.data.augment import normalize_batch as jax_normalize
from ssl4polyp_tpu.models import factory as jax_factory
from ssl4polyp_tpu.models import mae as jax_mae
from ssl4polyp_tpu.models import vit as jax_vit
from ssl4polyp_tpu.training import classification as jax_classification
from ssl4polyp_tpu_torch.models.factory import build_classifier, get_imagenet_or_random_vit
from ssl4polyp_tpu_torch.models.mae import MAE, MAEConfig
from ssl4polyp_tpu_torch.models.vit import ViTConfig
from ssl4polyp_tpu_torch.models.weights import mae_state_dict_from_jax, state_dict_from_jax
from ssl4polyp_tpu_torch.ops.attention_block import fused_qkvproj_attention
from ssl4polyp_tpu_torch.ops.attn_proj import fused_attention_proj_plain
from ssl4polyp_tpu_torch.training import classification, pretrain
from tests.test_torch_attention_block import _inputs as qkvproj_inputs
from tests.test_torch_attention_block import _jax_all as jax_qkvproj_all
from tests.test_torch_attn_proj import _inputs as attn_proj_inputs
from tests.test_torch_attn_proj import _jax_all as jax_attn_proj_all
from tests.test_torch_finetune import _jax_augment, _numpy_params, _torch_params
from tests.test_torch_fusion_knobs import jax_kernels_interpreted  # noqa: F401 (fixture)

# As test_torch_attn_proj.py's and test_torch_attention_block.py's.  fp32 on
# both sides, same algorithm: only summation order differs; the gradients
# sum over every row of the batch, so their tolerance is relative to the
# largest entry.  bf16 on both sides: both round at the same points, so a
# rounding that flips on an fp32 order difference moves an output by one
# bf16 ulp (2^-7 relative at |y| < 2), and the sums over rows carry such
# flips with random signs.
F32_TOL = 2e-5
BWD_F32_TOL = 1e-4
BF16_TOL = 2e-2
BWD_BF16_TOL = 3e-2
TOLS = {torch.float32: (jnp.float32, F32_TOL, BWD_F32_TOL),
        torch.bfloat16: (jnp.bfloat16, BF16_TOL, BWD_BF16_TOL)}

# (N, heads, head dim, valid_len): one token past 256 and a ragged count,
# with all keys and with keys cut below N, at hd 32 (whose bf16 scale fold
# rounds) and 64; D 128, a width the bf16 kernels take.
SHAPES = [(257, 2, 64, None), (257, 4, 32, 200), (290, 4, 32, None), (290, 2, 64, 289)]
SHAPE_IDS = ["257-hd64", "257-hd32-valid200", "290-hd32", "290-hd64-valid289"]


def _assert_all_close(ours, ref, names, tol, bwd_tol, rows):
    np.testing.assert_allclose(ours[0][:, rows], ref[0][:, rows], rtol=tol, atol=tol,
                               err_msg="out")
    for name, a, b in zip(names, ours[1:], ref[1:]):
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=bwd_tol, atol=bwd_tol * scale, err_msg=name)


def _torch_all(fn, arrays, dy, H, softmax_f32, valid_len, dtype):
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_() for a in arrays]
    out = fn(*leaves, H, softmax_f32, valid_len)
    out.backward(torch.from_numpy(dy).to(dtype))
    return tuple(t.detach().float().numpy() for t in (out, *[a.grad for a in leaves]))


@pytest.mark.parametrize("N, H, hd, valid_len", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("softmax_f32", [True, False], ids=["f32-scores", "bf16-scores"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_attention_proj_past_256_tokens_matches_the_jax_kernel(N, H, hd, valid_len, softmax_f32,
                                                                dtype):
    qkv, w, b, dy = attn_proj_inputs(N + hd, 1, N, H, hd)
    if valid_len is not None:
        dy[:, valid_len:] = 0  # the pad rows' upstream gradient is zero
    jdt, tol, bwd_tol = TOLS[dtype]
    ours = _torch_all(fused_attention_proj_plain, (qkv, w, b), dy, H, softmax_f32, valid_len,
                      dtype)
    ref = jax_attn_proj_all(qkv, w, b, dy, H, softmax_f32, valid_len, jdt)
    _assert_all_close(ours, ref, ("dqkv", "dw", "db"), tol, bwd_tol, slice(0, valid_len))


@pytest.mark.parametrize("N, H, hd, valid_len", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("softmax_f32", [True, False], ids=["f32-scores", "bf16-scores"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_qkvproj_attention_past_256_tokens_matches_the_jax_kernel(N, H, hd, valid_len,
                                                                   softmax_f32, dtype):
    # CPU tensors through the public function: its plain versions.
    x, w, b, dout = qkvproj_inputs(N + hd, 1, N, 64, H, hd)
    if valid_len is not None:
        dout[:, valid_len:] = 0
    jdt, tol, bwd_tol = TOLS[dtype]
    ours = _torch_all(fused_qkvproj_attention, (x, w, b), dout, H, softmax_f32, valid_len, dtype)
    ref = jax_qkvproj_all(x, w, b, dout, H, softmax_f32, valid_len, jdt)
    _assert_all_close(ours, ref, ("dx", "dw", "db"), tol, bwd_tol, slice(0, valid_len))


# A tiny ViT whose blocks fold the projection past 256 tokens: patch 4 at
# 68 px is 289 patches and the class token, 290 tokens, padded to 296 (a
# multiple of 8); D 128 (2 heads of 64), so that the JAX package runs its
# flattened stream, where alone the fold applies.
TINY = dict(img_size=68, patch_size=4, embed_dim=128, depth=2, num_heads=2)
# As test_torch_long_tokens.py's: fp32 the same math in another order
# through two blocks; bf16 a few ulps where the two sides' chains round in
# another order.
LOGITS_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
# One fine-tune step in fp32, as test_torch_finetune.py's: summation orders
# and the JAX GELU's polynomial erf (max error 2.2e-6).
STEP_LOSS_RTOL = 1e-5
STEP_GRAD_RTOL = 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_folded_vit_past_256_tokens_matches_jax(jax_kernels_interpreted, dtype):  # noqa: F811
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jcfg = jax_factory._vit_b(2, "cls", "learned", use_pallas_attention=True, unroll_blocks=True,
                              compute_dtype=jdt, **TINY)
    assert (jcfg.num_patches + 1, jcfg.pad_tokens_to) == (290, 296)
    params = jax.tree_util.tree_map(np.asarray, jax_vit.init_vit(jax.random.PRNGKey(0), jcfg))
    images = np.random.default_rng(1).standard_normal((2, 68, 68, 3)).astype(np.float32)
    ref = np.asarray(jax_vit.vit_forward(params, jnp.asarray(images), jcfg))
    assert jax_kernels_interpreted == [True, True]  # both blocks on the JAX fold kernel
    model = get_imagenet_or_random_vit(torch.Generator().manual_seed(0), jax_params=params,
                                       num_classes=2, device="cpu", compute_dtype=dtype,
                                       **TINY).model
    assert model.cfg.pad_tokens_to == 296 and all(b.attn.proj_fold for b in model.blocks)
    with torch.inference_mode():
        ours = model(torch.from_numpy(images)).numpy()
    assert ours.shape == (2, 2) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, rtol=LOGITS_TOL[dtype], atol=LOGITS_TOL[dtype])


def test_folded_finetune_step_past_256_tokens_matches_jax(jax_kernels_interpreted):  # noqa: F811
    jax_clf = jax_factory.get_imagenet_or_random_vit(
        jax.random.PRNGKey(0), pos_embed="learned", compute_dtype=jnp.float32,
        use_pallas_attention=True, unroll_blocks=True, **TINY)
    params = jax.tree_util.tree_map(np.asarray, jax_clf.params)
    ours = build_classifier(torch.Generator().manual_seed(0), {}, jax_params=params, device="cpu",
                            pos_embed="learned", compute_dtype=torch.float32, **TINY)
    assert all(b.attn.proj_fold for b in ours.model.blocks)
    B = 3
    images = np.random.default_rng(2).integers(0, 256, (B, 68, 68, 3), dtype=np.uint8)
    p = _numpy_params(4, B)  # the augmentation's draws, handed to both sides
    labels, valid = np.array([0, 1, 1]), np.array([True, True, False])
    loss_args = classification.loss_settings([40, 20])
    ctx = classification.step_context(ours, *loss_args, weight_decay=0.05)
    state = classification.init_train_state(ours, torch.Generator().manual_seed(0))
    loss, grads = classification.loss_and_grads(
        ctx, state, torch.from_numpy(images), torch.from_numpy(labels), torch.from_numpy(valid),
        _torch_params(p))

    def jax_loss(tree):
        logits = jax_clf.apply(tree, _jax_augment(images, p))
        return jax_classification._loss_from_logits(logits, jnp.asarray(labels),
                                                     jnp.asarray(valid), *loss_args)

    want, want_grads = jax.value_and_grad(jax_loss)(jax.tree_util.tree_map(jnp.asarray, params))
    assert set(jax_kernels_interpreted) == {True}  # every block folded, forward and backward
    np.testing.assert_allclose(loss.item(), float(want), rtol=STEP_LOSS_RTOL)
    want_grads = {k: v.numpy() for k, v in state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, want_grads), ours.cfg).items()}
    assert set(grads) == set(want_grads)
    for name, g in grads.items():
        w = want_grads[name]
        scale = max(1e-3, float(np.abs(w).max()))
        err = float(np.abs(g.numpy() - w).max()) / scale
        assert err < STEP_GRAD_RTOL, f"gradient of {name} off by {err:.2e} of its scale"


# A tiny MAE whose decoder folds past 256 tokens: the decoder runs the 290
# tokens padded to 296 at D 128 (2 heads of 64), 1 block; the encoder keeps
# 72 of the 289 patches and the class token at D 64, on the attention
# kernel.
MAE_ENCODER = dict(img_size=68, patch_size=4, embed_dim=64, depth=2, num_heads=4)
MAE_DECODER = dict(decoder_embed_dim=128, decoder_depth=1, decoder_num_heads=2, mask_ratio=0.75,
                   decoder_pad_to=296)
# As test_torch_long_tokens.py's: fp32 another order; bf16 both sides' bf16
# roundings at the same points up to order, a few bf16 ulps through 3 blocks.
MAE_LOSS_RTOL = {torch.float32: 1e-6, torch.bfloat16: 1e-3}
MAE_GRAD_RTOL = {torch.float32: 1e-5, torch.bfloat16: 5e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_mae_step_with_a_folded_decoder_past_256_tokens_matches_jax(jax_kernels_interpreted,  # noqa: F811
                                                                    dtype):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    f32 = dtype == torch.float32
    jcfg = jax_mae.MAEConfig(
        encoder=jax_vit.ViTConfig(compute_dtype=jdt, attention_softmax_f32=f32,
                                  use_pallas_attention=True, unroll_blocks=True, **MAE_ENCODER),
        **MAE_DECODER)
    params = jax.tree_util.tree_map(np.asarray, jax_mae.init_mae(jax.random.PRNGKey(0), jcfg))
    cfg = MAEConfig(encoder=ViTConfig(compute_dtype=dtype, attention_softmax_f32=f32,
                                      **MAE_ENCODER), **MAE_DECODER)
    assert (1 + cfg.encoder.num_patches, 1 + cfg.len_keep) == (290, 73)
    model = MAE(cfg, torch.Generator().manual_seed(0))
    assert [b.attn.proj_fold for b in model.blocks] == [False, False]
    assert [b.attn.proj_fold for b in model.decoder_blocks] == [True]
    model.load_state_dict(mae_state_dict_from_jax(params, cfg))
    B, L = 2, cfg.encoder.num_patches
    images = np.random.default_rng(3).integers(0, 256, (B, 68, 68, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(5)
    noise = np.array(jax.random.uniform(key, (B, L)))

    def jax_loss(p):
        x = jax_normalize(jnp.asarray(images), jcfg.encoder.compute_dtype)
        return jax_mae.mae_forward(p, x, key, jcfg)[0]

    ref_loss, ref_grads = jax.value_and_grad(jax_loss)(params)
    # The encoder's blocks on the attention kernel, the decoder's folded.
    assert sorted(set(jax_kernels_interpreted)) == [False, True]
    ref_grads = mae_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, ref_grads), cfg)
    loss, grads = pretrain.loss_and_grads(pretrain.init_pretrain_state(model),
                                          torch.from_numpy(images)[None],
                                          torch.from_numpy(noise)[None])
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=MAE_LOSS_RTOL[dtype])
    assert sorted(grads) == sorted(ref_grads)
    for name, g in grads.items():
        got, want = g.numpy(), ref_grads[name].numpy()
        if name.endswith("attn.qkv.bias"):  # the K slice's exact gradient is zero
            d = got.shape[0] // 3
            got = np.concatenate([got[:d], got[2 * d:]])
            want = np.concatenate([want[:d], want[2 * d:]])
        rel = float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))
        assert rel < MAE_GRAD_RTOL[dtype], (name, rel)

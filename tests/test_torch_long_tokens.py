"""More than 256 tokens: the port against the JAX package, on the CPU.

A ViT-B/16 at 384 px has 577 tokens, past what the bf16 attention kernels of
``csrc/qkv_attention.cu`` hold on chip; on the card bf16 calls past 256
tokens take the key-tile kernels of ``csrc/qkv_attention_tiles.cu``, whose
plain versions (the CPU path and their reference on the card) are the same
functions at every token count.  Here those plain versions, a tiny
classifier and a tiny MAE whose decoder runs more than 256 tokens are held
against the JAX package (its Pallas kernels in interpret mode, its XLA
model paths), on inputs made with numpy from a seed; and the wrappers route
such calls to the key tiles: the attention kernels', and the compositions
on them of attention with the projection and of the QKV projection with
attention (whose plain versions tests/test_torch_long_tokens_fold.py holds
against the JAX package there), and attention over separate q, k, v to the
key tiles in its own layout (its plain version is held against the JAX
kernel past 256 tokens in tests/test_torch_attention.py).
"""

import contextlib
import ctypes
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl4polyp_tpu.data.augment import normalize_batch as jax_normalize
from ssl4polyp_tpu.models import factory as jax_factory
from ssl4polyp_tpu.models import mae as jax_mae
from ssl4polyp_tpu.models import vit as jax_vit
from ssl4polyp_tpu.ops.qkv_attention import fused_qkv_attention as jax_attention
from ssl4polyp_tpu.ops.qkv_attention import fused_qkv_bias_attention as jax_bias_attention
from ssl4polyp_tpu.training import classification as jax_classification
from ssl4polyp_tpu_torch import ops
from ssl4polyp_tpu_torch.models import factory, layers
from ssl4polyp_tpu_torch.models.factory import build_classifier
from ssl4polyp_tpu_torch.models.mae import MAE, MAEConfig
from ssl4polyp_tpu_torch.models.vit import ViT, ViTConfig
from ssl4polyp_tpu_torch.models.weights import mae_state_dict_from_jax, state_dict_from_jax
from ssl4polyp_tpu_torch.ops import _build, attention, attention_block, attn_proj, qkv_attention
from ssl4polyp_tpu_torch.ops.qkv_attention import (
    fused_qkv_attention_backward_reference,
    fused_qkv_attention_reference,
)
from ssl4polyp_tpu_torch.training import classification, pretrain
from tests.test_torch_finetune import _jax_augment, _numpy_params, _torch_params

# The attention function against the interpret-mode JAX kernels.  fp32: the
# same algorithm, summation order only.  bf16: both round the scale fold,
# the scores (softmax_f32 False), the weights, dS and the outputs at the same
# points, so a rounding that flips on an fp32 order difference moves an
# output by one bf16 ulp (2^-8 relative) and dQ or dK by |k| or |q| times one
# ulp of dS; dbias is the fp32 sum of those over every row, held against its
# largest value (as in test_torch_qkv_attention.py).
F32_TOL = 2e-5
BF16_TOL = 1.6e-2
BWD_F32_TOL = 1e-4
BWD_BF16_TOL = 2e-2


def _inputs(seed, B, N, H, hd):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B, N, 3 * H * hd)).astype(np.float32)
    bias = (0.5 * rng.standard_normal(3 * H * hd)).astype(np.float32)
    dout = rng.standard_normal((B, N, H * hd)).astype(np.float32)
    return qkv, bias, dout


def _jax_vjp(qkv, bias, dout, H, softmax_f32, valid_len, dtype):
    fn = (lambda a, b: jax_bias_attention(a, b, H, True, softmax_f32, valid_len)) \
        if bias is not None else (lambda a: jax_attention(a, H, True, softmax_f32, valid_len))
    args = [jnp.asarray(qkv, dtype)] + ([] if bias is None else [jnp.asarray(bias, dtype)])
    out, vjp = jax.vjp(fn, *args)
    grads = vjp(jnp.asarray(dout, dtype))
    as_np = [np.asarray(x.astype(jnp.float32)) for x in (out, *grads)]
    return as_np[0], as_np[1], None if bias is None else as_np[2]


def _torch_plain(qkv, bias, dout, H, softmax_f32, valid_len, dtype):
    q = torch.from_numpy(qkv).to(dtype)
    b = None if bias is None else torch.from_numpy(bias).to(dtype)
    out = fused_qkv_attention_reference(q, H, softmax_f32, valid_len, b)
    dqkv, dbias = fused_qkv_attention_backward_reference(
        q, torch.from_numpy(dout).to(dtype), H, softmax_f32, valid_len, b)
    return (out.float().numpy(), dqkv.float().numpy(),
            None if dbias is None else dbias.float().numpy())


# (N, heads, head dim, valid_len, bias): one token past 256 and a ragged
# count, with all keys and with keys cut below N, at hd 32 (whose bf16 scale
# fold rounds) and 64.
# Then the edges of the card forward's 128-row query blocks: a whole block of
# 384 rows at hd 16 with keys cut inside a tile, one row past it at hd 64,
# and one row past five blocks at hd 32.
@pytest.mark.parametrize("N, H, hd, valid_len, with_bias", [
    (257, 2, 64, None, True),
    (257, 2, 32, 200, False),
    (290, 2, 32, None, False),
    (290, 1, 64, 289, True),
    (384, 1, 16, 300, True),
    (385, 1, 64, None, False),
    (641, 1, 32, None, True),
])
@pytest.mark.parametrize("softmax_f32", [True, False], ids=["f32-scores", "bf16-scores"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_attention_past_256_tokens_matches_the_jax_kernels(N, H, hd, valid_len, with_bias,
                                                           softmax_f32, dtype):
    qkv, bias, dout = _inputs(N + hd, 1, N, H, hd)
    bias = bias if with_bias else None
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ours = _torch_plain(qkv, bias, dout, H, softmax_f32, valid_len, dtype)
    ref = _jax_vjp(qkv, bias, dout, H, softmax_f32, valid_len, jdt)
    f32 = dtype == torch.float32
    tol = F32_TOL if f32 else BF16_TOL
    np.testing.assert_allclose(ours[0], ref[0], rtol=tol, atol=tol, err_msg="out")
    tol = BWD_F32_TOL if f32 else BWD_BF16_TOL
    for name, a, b in zip(("dqkv", "dbias"), ours[1:], ref[1:]):
        if b is None:
            assert a is None
            continue
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol * scale, err_msg=name)


# A tiny ViT with more than 256 tokens: patch 4 at 68 px is 17 x 17 patches
# and the class token, 290 tokens; D 64, 2 blocks, 2 heads of 32.
TINY = dict(img_size=68, patch_size=4, embed_dim=64, depth=2, num_heads=2)
# As test_torch_vit.py's: fp32 the same math in another order through two
# blocks; bf16 a few ulps where XLA keeps fused chains in fp32.
LOGITS_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
# One fine-tune step in fp32, as test_torch_finetune.py's: summation orders
# and the JAX GELU's polynomial erf (max error 2.2e-6).
STEP_LOSS_RTOL = 1e-5
STEP_GRAD_RTOL = 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_vit_past_256_tokens_matches_jax(dtype):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jcfg = jax_vit.ViTConfig(pos_embed="learned", num_classes=2, compute_dtype=jdt, **TINY)
    params = jax.tree_util.tree_map(np.asarray, jax_vit.init_vit(jax.random.PRNGKey(0), jcfg))
    cfg = ViTConfig(pos_embed="learned", num_classes=2, compute_dtype=dtype, **TINY)
    assert cfg.num_patches + 1 == 290
    model = ViT(cfg, torch.Generator().manual_seed(0))
    model.load_state_dict(state_dict_from_jax(params, cfg))
    images = np.random.default_rng(1).standard_normal((2, 68, 68, 3)).astype(np.float32)
    ref = np.asarray(jax_vit.vit_forward(params, jnp.asarray(images), jcfg))
    with torch.inference_mode():
        ours = model(torch.from_numpy(images)).numpy()
    assert ours.shape == (2, 2) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, rtol=LOGITS_TOL[dtype], atol=LOGITS_TOL[dtype])


def test_finetune_step_past_256_tokens_matches_jax():
    jax_clf = jax_factory.get_imagenet_or_random_vit(
        jax.random.PRNGKey(0), pos_embed="learned", compute_dtype=jnp.float32, **TINY)
    params = jax.tree_util.tree_map(np.asarray, jax_clf.params)
    ours = build_classifier(torch.Generator().manual_seed(0), {}, jax_params=params, device="cpu",
                            pos_embed="learned", compute_dtype=torch.float32, **TINY)
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
    np.testing.assert_allclose(loss.item(), float(want), rtol=STEP_LOSS_RTOL)
    want_grads = {k: v.numpy() for k, v in state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, want_grads), ours.cfg).items()}
    assert set(grads) == set(want_grads)
    for name, g in grads.items():
        w = want_grads[name]
        scale = max(1e-3, float(np.abs(w).max()))
        err = float(np.abs(g.numpy() - w).max()) / scale
        assert err < STEP_GRAD_RTOL, f"gradient of {name} off by {err:.2e} of its scale"


# A tiny MAE whose decoder runs 290 tokens (the encoder keeps 72 of the 289
# patches and the class token); the decoder 32 wide, 1 block of 2 heads.
MAE_ENCODER = dict(img_size=68, patch_size=4, embed_dim=64, depth=2, num_heads=4)
MAE_DECODER = dict(decoder_embed_dim=32, decoder_depth=1, decoder_num_heads=2, mask_ratio=0.75)
# As test_torch_mae.py's: fp32 another order; bf16 the JAX XLA path's bf16
# softmax with the scale on the scores against the kernel's recipe, and
# XLA's fused chains, a few bf16 ulps through 3 blocks.
MAE_LOSS_RTOL = {torch.float32: 1e-6, torch.bfloat16: 1e-3}
MAE_GRAD_RTOL = {torch.float32: 1e-5, torch.bfloat16: 5e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_mae_step_with_a_decoder_past_256_tokens_matches_jax(dtype):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    f32 = dtype == torch.float32
    jcfg = jax_mae.MAEConfig(
        encoder=jax_vit.ViTConfig(compute_dtype=jdt, attention_softmax_f32=f32, **MAE_ENCODER),
        **MAE_DECODER)
    params = jax.tree_util.tree_map(np.asarray, jax_mae.init_mae(jax.random.PRNGKey(0), jcfg))
    cfg = MAEConfig(encoder=ViTConfig(compute_dtype=dtype, attention_softmax_f32=f32,
                                      **MAE_ENCODER), **MAE_DECODER)
    assert (1 + cfg.encoder.num_patches, 1 + cfg.len_keep) == (290, 73)
    model = MAE(cfg, torch.Generator().manual_seed(0))
    model.load_state_dict(mae_state_dict_from_jax(params, cfg))
    B, L = 2, cfg.encoder.num_patches
    images = np.random.default_rng(3).integers(0, 256, (B, 68, 68, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(5)
    noise = np.array(jax.random.uniform(key, (B, L)))

    def jax_loss(p):
        x = jax_normalize(jnp.asarray(images), jcfg.encoder.compute_dtype)
        return jax_mae.mae_forward(p, x, key, jcfg)[0]

    ref_loss, ref_grads = jax.value_and_grad(jax_loss)(params)
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


def test_vit_b16_at_384_px_configures_577_tokens_on_the_default_route(monkeypatch):
    # The configuration the card runs at 384 px, without building weights:
    # 577 tokens, counted as padded to 584 (a multiple of 8, so the fusion
    # knobs and the projection fold apply where the JAX package honours
    # them); the MAE's encoder at 145 tokens, its decoder at 577.
    monkeypatch.delenv("BENCH_ATTN_PROJ", raising=False)
    cfg = factory._vit_b(2, "cls", "learned", img_size=384, pad_tokens_to=None)
    assert (cfg.num_patches + 1, cfg.pad_tokens_to) == (577, 584)
    for fusion, qkv_ln in (("fc1", False), ("full", False), ("full_ln", True)):
        assert layers.block_route(577, 584, 768, fusion, qkv_ln) == (fusion, qkv_ln, False)
    monkeypatch.setenv("BENCH_ATTN_PROJ", "1")
    assert layers.block_route(577, 584, 768, None, False) == ("fc1", False, True)
    mae = pretrain.model_config(pretrain.PretrainSettings(image_size=384))
    assert (1 + mae.len_keep, 1 + mae.encoder.num_patches, mae.decoder_pad_to) == (145, 577, 584)


class _StubLibrary:
    """Records the entry point each launch reached and its arguments;
    launches nothing."""

    def __init__(self):
        self.called, self.args = [], []

    def __getattr__(self, name):
        if not name.startswith("ssl4polyp_"):
            raise AttributeError(name)

        def entry(*args):
            self.called.append(name)
            self.args.append(args)
            return 0
        return entry


@pytest.fixture
def stub(monkeypatch):
    library = _StubLibrary()
    monkeypatch.setattr(_build, "library", lambda: library)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("Stream", (), {"cuda_stream": 0})())
    saved = {(module, name): getattr(module, name) for module, name in ops._COUNTERS.values()}
    ops.reset_launch_counts()
    yield library
    for (module, name), value in saved.items():
        setattr(module, name, value)


def _bf16(shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("N, tiles", [(256, False), (257, True), (577, True)])
def test_bf16_wrappers_send_more_than_256_tokens_to_the_key_tiles(stub, N, tiles):
    H, hd = 12, 64
    qkv, bias, dout = _bf16((2, N, 3 * H * hd)), _bf16(3 * H * hd), _bf16((2, N, H * hd))
    qkv_attention._check(qkv, H, N - 1, bias)
    qkv_attention._forward_kernel(qkv, H, True, N - 1, bias)
    qkv_attention._backward_kernel(qkv, dout, H, True, N - 1, bias, scaled_ds=True)
    counts = ops.launch_counts()
    names = ("fused_qkv_attention_tiles", "fused_qkv_attention_tiles_backward") if tiles else (
        "fused_qkv_attention", "fused_qkv_attention_backward")
    statistics = int(tiles)  # the key tiles' backward launches their statistics pass
    assert counts["qkv_attention_tiles_statistics"] == statistics
    assert [counts[n] for n in names] == [1, 1] and sum(counts.values()) == 2 + statistics
    # The forward through the library's one entry point, which routes N > 256
    # to the key tiles; the backward straight to them, with its scratch.
    bwd = "ssl4polyp_qkv_attention_tiles_bwd" if tiles else "ssl4polyp_qkv_attention_bwd_mode"
    assert stub.called == ["ssl4polyp_qkv_attention_fwd", bwd]
    assert stub.args[0][3:8] == (2, N, H, hd, N - 1)
    if tiles:
        # (qkv, bias, dout, dqkv, stats, dq_acc, part, dbias, B, N, H, hd,
        # n_valid, scale_c, scale, softmax_f32, mode, stream)
        assert all(isinstance(p, int) and p for p in stub.args[1][:8])
        assert stub.args[1][8:13] == (2, N, H, hd, N - 1)
        assert stub.args[1][13] == 0.125 and stub.args[1][15:17] == (1, 1)
        with pytest.raises(ValueError, match="no probe bits"):
            qkv_attention._backward_kernel(qkv, dout, H, True, None, bias,
                                           probe=qkv_attention.PROBE_NO_PHASE_B)
    assert len(stub.called) == 2


# The bf16 wrappers of attention with the projection (row 9/9b) and the QKV
# projection with attention (row 10/10b): one entry point a direction at
# every N, which runs the fused kernels up to 256 tokens and the
# compositions on the key tiles past them; the wrappers count the two apart.
# Each entry point's argument list, from csrc/:
#   ssl4polyp_attn_proj_fwd (qkv, w, b, o, out, B, N, H, hd, n_valid, scale,
#     softmax_f32, ablate, stream);
#   ssl4polyp_attn_proj_bwd (11 pointers, stats, dq_acc, B, N, H, hd, n_valid,
#     scale_c, scale, softmax_f32, slices, phases, stream);
#   ssl4polyp_qkvproj_attention_fwd_probe (x, w, b, w_t, qkv, out, B, N, Din, H,
#     hd, n_valid, scale_c, softmax_f32, probe, stream);
#   ssl4polyp_qkvproj_attention_bwd_probe (12 pointers, stats, dq_acc, B, N, Din, H,
#     hd, n_valid, scale_c, scale, softmax_f32, slices, probe, stream).
# Past 256 tokens the wrappers hand over the compositions' scratch (o; w_t
# and qkv; the key tiles' stats and dq_acc); up to 256 those are null.
@pytest.mark.parametrize("N, tiles", [(256, False), (257, True), (577, True)])
def test_bf16_rows_9_and_10_send_more_than_256_tokens_to_the_key_tiles(stub, monkeypatch, N,
                                                                       tiles):
    monkeypatch.setattr(stub, "ssl4polyp_dw_product_slices", lambda *args: 2, raising=False)
    H, hd = 12, 64
    D = H * hd
    qkv, w, b, dy = _bf16((2, N, 3 * D)), _bf16((D, D)), _bf16(D), _bf16((2, N, D))
    attn_proj._check(qkv, w, b, H, N - 1)
    attn_proj._forward_kernel(qkv, w, b, H, True, N - 1)
    attn_proj._backward_kernel(qkv, w, b, dy, H, True, N - 1)
    x, w3, b3 = _bf16((2, N, D)), _bf16((D, 3 * D)), _bf16(3 * D)
    attention_block._check(x, w3, b3, H, N - 1)
    attention_block._forward_kernel(x, w3, b3, H, False, N - 1)
    attention_block._backward_kernel(x, w3, b3, dy, H, False, N - 1)
    names = (("fused_attention_proj_tiles", "fused_attention_proj_tiles_backward",
              "fused_qkvproj_attention_tiles", "fused_qkvproj_attention_tiles_backward")
             if tiles else ("attn_proj", "attn_proj_backward", "fused_qkvproj_attention",
                            "fused_qkvproj_attention_backward"))
    counts = ops.launch_counts()
    assert counts["qkv_attention_tiles_statistics"] == 2 * int(tiles)
    assert [counts[n] for n in names] == [1, 1, 1, 1] and sum(counts.values()) == 4 + 2 * int(
        tiles)
    assert stub.called == ["ssl4polyp_attn_proj_fwd", "ssl4polyp_attn_proj_bwd",
                           "ssl4polyp_qkvproj_attention_fwd_probe",
                           "ssl4polyp_qkvproj_attention_bwd_probe"]
    shape9, shape10 = (2, N, H, hd, N - 1), (2, N, D, H, hd, N - 1)
    # The forwards: the scratch pointers past 256 tokens (the core output;
    # W^T and qkv), none up to them; softmax_f32 as asked, no measurement bits.
    assert all(isinstance(p, int) and p for p in stub.args[0][:3] + stub.args[0][4:5])
    assert all(isinstance(p, int) and p for p in stub.args[2][:3] + stub.args[2][5:6])
    for scratch in (stub.args[0][3:4], stub.args[2][3:5]):
        assert all(isinstance(p, int) and p for p in scratch) if tiles else set(scratch) == {None}
    assert stub.args[0][5:10] == shape9 and stub.args[0][11:13] == (1, 0)
    assert stub.args[2][6:12] == shape10 and stub.args[2][13:15] == (0, 0)
    # The backwards: the same entry points at every N, every phase or step.
    assert stub.args[1][13:18] == shape9 and stub.args[1][21:23] == (2, 15)
    assert stub.args[3][14:20] == shape10 and stub.args[3][23:25] == (2, 0)
    for args in (stub.args[1][11:13], stub.args[3][12:14]):
        assert all(isinstance(p, int) and p for p in args) if tiles else args == (None, None)
    if tiles:  # nothing past 256 tokens takes a measurement aid
        with pytest.raises(ValueError, match="no ablate bits"):
            attn_proj._forward_kernel(qkv, w, b, H, True, None, ablate=1)
        with pytest.raises(ValueError, match="no probe bits"):
            attention_block._forward_kernel(x, w3, b3, H, True, None,
                                            attention_block.PROBE_FIRST_DESIGN)
        with pytest.raises(ValueError, match="first design"):
            attention_block._backward_kernel(x, w3, b3, dy, H, True, None,
                                             attention_block.BACKWARD_PROBE_FIRST_DESIGN)
    assert len(stub.called) == 4


def test_rows_9_10_11_still_refuse_more_than_256_tokens_in_bf16(stub):
    # No bf16 kernel refuses more than 256 tokens any longer: rows 1/2, 9, 10
    # and 11 (attention over separate q, k, v, the last to take them) take
    # any count.  What still refuses is a head dim no kernel takes, naming
    # its ROADMAP.md item, and no token at all.
    H, hd = 2, 64
    D = H * hd
    for n in (257, 577, 1025):
        qkv_attention._check(_bf16((1, n, 3 * D)), H, None, _bf16(3 * D))
        attn_proj._check(_bf16((1, n, 3 * D)), _bf16((D, D)), _bf16(D), H, None)
        attention_block._check(_bf16((1, n, D)), _bf16((D, 3 * D)), _bf16(3 * D), H, None)
        q = _bf16((1, H, n, hd))
        attention._check(q, q.clone(), q.clone())
    q = _bf16((1, H, 577, 80))
    with pytest.raises(ValueError, match="ROADMAP.md §2a, item 4") as refusal:
        attention._check(q, q.clone(), q.clone())
    assert "head dim" in str(refusal.value)
    q = _bf16((1, H, 0, hd))
    with pytest.raises(ValueError, match="1 or more tokens"):
        attention._check(q, q.clone(), q.clone())
    with pytest.raises(ValueError, match="at least one token"):
        attn_proj._check(_bf16((1, 0, 3 * D)), _bf16((D, D)), _bf16(D), H, None)
    with pytest.raises(ValueError, match="at least one token"):
        attention_block._check(_bf16((1, 0, D)), _bf16((D, 3 * D)), _bf16(3 * D), H, None)
    # In fp32 the fold and the QKV projection with attention take them too.
    N, f32 = 300, torch.float32
    attn_proj._check(torch.zeros((1, N, 3 * D)), torch.zeros((D, D)), torch.zeros(D), H, None)
    attention_block._check(torch.zeros((1, N, D)), torch.zeros((D, 3 * D)),
                           torch.zeros(3 * D, dtype=f32), H, None)
    assert stub.called == []


# Attention over separate q, k, v (row 11): the entry point each dtype and
# token count reaches, with its arguments, from csrc/:
#   ssl4polyp_attention_fwd_probe (q, k, v, out, B * H, N, hd, scale, probe, stream);
#   ssl4polyp_attention_bwd_probe (q, k, v, dout, dq, dk, dv, B * H, N, hd, scale,
#     probe, stream);
#   ssl4polyp_attention_tiles_fwd (q, k, v, out, B, H, N, hd, scale, stream);
#   ssl4polyp_attention_tiles_bwd (q, k, v, dout, dq, dk, dv, stats, dq_acc, B, H, N,
#     hd, scale, stream);
#   ssl4polyp_attention_fwd_f32 (q, k, v, out, lse, B, H, N, hd, scale, stream);
#   ssl4polyp_attention_bwd_f32 (q, k, v, dout, out, lse, delta, dq, dk, dv, B, H, N,
#     hd, scale, forward_first, stream).
_SEPARATE_ROUTES = {
    "bf16": ("ssl4polyp_attention_fwd_probe", "ssl4polyp_attention_bwd_probe",
             "fused_attention", "fused_attention_backward"),
    "tiles": ("ssl4polyp_attention_tiles_fwd", "ssl4polyp_attention_tiles_bwd",
              "fused_attention_tiles", "fused_attention_tiles_backward"),
    "f32": ("ssl4polyp_attention_fwd_f32", "ssl4polyp_attention_bwd_f32",
            "fused_attention_f32", "fused_attention_backward_f32"),
}


@pytest.mark.parametrize("dtype, N, hd, route", [
    (torch.bfloat16, 256, 64, "bf16"), (torch.bfloat16, 257, 64, "tiles"),
    (torch.bfloat16, 577, 16, "tiles"), (torch.bfloat16, 1025, 32, "tiles"),
    (torch.float32, 1, 32, "f32"), (torch.float32, 197, 64, "f32"),
    (torch.float32, 577, 64, "f32"),
], ids=["bf16-256", "bf16-257", "bf16-577", "bf16-1025", "fp32-1", "fp32-197", "fp32-577"])
def test_fused_attention_routes_by_dtype_and_token_count(stub, monkeypatch, dtype, N, hd, route):
    # Through autograd, as a caller reaches them: one forward and one backward
    # launch of the route's kernels, counted under its names, with the shape
    # and scale arguments each entry point takes and the scratch it needs.
    allocated = []
    empty = torch.empty

    def recording_empty(*shape, **kwargs):
        t = empty(*shape, **kwargs)
        allocated.append((tuple(t.shape), t.dtype))
        return t

    monkeypatch.setattr(torch, "empty", recording_empty)
    B, H = 2, 3
    leaves = [torch.zeros((B, H, N, hd), dtype=dtype).requires_grad_() for _ in range(3)]
    attention._check(*leaves)
    out = attention._Attention.apply(*leaves, False)
    out.backward(torch.ones_like(out))
    fwd_name, bwd_name, fwd_count, bwd_count = _SEPARATE_ROUTES[route]
    assert stub.called == [fwd_name, bwd_name]
    counts = ops.launch_counts()
    statistics = int(route == "tiles")  # the key tiles' backward's statistics pass
    assert counts["qkv_attention_tiles_statistics"] == statistics
    assert counts[fwd_count] == counts[bwd_count] == 1 and sum(counts.values()) == 2 + statistics
    fwd, bwd = stub.args
    scale = 1.0 / math.sqrt(hd)  # the fp32 1/sqrt(hd), as ctypes passes it
    assert all(isinstance(p, int) and p for p in fwd[:4]) and fwd[3] == out.data_ptr()
    assert all(isinstance(p, int) and p for p in bwd[:7])
    if route == "bf16":
        assert fwd[4:9] == (B * H, N, hd, scale, 0) and bwd[7:12] == (B * H, N, hd, scale, 0)
        assert allocated == []
    elif route == "tiles":
        assert fwd[4:9] == (B, H, N, hd, scale) and bwd[9:14] == (B, H, N, hd, scale)
        assert all(isinstance(p, int) and p for p in bwd[7:9])
        # Each row's (max, 1/sum, tmp) and dQ's fp32 sums in key-tile order.
        assert allocated == [((B, H, N, 4), torch.float32), ((B, H, N, hd), torch.float32)]
    else:
        # The forward writes the log-sum-exp; the backward reads it and the
        # output (arguments 4 and 5) with a delta scratch, and runs no forward.
        assert fwd[4] is not None and fwd[5:10] == (B, H, N, hd, scale)
        assert bwd[4] == fwd[3] and bwd[5] == fwd[4] and bwd[6] is not None
        assert bwd[10:16] == (B, H, N, hd, scale, 0)
        assert allocated == [((B, H, N), torch.float32), ((B, H, N), torch.float32)]
    assert len(stub.called) == 2


@pytest.mark.parametrize("N", [257, 577])
def test_separate_attention_tiles_and_fp32_take_no_probe_bits(stub, N):
    # The measurement aids of attention.cu's kernels exist only up to 256
    # tokens in bf16: past them, and in fp32, a probe bit is refused before
    # any launch.
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.zeros((1, 2, N, 64), dtype=dtype)
        with pytest.raises(ValueError, match="has no probe bits"):
            attention._forward_kernel(q, q, q, attention.PROBE_FIRST_DESIGN)
        with pytest.raises(ValueError, match="has no probe bits"):
            attention._backward_kernel(q, q, q, q, attention.BACKWARD_PROBE_FIRST_DESIGN)
    with pytest.raises(ValueError, match="fp32 backward kernel only"):
        q = _bf16((1, 2, N, 64))
        attention._backward_kernel(q, q, q, q, out=q, lse=q)
    assert stub.called == []


def test_key_tiles_probe_is_bound_and_no_route_takes_it(stub):
    # The key tiles' first design, their statistics pass alone and the
    # separate layout are reached only through their probe entry point: it
    # is bound with its argument list, every route past 256 tokens reaches
    # the library through its own entry points, and the probe counts no
    # launch.
    bound = {name: argtypes for name, _, argtypes in _build._ENTRY_POINTS}
    assert bound["ssl4polyp_qkv_attention_tiles_fwd_probe"] == (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    H, hd, N = 2, 64, 577
    D = H * hd
    qkv, bias, dout = _bf16((2, N, 3 * D)), _bf16(3 * D), _bf16((2, N, D))
    qkv_attention._forward_kernel(qkv, H, True, None, bias)
    qkv_attention._backward_kernel(qkv, dout, H, True, None, bias)
    attn_proj._forward_kernel(qkv, _bf16((D, D)), _bf16(D), H, True, None)
    x = _bf16((2, N, D))
    attention_block._forward_kernel(x, _bf16((D, 3 * D)), bias, H, False, None)
    q = _bf16((2, H, N, hd))
    attention._forward_kernel(q, q, q)
    attention._backward_kernel(q, q, q, q)
    assert "ssl4polyp_qkv_attention_tiles_fwd_probe" not in stub.called
    assert len(stub.called) == 6
    ops.reset_launch_counts()
    for probe in (0, qkv_attention.TILES_PROBE_FIRST_DESIGN):
        out = qkv_attention.tiles_probe(qkv, H, False, 500, bias, probe)
        assert out.shape == (2, N, D)
    stats = qkv_attention.tiles_probe(qkv, H, True, None, None,
                                      qkv_attention.TILES_PROBE_STATISTICS, dout=dout)
    assert stats.shape == (2, H, N, 4) and stats.dtype == torch.float32
    separate = qkv_attention.TILES_PROBE_SEPARATE | qkv_attention.TILES_PROBE_STATISTICS
    qkv_attention.tiles_probe(q, H, True, None, None, separate, k=q, v=q, dout=q)
    assert stub.called[6:] == ["ssl4polyp_qkv_attention_tiles_fwd_probe"] * 4
    # (q, k, v, bias, dout, out, stats, B, N, H, hd, n_valid, scale, softmax_f32,
    # probe, stream)
    args = stub.args[6:]
    assert args[0][1:3] == (None, None) and args[0][4] is None and args[0][6] is None
    assert args[0][7:15] == (2, N, H, hd, 500, 0.125, 0, 0)
    assert args[1][14] == qkv_attention.TILES_PROBE_FIRST_DESIGN
    assert args[2][3] is None and args[2][5] is None and args[2][7:15] == (
        2, N, H, hd, N, 0.125, 1, qkv_attention.TILES_PROBE_STATISTICS)
    assert all(isinstance(p, int) and p for p in args[3][:3] + args[3][4:5] + args[3][6:7])
    assert args[3][7:15] == (2, N, H, hd, N, 1.0 / math.sqrt(hd), 1, separate)
    assert set(ops.launch_counts().values()) == {0}
    with pytest.raises(ValueError, match="unknown probe bits"):
        qkv_attention.tiles_probe(qkv, H, True, None, bias, 8)
    with pytest.raises(ValueError, match="separate layout"):
        qkv_attention.tiles_probe(q, H, True, None, bias, qkv_attention.TILES_PROBE_SEPARATE,
                                  k=q, v=q)
    with pytest.raises(ValueError, match="dout"):
        qkv_attention.tiles_probe(qkv, H, True, None, bias,
                                  qkv_attention.TILES_PROBE_STATISTICS, dout=q)
    assert len(stub.called) == 10


@pytest.mark.parametrize("softmax_f32", [True, False], ids=["f32-scores", "bf16-scores"])
@pytest.mark.parametrize("valid_len", [None, 300])
def test_tiles_statistics_reference_is_the_backward_references_softmax(softmax_f32, valid_len):
    # The plain statistics (max * log2(e), 1/sum, tmp) that the card's
    # statistics pass is held against, in fp64 from the plain backward's own
    # scores and weights, at 385 tokens in both layouts.
    qkv, bias, dout = _inputs(5, 2, 385, 2, 32)
    q = torch.from_numpy(qkv).to(torch.bfloat16)
    b = torch.from_numpy(bias).to(torch.bfloat16)
    d = torch.from_numpy(dout).to(torch.bfloat16)
    got = qkv_attention.tiles_statistics_reference(q, d, 2, softmax_f32, valid_len, b).double()
    x = (q + b).double().reshape(2, 385, 3, 2, 32).permute(2, 0, 3, 1, 4)
    scale = qkv_attention._scale(32, torch.bfloat16)
    qs = ((q + b) * torch.tensor(scale, dtype=torch.bfloat16)).double().reshape(
        2, 385, 3, 2, 32).permute(2, 0, 3, 1, 4)[0]
    scores = qs @ x[1].transpose(-1, -2)
    if valid_len is not None:
        scores[..., valid_len:] = float("-inf")
    if not softmax_f32:
        scores = scores.to(torch.bfloat16).double()
    top = scores.amax(-1)
    w = torch.softmax(scores, -1)
    dw = d.double().reshape(2, 385, 2, 32).permute(0, 2, 1, 3) @ x[2].transpose(-1, -2)
    want = torch.stack([top * math.log2(math.e), 1 / torch.exp(scores - top[..., None]).sum(-1),
                        (dw * w).sum(-1), torch.zeros_like(top)], -1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    qh, kh, vh = (t.contiguous() for t in x.to(torch.bfloat16))
    dh = d.reshape(2, 385, 2, 32).permute(0, 2, 1, 3).contiguous()
    sep = qkv_attention.tiles_statistics_reference(qh, dh, 2, k=kh, v=vh).double()
    scores = qh.double() @ kh.double().transpose(-1, -2) / math.sqrt(32)
    w = torch.softmax(scores, -1)
    want = torch.stack([scores.amax(-1) * math.log2(math.e),
                        1 / torch.exp(scores - scores.amax(-1, keepdim=True)).sum(-1),
                        ((dh.double() @ vh.double().transpose(-1, -2)) * w).sum(-1),
                        torch.zeros_like(w[..., 0])], -1)
    torch.testing.assert_close(sep, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("share, plain_off, ok", [
    (0.5, 0.03, True), (0.95, 0.03, True), (1.05, 0.03, False), (0.0, 0.0, True),
])
def test_long_logits_check_holds_the_kernels_to_the_plain_paths_distance(share, plain_off, ok):
    # chip_smoke.py's 577-token logits check on synthetic logits: the
    # kernels' worst |diff| from the fp32 forward (here `share` of the limit
    # LONG_LOGITS_RATIO times the larger of the plain bf16 paths' worst
    # |diff|, unfolded and folded) passes below the limit and fails above.
    import chip_smoke

    kernel_off = share * chip_smoke.LONG_LOGITS_RATIO * plain_off
    ref = np.random.default_rng(3).standard_normal((128, 2)).astype(np.float32) * 4
    bump = np.zeros_like(ref)
    bump[17, 1] = 1.0
    result = chip_smoke.long_logits_check(ref + kernel_off * bump, ref - 0.5 * plain_off * bump,
                                          ref + plain_off * bump, ref)
    assert result["max_abs_diff"] == pytest.approx(kernel_off, abs=1e-6)
    assert result["plain_max_abs_diff"] == pytest.approx(plain_off, abs=1e-6)
    assert result["ok"] is ok
    if plain_off:
        assert result["ratio"] == pytest.approx(kernel_off / plain_off, rel=1e-4)
        share = chip_smoke.limit_share(torch.from_numpy(ref + kernel_off * bump),
                                       torch.from_numpy(ref), chip_smoke.LOGITS_TOL)
        assert result["limit_share"] == pytest.approx(share)


def test_the_backward_plan_names_the_key_tiles(stub, monkeypatch):
    def plan(N, hd, warps, smem):
        warps._obj.value, smem._obj.value = 4, 106_496
        return 2 if N > 256 else 1

    monkeypatch.setattr(stub, "ssl4polyp_qkv_attention_bwd_plan", plan, raising=False)
    assert qkv_attention.backward_plan(577, 64) == {"path": "key tiles", "warps": 4,
                                                    "smem_bytes": 106_496}
    assert qkv_attention.backward_plan(197, 64)["path"] == "stored dS"


def test_cpu_tensors_past_256_tokens_take_the_plain_versions():
    qkv, bias, dout = _inputs(11, 1, 290, 2, 32)
    q = torch.from_numpy(qkv).to(torch.bfloat16).requires_grad_()
    b = torch.from_numpy(bias).to(torch.bfloat16).requires_grad_()
    d = torch.from_numpy(dout).to(torch.bfloat16)
    ops.reset_launch_counts()
    out = qkv_attention.fused_qkv_attention(q, 2, False, 280, b)
    out.backward(d)
    assert set(ops.launch_counts().values()) == {0}
    torch.testing.assert_close(out, fused_qkv_attention_reference(q.detach(), 2, False, 280,
                                                                  b.detach()), rtol=0, atol=0)
    dqkv, dbias = fused_qkv_attention_backward_reference(q.detach(), d, 2, False, 280, b.detach())
    torch.testing.assert_close(q.grad, dqkv, rtol=0, atol=0)
    torch.testing.assert_close(b.grad, dbias, rtol=0, atol=0)


"""The dense (DPT) model of the port against the JAX package's.

``vit_tap_features`` (on a stack where the fusion knobs would apply: D 128,
17 tokens padded to 24, ``mlp_fusion="full"``, ``qkv_ln_fusion=True``, and
under ``BENCH_ATTN_PROJ=1``, which the tap path ignores as the JAX one does),
``dpt_forward`` for each readout, the bilinear resize at the decoder's
scales against ``jax.image.resize``, the carry-across of the decoder's
weights, and the whole ``DenseClassifier`` against the JAX one on one numpy
tree.  Small widths, inputs and weights from numpy seeds, the port on its
plain torch path (the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl4polyp_tpu.models import dpt as jax_dpt
from ssl4polyp_tpu.models import factory as jax_factory
from ssl4polyp_tpu.models import vit as jax_vit
from ssl4polyp_tpu_torch.models import factory
from ssl4polyp_tpu_torch.models.dpt import DPT, DPTConfig, TAP_BLOCKS, dpt_forward, resize_bilinear
from ssl4polyp_tpu_torch.models.weights import (
    dpt_state_dict_from_jax,
    jax_from_dpt_state_dict,
    jax_from_state_dict,
    state_dict_from_jax,
)
from ssl4polyp_tpu_torch.profiling import projection_fold
from ssl4polyp_tpu_torch.training.classification import make_forward_fn

# A width where the JAX package would run its flattened stream (D and 3D
# multiples of 128, 17 tokens padded to 24): the knobs would apply there,
# so the taps show that the tap path ignores them.
KNOBS = dict(img_size=32, patch_size=8, embed_dim=128, depth=12, num_heads=4, pad_tokens_to=24,
             mlp_fusion="full", qkv_ln_fusion=True)
DENSE = dict(img_size=32, patch_size=8, embed_dim=64, depth=12, num_heads=4)
# fp32: the same function in two frameworks, summation order and the JAX
# GELU's polynomial erf (max error 2.2e-6) apart, through 12 blocks and the
# decoder's 14 convs: 1e-4 relative to the largest value.
FP32_TOL = 1e-4
# bf16: both round at every op boundary but at different points (XLA keeps
# fused elementwise chains in fp32, the port's fc1 rounds h before the
# GELU), through 12 blocks and the decoder: 5 % of the largest logit.
BF16_TOL = 5e-2
# The resize alone: one contraction of the same fp32 weights.
RESIZE_TOL = {torch.float32: 1e-6, torch.bfloat16: 1e-2}


def close(got: np.ndarray, want: np.ndarray, tol: float) -> None:
    """Every element within ``tol`` times the largest |want|."""
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def jax_tree(params) -> dict:
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("fold", [False, True], ids=["default", "BENCH_ATTN_PROJ=1"])
def test_vit_tap_features_ignore_the_fusion_knobs(fold):
    """The port's taps equal the JAX ``vit_tap_features`` on one tree, while
    the same model's pooled forward runs the knobs' kernels."""
    with projection_fold(fold):
        classifier = factory.build_classifier(torch.Generator().manual_seed(0), {}, device="cpu",
                                              compute_dtype=torch.float32, **KNOBS)
    blocks = classifier.model.blocks
    assert {(b.mlp_route, b.qkv_ln, b.attn.proj_fold) for b in blocks} == {("full", True, fold)}
    jcfg = jax_vit.ViTConfig(**{k: v for k, v in KNOBS.items()
                                if k not in ("mlp_fusion", "qkv_ln_fusion", "pad_tokens_to")},
                             compute_dtype=jnp.float32)
    params = jax_tree(jax_vit.init_vit(jax.random.PRNGKey(1), jcfg))
    classifier.model.load_state_dict(state_dict_from_jax(params, classifier.cfg), strict=False)
    images = np.random.default_rng(2).standard_normal((2, 32, 32, 3)).astype(np.float32)
    want = jax_vit.vit_tap_features(params, jnp.asarray(images), jcfg, taps=TAP_BLOCKS)
    with torch.inference_mode():
        got = classifier.model.vit_tap_features(torch.from_numpy(images), TAP_BLOCKS)
        pooled = classifier.model(torch.from_numpy(images))
    assert pooled.shape == (2, 2)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.shape == (2, 17, 128) and g.dtype == torch.float32
        close(g.numpy(), np.asarray(w), FP32_TOL)


@pytest.mark.parametrize("readout", ["ignore", "add", "project"])
def test_dpt_forward_matches_jax(readout):
    cfg = dict(embed_dim=32, num_classes=2, features=16, grid_size=4, readout=readout)
    tree = jax_tree(jax_dpt.init_dpt(jax.random.PRNGKey(3), jax_dpt.DPTConfig(**cfg)))
    dpt = DPT(DPTConfig(**cfg), torch.Generator().manual_seed(0))
    dpt.load_state_dict(dpt_state_dict_from_jax(tree))
    rng = np.random.default_rng(4)
    taps = [rng.standard_normal((2, 17, 32)).astype(np.float32) for _ in range(4)]
    want = np.asarray(jax_dpt.dpt_forward(tree, [jnp.asarray(t) for t in taps],
                                          jax_dpt.DPTConfig(**cfg)))
    with torch.inference_mode():
        got = dpt_forward(dpt, [torch.from_numpy(t) for t in taps]).numpy()
    assert got.shape == (2, 32, 32, 2)
    close(got, want, FP32_TOL)
    with pytest.raises(ValueError, match="four"):
        dpt_forward(dpt, [torch.from_numpy(t) for t in taps[:3]])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("size, factor", [(14, 0.5), (14, 2.0), (14, 4.0), (7, 2.0), (56, 2.0),
                                          (4, 0.5), (3, 2.0)])
def test_resize_matches_jax_image_resize(size, factor, dtype):
    """The decoder's scales: ½× antialiases (14 -> 7), 2× and 4× renormalise
    the weights that fall off the edge, as ``jax.image.resize`` does."""
    x = np.random.default_rng(5).standard_normal((2, size, size, 3)).astype(np.float32)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    n = max(1, int(round(size * factor)))
    want = np.asarray(jax.image.resize(jnp.asarray(x, jdtype), (2, n, n, 3), method="bilinear"),
                      dtype=np.float32)
    nchw = torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2)
    got = resize_bilinear(nchw, factor)
    assert got.dtype == dtype
    got = got.permute(0, 2, 3, 1).float().numpy()
    close(got, want, RESIZE_TOL[dtype])


def test_dpt_parameters_carry_across_both_ways():
    """The port's DPT has the JAX tree's parameters, shape for shape under
    the (kh, kw, cin, cout) <-> (cout, cin, kh, kw) transpose, and the tree
    round-trips bit for bit."""
    for readout in ("ignore", "project"):
        jcfg = jax_dpt.DPTConfig(embed_dim=64, readout=readout)
        tree = jax_tree(jax_dpt.init_dpt(jax.random.PRNGKey(6), jcfg))
        state = dpt_state_dict_from_jax(tree)
        ours = DPT(DPTConfig(embed_dim=64, readout=readout), torch.Generator().manual_seed(0))
        mine = ours.state_dict()
        assert {k: tuple(v.shape) for k, v in mine.items()} == \
            {k: tuple(v.shape) for k, v in state.items()}
        assert mine["scratch.0.weight"].shape == (256, 96, 3, 3)
        back = jax_from_dpt_state_dict(state)
        assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
        for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    with pytest.raises(ValueError, match="readout"):
        DPT(DPTConfig(readout="bogus"), torch.Generator())


def dense_state_dict_from_jax(params, cfg) -> dict:
    """A JAX ``DenseClassifier``'s ``{"encoder": ..., "dpt": ...}`` tree as
    the state dict of the port's ``DenseModel`` (``encoder.*``, ``dpt.*``)."""
    return {**{f"encoder.{k}": v for k, v in state_dict_from_jax(params["encoder"], cfg).items()},
            **{f"dpt.{k}": v for k, v in dpt_state_dict_from_jax(params["dpt"]).items()}}


def dense_pair(readout: str, dtype: torch.dtype, **overrides):
    """(JAX DenseClassifier, port DenseClassifier) with the same weights."""
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    model_cfg = {"dense": True, "dense_readout": readout}
    theirs = jax_factory.build_classifier(jax.random.PRNGKey(7), model_cfg, compute_dtype=jdtype,
                                          **DENSE, **overrides)
    ours = factory.build_classifier(torch.Generator().manual_seed(0), model_cfg, device="cpu",
                                    compute_dtype=dtype, **DENSE, **overrides)
    ours.model.load_state_dict(dense_state_dict_from_jax(jax_tree(theirs.params), ours.cfg))
    return theirs, ours


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("readout", ["ignore", "add", "project"])
def test_dense_classifier_matches_jax(readout, dtype):
    theirs, ours = dense_pair(readout, dtype)
    assert isinstance(ours, factory.DenseClassifier)
    assert ours.dpt_cfg.readout == readout and ours.scheme == theirs.scheme == "random"
    assert ours.model.encoder.head is None
    assert {n.split(".")[0] for n, _ in ours.model.named_parameters()} == {"encoder", "dpt"}
    images = np.random.default_rng(8).standard_normal((2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(theirs.apply(theirs.params, jnp.asarray(images)))
    with torch.inference_mode():
        got = ours.model(torch.from_numpy(images))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    close(got.numpy(), want, FP32_TOL if dtype == torch.float32 else BF16_TOL)
    back = {"encoder": jax_from_state_dict(ours.model.encoder.state_dict(), ours.cfg),
            "dpt": jax_from_dpt_state_dict(ours.model.dpt.state_dict())}
    want = jax_tree(theirs.params)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(want)):
        assert a.tobytes() == b.tobytes()


def test_dense_classifier_from_a_weight_file_and_through_make_forward_fn(tmp_path):
    """``dense`` on an MAE ``.pth``: the encoder is the file's, the decoder
    fresh; ``make_forward_fn`` serves (B, H/2, W/2, num_classes) fp32 logits
    at patch 16 (H/2 = 16 at 32 px), and the loss's gradients reach both
    parts."""
    import chip_smoke
    from ssl4polyp_tpu_torch.models.mae import MAEConfig, encoder_only
    from ssl4polyp_tpu_torch.models.vit import ViTConfig

    cfg = MAEConfig(encoder=ViTConfig(img_size=32, patch_size=16, embed_dim=64, depth=12,
                                      num_heads=4),
                    decoder_embed_dim=32, decoder_depth=1, decoder_num_heads=2)
    tree = chip_smoke.write_mae_pth(tmp_path / "w" / "mae.pth", cfg, np.random.default_rng(9))
    model_cfg = {"ss_framework": "mae", "key": "ssl_imnet", "checkpoint": "w/mae.pth",
                 "dense": True, "dense_readout": "project"}
    dense = factory.build_classifier(torch.Generator().manual_seed(0), model_cfg,
                                     checkpoint_root=tmp_path, device="cpu",
                                     img_size=32, patch_size=16, embed_dim=64, depth=12,
                                     num_heads=4)
    assert dense.scheme == "ssl_imnet" and dense.dpt_cfg.grid_size == 2
    want = state_dict_from_jax(encoder_only(tree), dense.cfg)
    encoder = dict(dense.model.encoder.named_parameters())
    assert set(encoder) == set(want)
    assert all(torch.equal(encoder[n], t) for n, t in want.items())
    images = np.random.default_rng(10).integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    logits = make_forward_fn(dense, "cpu")()(images)
    assert logits.shape == (3, 16, 16, 2) and logits.dtype == np.float32
    assert np.isfinite(logits).all()
    assert all(p.dtype == torch.float32 for p in dense.model.parameters())

    out = dense.model(torch.from_numpy(images).float() / 255.0)
    out.square().mean().backward()
    grads = {n: p.grad for n, p in dense.model.named_parameters() if p.requires_grad}
    # The final norm is outside the tap path (dense mode skips it), and the
    # deepest fusion stage's first residual unit is built but never run, as
    # in the JAX decoder.
    unused = {"encoder.norm.weight", "encoder.norm.bias",
              *(f"dpt.fusion.3.res1.{conv}.{p}" for conv in ("conv1", "conv2")
                for p in ("weight", "bias"))}
    assert {n for n, g in grads.items() if g is None} == unused
    assert all(torch.isfinite(g).all() for g in grads.values() if g is not None)
    assert grads["dpt.head.conv2.weight"].abs().sum() > 0
    assert grads["encoder.blocks.2.mlp.fc1.weight"].abs().sum() > 0

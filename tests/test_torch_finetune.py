"""The port's fine-tune step against the JAX package, piece by piece and whole.

The augmentation chain, the loss, the fine-tune learning-rate scales, one
step's loss and every gradient against ``jax.value_and_grad`` of the JAX
classifier's loss under each kernel configuration, and a short trajectory
of AdamW steps.  The augmentation parameters are drawn once and handed to
both sides (the two frameworks' generators differ); the JAX side composes
its own augmentation helpers with them, as ``augment_batch`` does.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl4polyp_tpu.data import augment as jax_augment
from ssl4polyp_tpu.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from ssl4polyp_tpu.models import factory as jax_factory
from ssl4polyp_tpu.models import vit as jax_vit
from ssl4polyp_tpu.training import classification as jax_classification
from ssl4polyp_tpu.training import optim as jax_optim
from ssl4polyp_tpu_torch.data.augment import (AugmentParams, apply_augment, augment_batch,
                                              draw_augment_params)
from ssl4polyp_tpu_torch.models.factory import build_classifier
from ssl4polyp_tpu_torch.models.weights import state_dict_from_jax
from ssl4polyp_tpu_torch.training import classification, optim
from ssl4polyp_tpu_torch.training.classification import FinetuneStage, ScheduleRuntime

SHAPES = dict(img_size=32, patch_size=8, embed_dim=128, depth=2, num_heads=4)
CONFIGS = {"fc1": {}, "full_ln+qkv_ln": dict(mlp_fusion="full_ln", qkv_ln_fusion=True),
           "full": dict(mlp_fusion="full")}
B = 6
# The chain in fp32 on both sides: only round-off differs (the contrast mean's
# summation order, erf and sin/cos implementations, 25-tap sums), on
# normalised values of magnitude up to 2.7.
AUGMENT_ATOL = 2e-5
# One fp32 step through two blocks: summation orders, and the JAX GELU's
# polynomial erf (max error 2.2e-6) against the exact one.
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
# Over a few AdamW steps: AdamW divides by sqrt(nu), so an element whose
# gradient is tiny moves by about lr whatever the sign of its round-off.
# The K slice of the qkv bias, whose exact gradient is zero, is left out of
# the parameter comparison (as in test_mae_trajectory_parity.py).
TRAJECTORY_RTOL = 1e-4


def _numpy_params(seed, batch=B):
    rng = np.random.default_rng(seed)
    u = lambda lo, hi: rng.uniform(lo, hi, batch).astype(np.float32)  # noqa: E731
    return {"brightness": u(0.6, 1.4), "contrast": u(0.5, 1.5), "saturation": u(0.75, 1.25),
            "hue": u(-0.01, 0.01), "sigma": u(0.001, 2.0), "hflip": rng.random(batch) < 0.5,
            "vflip": rng.random(batch) < 0.5, "angle": u(-math.pi, math.pi)}


def _torch_params(p) -> AugmentParams:
    return AugmentParams(**{k: torch.from_numpy(np.asarray(v)) for k, v in p.items()})


def _jax_augment(images_u8, p, dtype=jnp.float32):
    """``augment_batch`` with its random draws replaced by ``p``."""
    x = jnp.asarray(images_u8).astype(jnp.float32) / 255.0
    x = jax_augment._adjust_brightness(x, jnp.asarray(p["brightness"]))
    x = jax_augment._adjust_contrast(x, jnp.asarray(p["contrast"]))
    x = jax_augment._adjust_saturation(x, jnp.asarray(p["saturation"]))
    x = jax_augment._adjust_hue(x, jnp.asarray(p["hue"]))
    x = jax_augment._separable_blur(x, jnp.asarray(p["sigma"]))
    x = jnp.where(jnp.asarray(p["hflip"])[:, None, None, None], jnp.flip(x, axis=2), x)
    x = jnp.where(jnp.asarray(p["vflip"])[:, None, None, None], jnp.flip(x, axis=1), x)
    x = jax_augment._rotate_bilinear(x, jnp.asarray(p["angle"]))
    mean = jnp.asarray(IMAGENET_MEAN, dtype=jnp.float32)
    std = jnp.asarray(IMAGENET_STD, dtype=jnp.float32)
    return ((x - mean) / std).astype(dtype)


def _images(seed, batch=B, size=32):
    return np.random.default_rng(seed).integers(0, 256, (batch, size, size, 3), dtype=np.uint8)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_augment_matches_the_jax_chain(seed):
    images, p = _images(seed, size=40), _numpy_params(seed)
    want = np.asarray(_jax_augment(images, p))
    got = apply_augment(torch.from_numpy(images), _torch_params(p))
    assert got.dtype == torch.float32 and got.shape == (B, 40, 40, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=AUGMENT_ATOL)
    # The compute dtype is one cast of the same values.
    bf16 = apply_augment(torch.from_numpy(images), _torch_params(p), torch.bfloat16)
    torch.testing.assert_close(bf16, got.to(torch.bfloat16), rtol=0, atol=0)


def test_draw_augment_params_has_the_jax_ranges():
    gen = torch.Generator().manual_seed(0)
    p = draw_augment_params(4096, gen)
    ranges = {"brightness": (0.6, 1.4), "contrast": (0.5, 1.5), "saturation": (0.75, 1.25),
              "hue": (-0.01, 0.01), "sigma": (0.001, 2.0), "angle": (-math.pi, math.pi)}
    for name, (lo, hi) in ranges.items():
        v = getattr(p, name)
        assert v.shape == (4096,) and v.dtype == torch.float32, name
        assert lo <= v.min().item() and v.max().item() < hi, name
        assert v.min().item() < lo + 0.01 * (hi - lo) and v.max().item() > hi - 0.01 * (hi - lo)
    for name in ("hflip", "vflip"):
        v = getattr(p, name)
        assert v.dtype == torch.bool and abs(v.float().mean().item() - 0.5) < 0.04, name
    # The generator alone decides the draw, and each sample draws its own.
    again = draw_augment_params(4096, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(p, again))
    images = torch.from_numpy(_images(3))
    one = augment_batch(images, torch.Generator().manual_seed(5))
    torch.testing.assert_close(
        one, apply_augment(images, draw_augment_params(B, torch.Generator().manual_seed(5))),
        rtol=0, atol=0)


@pytest.mark.parametrize("num_classes", [2, 3])
def test_loss_from_logits_matches_jax(num_classes):
    rng = np.random.default_rng(num_classes)
    logits = (2 * rng.standard_normal((8, num_classes))).astype(np.float32)
    labels = rng.integers(0, num_classes, 8)
    valid = np.array([True] * 6 + [False] * 2)
    counts = [30, 10, 5][:num_classes]
    mode, pos_weight, class_weights = classification.loss_settings(counts, num_classes)
    assert mode == ("binary_bce" if num_classes == 2 else "multiclass_ce")
    assert pos_weight == (3.0 if num_classes == 2 else 1.0)
    np.testing.assert_allclose(class_weights, [sum(counts) / (num_classes * c) for c in counts])

    def jax_loss(z):
        return jax_classification._loss_from_logits(z, jnp.asarray(labels), jnp.asarray(valid),
                                                    mode, pos_weight, tuple(class_weights))

    want, want_grad = jax.value_and_grad(jax_loss)(jnp.asarray(logits))
    z = torch.from_numpy(logits).requires_grad_()
    got = classification.loss_from_logits(z, torch.from_numpy(labels), torch.from_numpy(valid),
                                          mode, pos_weight, class_weights)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(want_grad), rtol=1e-5, atol=1e-7)
    assert classification.loss_settings([5, 0], 2)[1] == 1.0  # no positives


def _jax_pair(overrides, pos_embed="learned", seed=0):
    """(JAX classifier, its params as numpy, the port's classifier) with the same weights."""
    jax_clf = jax_factory.get_imagenet_or_random_vit(
        jax.random.PRNGKey(seed), pos_embed=pos_embed, compute_dtype=jnp.float32, **SHAPES)
    params = jax.tree_util.tree_map(np.asarray, jax_clf.params)
    ours = build_classifier(torch.Generator().manual_seed(seed), {}, jax_params=params,
                            device="cpu", pos_embed=pos_embed, compute_dtype=torch.float32, **SHAPES,
                            **overrides)
    return jax_clf, params, ours


def _port_names(tree, cfg):
    """A JAX-layout tree of per-leaf values -> the port's names."""
    return {k: v.numpy() for k, v in state_dict_from_jax(tree, cfg).items()}


@pytest.mark.parametrize("mode", ["none", "full", "head+1", "head+2"])
@pytest.mark.parametrize("freeze", [False, True])
def test_finetune_lr_scales_match_the_jax_tree(mode, freeze):
    _, params, ours = _jax_pair({})
    scales = jax_optim.finetune_lr_scales(params, mode, SHAPES["depth"], head_scale=2.0,
                                          backbone_scale=0.5, freeze_pos_embed=freeze)
    full = jax.tree_util.tree_map(lambda p, s: np.broadcast_to(np.asarray(s, np.float32), p.shape),
                                  params, scales)
    want = _port_names(full, ours.cfg)
    got = optim.finetune_lr_scales(dict(ours.model.named_parameters()), mode, SHAPES["depth"],
                                   head_scale=2.0, backbone_scale=0.5, freeze_pos_embed=freeze)
    assert set(got) == set(want)
    for name, scale in got.items():
        np.testing.assert_array_equal(np.unique(want[name]), [scale], err_msg=name)
    with pytest.raises(ValueError):
        optim.finetune_lr_scales(got, "head+3", SHAPES["depth"])


def test_schedule_runtime_matches_jax():
    from ssl4polyp_tpu.training.protocol import FinetuneStage as JaxStage

    _, params, ours = _jax_pair({})
    named = dict(ours.model.named_parameters())
    stages = [("warm", "none", 2, 1e-3, None), ("tail", "head+2", 1, None, 2e-4),
              ("all", "full", 3, 5e-4, 1e-4)]
    jax_rt = jax_classification.ScheduleRuntime(
        tuple(JaxStage(*s) for s in stages), 3e-4, SHAPES["depth"], freeze_pos_embed=True)
    rt = ScheduleRuntime(tuple(FinetuneStage(*s) for s in stages), 3e-4, SHAPES["depth"],
                         freeze_pos_embed=True)
    for epoch in range(8):
        lr, scales, mode, name = jax_rt.lr_and_scales(params, epoch, "full")
        full = jax.tree_util.tree_map(
            lambda p, s: np.broadcast_to(np.asarray(s, np.float32), p.shape), params, scales)
        want = _port_names(full, ours.cfg)
        got_lr, got, got_mode, got_name = rt.lr_and_scales(named, epoch, "full")
        assert (got_lr, got_mode, got_name) == (lr, mode, name)
        for n, scale in got.items():
            np.testing.assert_allclose(np.unique(want[n]), [scale], rtol=1e-6, err_msg=n)
    assert ScheduleRuntime((), 1e-3, 2).lr_and_scales(named, 0, "head+1")[2:] == ("head+1", None)


def _jax_loss_fn(jax_clf, images_u8, p, labels, valid, loss_args):
    def loss_fn(params):
        logits = jax_clf.apply(params, _jax_augment(images_u8, p))
        return jax_classification._loss_from_logits(logits, jnp.asarray(labels),
                                                     jnp.asarray(valid), *loss_args)
    return loss_fn


def _assert_grads_close(got, want, what):
    for name, g in got.items():
        w = want[name]
        scale = max(1e-3, float(np.abs(w).max()))
        err = float(np.abs(g.numpy() - w).max()) / scale
        assert err < GRAD_RTOL, f"{what}: gradient of {name} off by {err:.2e} of its scale"


def _check_one_step(config, pos_embed, fold=False):
    jax_clf, params, ours = _jax_pair(CONFIGS[config], pos_embed)
    expected_route = {"fc1": ("fc1", False), "full_ln+qkv_ln": ("full_ln", True),
                      "full": ("full", False)}[config]
    assert all((b.mlp_route, b.qkv_ln, b.attn.proj_fold) == (*expected_route, fold)
               for b in ours.model.blocks)
    images, p = _images(4), _numpy_params(4)
    labels = np.array([0, 1, 1, 0, 1, 0])
    valid = np.array([True] * 5 + [False])
    loss_args = classification.loss_settings([40, 20])
    ctx = classification.TrainContext(ours, *loss_args, weight_decay=0.05)
    state = classification.init_train_state(ours, torch.Generator().manual_seed(0))
    loss, grads = classification.loss_and_grads(
        ctx, state, torch.from_numpy(images), torch.from_numpy(labels), torch.from_numpy(valid),
        _torch_params(p))
    want, want_grads = jax.value_and_grad(
        _jax_loss_fn(jax_clf, images, p, labels, valid, loss_args))(
            jax.tree_util.tree_map(jnp.asarray, params))
    np.testing.assert_allclose(loss.item(), float(want), rtol=LOSS_RTOL)
    want_grads = _port_names(jax.tree_util.tree_map(np.asarray, want_grads), ours.cfg)
    assert set(grads) == set(want_grads)
    _assert_grads_close(grads, want_grads, config)


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("pos_embed", ["learned", "sincos"])
def test_one_step_loss_and_gradients_match_jax(config, pos_embed, monkeypatch):
    monkeypatch.delenv("BENCH_ATTN_PROJ", raising=False)
    _check_one_step(config, pos_embed)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_one_step_under_the_projection_fold_matches_jax(config, monkeypatch):
    # BENCH_ATTN_PROJ=1: every block's attention and projection (and their
    # gradients, proj.weight's and proj.bias's among them) come from
    # fused_attention_proj; the model's function is the same.
    monkeypatch.setenv("BENCH_ATTN_PROJ", "1")
    _check_one_step(config, "learned", fold=True)


def test_short_trajectory_matches_jax():
    """Four steps of ``make_train_step`` (head+2 scales, weight decay) against
    the JAX step's math: value_and_grad, then ``adamw_update``."""
    overrides = CONFIGS["full_ln+qkv_ln"]
    jax_clf, params, ours = _jax_pair(overrides)
    loss_args = classification.loss_settings([40, 20])
    ctx = classification.TrainContext(ours, *loss_args, weight_decay=0.05)
    state = classification.init_train_state(ours, torch.Generator().manual_seed(3))
    step = classification.make_train_step(ctx)
    named = dict(state.params)
    lr_scale = optim.finetune_lr_scales(named, "head+2", SHAPES["depth"], head_scale=2.0)
    wd_scale = optim.no_weight_decay_scales(named)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    opt = jax_optim.adamw_init(jparams)
    jax_ls = jax_optim.finetune_lr_scales(jparams, "head+2", SHAPES["depth"], head_scale=2.0)
    jax_ws = jax_optim.no_weight_decay_scales(jparams)
    rng = np.random.default_rng(9)
    for it in range(4):
        images = rng.integers(0, 256, (B, 32, 32, 3), dtype=np.uint8)
        labels, valid = rng.integers(0, 2, B), np.arange(B) < B - it % 2
        lr = 2e-4 * (it + 1)
        # The draw the step is about to make from its generator.
        replay = torch.Generator()
        replay.set_state(state.generator.get_state())
        p = {k: v.numpy() for k, v in draw_augment_params(B, replay)._asdict().items()}
        metrics = step(state, torch.from_numpy(images), torch.from_numpy(labels),
                       torch.from_numpy(valid), lr, lr_scale, wd_scale)
        loss, grads = jax.value_and_grad(
            _jax_loss_fn(jax_clf, images, p, labels, valid, loss_args))(jparams)
        norm = jax_optim.global_norm(grads)
        jparams, opt = jax_optim.adamw_update(jparams, grads, opt, lr=lr, weight_decay=0.05,
                                              lr_scale=jax_ls, wd_scale=jax_ws)
        np.testing.assert_allclose(metrics["loss"].item(), float(loss), rtol=LOSS_RTOL,
                                   err_msg=f"step {it}")
        np.testing.assert_allclose(metrics["grad_norm"].item(), float(norm),
                                   rtol=TRAJECTORY_RTOL, err_msg=f"step {it}")
    want = _port_names(jax.tree_util.tree_map(np.asarray, jparams), ours.cfg)
    start = _port_names(params, ours.cfg)
    for name, got in state.params.items():
        got, w = got.numpy(), want[name]
        if lr_scale[name] == 0.0:  # frozen: the exact starting bits
            np.testing.assert_array_equal(got, start[name], err_msg=name)
        if name.endswith("attn.qkv.bias"):
            d = got.shape[0] // 3
            got, w = np.concatenate([got[:d], got[2 * d:]]), np.concatenate([w[:d], w[2 * d:]])
        # Relative L2 distance: a single element whose tiny gradient changed
        # sign moves by about lr.  A parameter that starts at zero is of the
        # size of the summed lr (2e-3).
        dist = np.linalg.norm(got - w) / max(1e-2, float(np.linalg.norm(w)))
        assert dist <= TRAJECTORY_RTOL, f"{name}: relative L2 distance {dist:.2e}"


# The bf16 forward through two blocks against the same forward on the same
# compute copy: the same arithmetic in the same order, so equal; the stated
# tolerance (two bf16 ulps of logits of magnitude below 4) covers a platform
# whose matmul picks another blocking for another call.
FORWARD_ATOL = 3e-2


def _plain_logits(classifier, images):
    """The classifier's module on a compute copy of its current masters."""
    from torch.func import functional_call

    from ssl4polyp_tpu_torch.data.augment import normalize_batch
    from ssl4polyp_tpu_torch.models.layers import compute_copy

    dtype = classifier.cfg.compute_dtype
    copy = compute_copy(dict(classifier.model.named_parameters()), dtype)
    with torch.no_grad():
        x = normalize_batch(torch.from_numpy(images), dtype)
        return functional_call(classifier.model, copy, (x,)).float().numpy()


def _bf16_classifier(seed=0):
    return build_classifier(torch.Generator().manual_seed(seed), {}, device="cpu", **SHAPES)


def test_forward_bound_to_the_train_state_follows_training():
    # Evaluate, train three steps, evaluate: both times the bound forward
    # reads the current weights (the JAX engine binds the epoch's parameters
    # at each evaluation).
    ours = _bf16_classifier()
    assert ours.cfg.compute_dtype == torch.bfloat16
    state = classification.init_train_state(ours, torch.Generator().manual_seed(0))
    forward = classification.make_forward_fn(ours, "cpu")(state.params_c)
    images = _images(11)
    before = forward(images)
    assert before.shape == (B, 2) and before.dtype == np.float32
    np.testing.assert_allclose(before, _plain_logits(ours, images), rtol=0, atol=FORWARD_ATOL)

    ctx = classification.TrainContext(ours, *classification.loss_settings([40, 20]),
                                      weight_decay=0.05)
    step = classification.make_train_step(ctx)
    lr_scale = optim.finetune_lr_scales(state.params, "full", SHAPES["depth"])
    wd_scale = optim.no_weight_decay_scales(state.params)
    rng = np.random.default_rng(12)
    for _ in range(3):
        step(state, torch.from_numpy(_images(int(rng.integers(100)))),
             torch.from_numpy(rng.integers(0, 2, B)), torch.ones(B, dtype=torch.bool), 1e-2,
             lr_scale, wd_scale)
    after = forward(images)
    np.testing.assert_allclose(after, _plain_logits(ours, images), rtol=0, atol=FORWARD_ATOL)
    # Training moved the logits by far more than the tolerance: a forward on
    # stale weights would fail the line above.
    assert np.abs(after - before).max() > 10 * FORWARD_ATOL
    # A fresh binding of the classifier's own parameters reads the same masters.
    np.testing.assert_allclose(classification.make_forward_fn(ours, "cpu")()(images), after,
                               rtol=0, atol=FORWARD_ATOL)


def test_make_forward_fn_leaves_the_masters_fp32():
    # Binding a forward before the train state is built must not cast the
    # module another caller owns.
    ours = _bf16_classifier(1)
    images = _images(13)
    logits = classification.make_forward_fn(ours, "cpu")()(images)
    assert np.isfinite(logits).all()
    assert all(p.dtype == torch.float32 for p in ours.model.parameters())
    state = classification.init_train_state(ours, torch.Generator().manual_seed(0))
    assert all(p.dtype == torch.float32 for p in state.params.values())
    assert all(t.dtype == (torch.bfloat16 if t.dim() >= 2 else torch.float32)
               for t in state.params_c.values())
    with pytest.raises(KeyError):
        classification.make_forward_fn(ours, "cpu")({"head.weight": state.params_c["head.weight"]})


@pytest.mark.parametrize("pretraining", ["random", "ImageNet_class"])
def test_factory_scheme_is_random_under_jax_params(pretraining):
    # The JAX factory names the scheme "sup_imnet" only where it read an
    # AugReg file; weights handed over in memory keep "random".
    jax_clf, params, _ = _jax_pair({})
    ours = build_classifier(torch.Generator().manual_seed(0), {"pretraining": pretraining},
                            jax_params=params, device="cpu", **SHAPES)
    assert jax_clf.scheme == "random" and ours.scheme == "random"

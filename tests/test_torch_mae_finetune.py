"""The port's upstream-MAE fine-tune and linear-probe engines against the JAX
package: the batch regularisers on draws taken from JAX keys the way the JAX
functions split them, label smoothing and the soft cross-entropy, the draws'
distributions, the layer-wise decay scales, LARS and gradient clipping, the
fine-tune step and a 3-step trajectory against a JAX step assembled from the
JAX functions, the linear probe end to end against the JAX engine, and the
fine-tune engine on the CPU (two runs bit-equal, the classifier untouched,
the position table trained)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl4polyp_tpu.data import augment as jax_augment
from ssl4polyp_tpu.models import factory as jax_factory
from ssl4polyp_tpu.training import mae_finetune as jax_mae_finetune
from ssl4polyp_tpu.training import optim as jax_optim
from ssl4polyp_tpu_torch.data import augment
from ssl4polyp_tpu_torch.data.augment import ErasingParams, MixupParams
from ssl4polyp_tpu_torch.models.factory import build_classifier
from ssl4polyp_tpu_torch.models.weights import state_dict_from_jax
from ssl4polyp_tpu_torch.training import classification, mae_finetune, optim
from ssl4polyp_tpu_torch.training.mae_finetune import MAEFinetuneSettings, StepDraws
from tests.test_torch_finetune import _images, _jax_augment, _numpy_params, _torch_params

SHAPES = dict(img_size=32, patch_size=8, embed_dim=128, depth=2, num_heads=4)
B = 6
# The regularisers select, copy and blend: fp32 blends may round once
# differently (an FMA), nothing more.
REGULARISER_ATOL = 1e-6
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
TRAJECTORY_RTOL = 1e-4
LARS_RTOL = 1e-6
PROBE_RTOL = 1e-5
# (mixup_alpha, cutmix_alpha, prob, switch_prob)
MIXUP_CASES = {"mixup": (0.8, 0.0, 1.0, 0.5), "cutmix": (0.0, 1.0, 1.0, 0.5),
               "switch": (0.8, 1.0, 1.0, 0.5), "prob 0.5": (0.8, 1.0, 0.5, 0.5)}


def _jax_mixup_draws(key, h, w, mixup_alpha, cutmix_alpha, prob, switch_prob) -> MixupParams:
    """The draws ``mixup_cutmix_batch`` makes from ``key``: ``split(key, 5)``,
    then ``_box_mask``'s ``split(k_box)``."""
    k_apply, k_switch, k_lam_mix, k_lam_cut, k_box = jax.random.split(key, 5)
    use_cutmix = (bool(jax.random.bernoulli(k_switch, switch_prob))
                  if mixup_alpha > 0.0 and cutmix_alpha > 0.0 else cutmix_alpha > 0.0)
    lam_mix = jax.random.beta(k_lam_mix, mixup_alpha, mixup_alpha) if mixup_alpha > 0 else 1.0
    lam_cut = jax.random.beta(k_lam_cut, cutmix_alpha, cutmix_alpha) if cutmix_alpha > 0 else 1.0
    k_y, k_x = jax.random.split(k_box)
    return MixupParams(bool(jax.random.bernoulli(k_apply, prob)), use_cutmix,
                       np.float32(lam_mix), np.float32(lam_cut),
                       int(jax.random.randint(k_y, (), 0, h)), int(jax.random.randint(k_x, (), 0, w)))


def _jax_erasing_draws(key, shape, prob, count, dtype, scale=(0.02, 1.0 / 3.0),
                       ratio=(0.3, 10.0 / 3.0)) -> ErasingParams:
    """The draws ``random_erasing`` makes from ``key``: ``split(key, b)``, then
    ``split(k, count + 1)`` a sample and ``split(kb, 5)`` a box."""
    b, h, w, c = shape
    do, area, log_ratio, y0, x0 = [], [], [], [], []
    noise = np.zeros((count, b, h, w, c), np.float32)
    for s, k in enumerate(jax.random.split(key, b)):
        keys = jax.random.split(k, count + 1)
        do.append(bool(jax.random.bernoulli(keys[0], prob)))
        row = [[], [], [], []]
        for i in range(count):
            k_area, k_ratio, k_y, k_x, k_fill = jax.random.split(keys[i + 1], 5)
            row[0].append(float(jax.random.uniform(k_area, (), minval=scale[0], maxval=scale[1])))
            row[1].append(float(jax.random.uniform(k_ratio, (), minval=math.log(ratio[0]),
                                                   maxval=math.log(ratio[1]))))
            row[2].append(int(jax.random.randint(k_y, (), 0, h)))
            row[3].append(int(jax.random.randint(k_x, (), 0, w)))
            noise[i, s] = np.asarray(jax.random.normal(k_fill, (h, w, c), dtype=dtype),
                                     np.float32)
        for column, values in zip((area, log_ratio, y0, x0), row):
            column.append(values)
    torch_dtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    return ErasingParams(torch.tensor(do), torch.tensor(area, dtype=torch.float32),
                         torch.tensor(log_ratio, dtype=torch.float32), torch.tensor(y0),
                         torch.tensor(x0), torch.from_numpy(noise).to(torch_dtype))


def _pair(dtype, seed, shape=(8, 12, 10, 3)):
    """The same normal batch for both sides: jnp in ``dtype``, torch of the same values."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    return jx, torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)


def _assert_same(got: torch.Tensor, want, dtype):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    if dtype == jnp.bfloat16:  # equal after the cast to the compute dtype
        got = got.to(torch.bfloat16).float()
        want = np.asarray(jnp.asarray(want).astype(jnp.bfloat16).astype(jnp.float32))
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=REGULARISER_ATOL)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", list(MIXUP_CASES))
def test_mixup_cutmix_matches_jax_on_its_draws(case, dtype):
    mixup_alpha, cutmix_alpha, prob, switch_prob = MIXUP_CASES[case]
    labels = np.array([0, 1, 1, 0, 1, 0, 0, 1])
    seen = set()
    for seed in range(8):
        images, ours = _pair(dtype, seed)
        targets = jax_augment.smooth_one_hot(jnp.asarray(labels), 2, 0.1)
        valid = np.arange(8) < (8 if seed % 2 else 6)  # invalid rows in every other batch
        key = jax.random.PRNGKey(100 + seed)
        want_x, want_t = jax_augment.mixup_cutmix_batch(
            images, targets, key, mixup_alpha=mixup_alpha, cutmix_alpha=cutmix_alpha, prob=prob,
            switch_prob=switch_prob, valid=jnp.asarray(valid))
        params = _jax_mixup_draws(key, 12, 10, *MIXUP_CASES[case])
        seen.add((params.apply, params.use_cutmix))
        got_x, got_t = augment.apply_mixup_cutmix(
            ours, torch.from_numpy(np.asarray(targets)), params, torch.from_numpy(valid))
        # JAX's fp32 lambda promotes the bf16 images: both sides give fp32.
        assert got_x.dtype == torch.float32 and want_x.dtype == jnp.float32
        _assert_same(got_x, want_x, dtype)
        np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), rtol=0,
                                   atol=REGULARISER_ATOL)
        if not valid.all():  # rows whose partner is padding keep their own
            np.testing.assert_array_equal(got_t[:2].numpy(), np.asarray(targets)[:2])
    expected = {"mixup": {(True, False)}, "cutmix": {(True, True)},
                "switch": {(True, False), (True, True)}}.get(case)
    assert seen == expected if expected else len({a for a, _ in seen}) == 2, seen


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("prob, count", [(0.5, 1), (1.0, 1), (0.5, 2)])
def test_random_erasing_matches_jax_on_its_draws(prob, count, dtype):
    for seed in range(3):
        images, ours = _pair(dtype, seed, (5, 16, 12, 3))
        key = jax.random.PRNGKey(7 + seed)
        want = jax_augment.random_erasing(images, key, prob=prob, count=count)
        params = _jax_erasing_draws(key, (5, 16, 12, 3), prob, count, dtype)
        got = augment.apply_random_erasing(ours, params)
        assert got.dtype == ours.dtype
        _assert_same(got, want, dtype)
        changed = (got != ours).any(dim=-1)
        assert bool(changed[~params.do].any()) is False
    assert augment.random_erasing(ours, torch.Generator(), prob=0.0) is ours


def test_smooth_one_hot_and_soft_cross_entropy_match_jax():
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 3, 9)
    logits = (3 * rng.standard_normal((9, 3))).astype(np.float32)
    for smoothing in (0.0, 0.1, 0.3):
        want = jax_augment.smooth_one_hot(jnp.asarray(labels), 3, smoothing)
        got = augment.smooth_one_hot(torch.from_numpy(labels), 3, smoothing)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
        for valid in (np.arange(9) < 7, np.ones(9, bool), np.zeros(9, bool)):
            want_loss = jax_mae_finetune._soft_cross_entropy(jnp.asarray(logits), want,
                                                             jnp.asarray(valid))
            got_loss = mae_finetune._soft_cross_entropy(torch.from_numpy(logits), got,
                                                        torch.from_numpy(valid))
            np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-6, atol=1e-6)
    assert mae_finetune._soft_cross_entropy(torch.from_numpy(logits), got,
                                            torch.zeros(9, dtype=torch.bool)).item() == 0.0


def test_draws_have_the_jax_ranges():
    rng = np.random.default_rng(0)
    draws = [augment.draw_mixup_params(rng, 224, 200, mixup_alpha=0.8, cutmix_alpha=1.0,
                                       prob=0.7, switch_prob=0.25) for _ in range(4000)]
    apply = np.mean([d.apply for d in draws])
    cut = np.mean([d.use_cutmix for d in draws])
    assert abs(apply - 0.7) < 0.03 and abs(cut - 0.25) < 0.03
    for name, alpha in (("lam_mix", 0.8), ("lam_cut", 1.0)):
        lam = np.array([getattr(d, name) for d in draws])
        assert lam.dtype == np.float32 and 0.0 <= lam.min() and lam.max() <= 1.0
        # Beta(a, a): mean 1/2, variance 1 / (4 (2a + 1)).
        assert abs(lam.mean() - 0.5) < 0.02, name
        assert abs(lam.var() - 1.0 / (4 * (2 * alpha + 1))) < 0.01, name
    for name, size in (("cy", 224), ("cx", 200)):
        v = np.array([getattr(d, name) for d in draws])
        assert v.min() == 0 and v.max() == size - 1 and abs(v.mean() - (size - 1) / 2) < 5
    only_cut = augment.draw_mixup_params(rng, 8, 8, cutmix_alpha=1.0)
    only_mix = augment.draw_mixup_params(rng, 8, 8, mixup_alpha=0.8)
    assert only_cut.use_cutmix and only_cut.lam_mix == 1.0
    assert not only_mix.use_cutmix and only_mix.lam_cut == 1.0

    gen = torch.Generator().manual_seed(0)
    p = augment.draw_erasing_params((2000, 20, 30, 3), gen, prob=0.25, count=2)
    assert p.do.shape == (2000,) and abs(p.do.float().mean().item() - 0.25) < 0.03
    for name, (lo, hi) in (("area", (0.02, 1.0 / 3.0)),
                           ("log_ratio", (math.log(0.3), math.log(10.0 / 3.0)))):
        v = getattr(p, name)
        assert v.shape == (2000, 2) and v.dtype == torch.float32
        assert lo <= v.min().item() and v.max().item() < hi
        assert abs(v.mean().item() - (lo + hi) / 2) < 0.02 * (hi - lo), name
    for name, size in (("y0", 20), ("x0", 30)):
        v = getattr(p, name)
        assert v.min().item() == 0 and v.max().item() == size - 1, name
    assert p.noise.shape == (2, 2000, 20, 30, 3) and p.noise.dtype == torch.float32
    assert abs(p.noise.mean().item()) < 0.01 and abs(p.noise.std().item() - 1) < 0.01
    bf16 = augment.draw_erasing_params((2, 4, 4, 3), gen, dtype=torch.bfloat16)
    assert bf16.noise.dtype == torch.bfloat16
    # The generators alone decide the draws.
    again = augment.draw_erasing_params((2000, 20, 30, 3), torch.Generator().manual_seed(0),
                                        prob=0.25, count=2)
    assert all(torch.equal(a, b) for a, b in zip(p, again))
    assert augment.draw_mixup_params(np.random.default_rng(3), 8, 8, mixup_alpha=0.8) == \
        augment.draw_mixup_params(np.random.default_rng(3), 8, 8, mixup_alpha=0.8)


def _jax_pair(depth=2, seed=0, pos_embed="sincos"):
    """(JAX classifier, its params as numpy, the port's classifier), fp32, same weights."""
    shapes = {**SHAPES, "depth": depth}
    jax_clf = jax_factory.get_imagenet_or_random_vit(
        jax.random.PRNGKey(seed), pos_embed=pos_embed, compute_dtype=jnp.float32, **shapes)
    params = jax.tree_util.tree_map(np.asarray, jax_clf.params)
    ours = build_classifier(torch.Generator().manual_seed(seed), {}, jax_params=params,
                            device="cpu", pos_embed=pos_embed, compute_dtype=torch.float32,
                            **shapes)
    return jax_clf, params, ours


def _port_names(tree, cfg):
    return {k: v.numpy() for k, v in state_dict_from_jax(tree, cfg).items()}


@pytest.mark.parametrize("depth", [2, 3])
@pytest.mark.parametrize("decay", [0.5, 0.75])
def test_layerwise_lr_decay_scales_match_jax(depth, decay):
    _, params, ours = _jax_pair(depth)
    for head_scale in (1.0, 2.0):
        scales = jax_optim.layerwise_lr_decay_scales(params, depth, decay, head_scale)
        full = jax.tree_util.tree_map(
            lambda p, s: np.broadcast_to(np.asarray(s, np.float32), p.shape), params, scales)
        want = _port_names(full, ours.cfg)
        got = optim.layerwise_lr_decay_scales(dict(ours.model.named_parameters()), depth, decay,
                                              head_scale)
        assert set(got) == set(want)
        for name, scale in got.items():
            np.testing.assert_array_equal(np.unique(want[name]), [scale], err_msg=name)
        assert got["pos_embed"] == decay ** (depth + 1) and got["head.weight"] == head_scale
        assert len(set(got.values())) == depth + 2 + (head_scale != 1.0)


def _lars_case(rng):
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "zero": np.zeros((4, 3), np.float32),   # |p| = 0 at step 1: trust 1
            "still": rng.standard_normal((3, 3)).astype(np.float32),  # |g| = 0: trust 1
            "frozen": rng.standard_normal((5, 2)).astype(np.float32),  # lr scale 0
            "vec": rng.standard_normal(7).astype(np.float32)}           # 1-D: plain SGD


def test_lars_update_matches_jax_over_five_steps():
    rng = np.random.default_rng(0)
    start = _lars_case(rng)
    scales = {"w": 1.0, "zero": 0.5, "still": 1.0, "frozen": 0.0, "vec": 2.0}
    jparams = {k: jnp.asarray(v) for k, v in start.items()}
    jstate = jax_optim.lars_init(jparams)
    params = {k: torch.from_numpy(v.copy()) for k, v in start.items()}
    state = optim.lars_init(params)
    for step in range(5):
        grads = {k: (rng.standard_normal(v.shape) * (0.0 if k == "still" else 1.0)
                     ).astype(np.float32) for k, v in start.items()}
        lr = 0.1 * (step + 1)
        jparams, jstate = jax_optim.lars_update(
            jparams, {k: jnp.asarray(g) for k, g in grads.items()}, jstate, lr=lr,
            weight_decay=0.05, lr_scale=scales)
        optim.lars_update(params, {k: torch.from_numpy(g) for k, g in grads.items()}, state,
                          lr=lr, weight_decay=0.05, lr_scale=scales)
        assert state.step == int(jstate.step) == step + 1
        for k in start:
            np.testing.assert_allclose(params[k].numpy(), np.asarray(jparams[k]), rtol=LARS_RTOL,
                                       atol=1e-7, err_msg=f"{k} at step {step}")
            np.testing.assert_allclose(state.momentum[k].numpy(), np.asarray(jstate.momentum[k]),
                                       rtol=LARS_RTOL, atol=1e-7, err_msg=f"{k} at step {step}")
    np.testing.assert_array_equal(params["frozen"].numpy(), start["frozen"])
    assert not np.array_equal(params["zero"].numpy(), start["zero"])
    # A compute copy of its own follows its master; an aliasing one is the master.
    copy = {"w": params["w"].to(torch.bfloat16), "vec": params["vec"]}
    optim.lars_update({"w": params["w"], "vec": params["vec"]},
                      {"w": torch.ones(6, 5), "vec": torch.ones(7)}, state, lr=0.1,
                      params_c=copy)
    assert torch.equal(copy["w"], params["w"].to(torch.bfloat16))


def test_clip_by_global_norm_matches_jax():
    rng = np.random.default_rng(1)
    grads = {"a": rng.standard_normal((4, 5)).astype(np.float32),
             "b": rng.standard_normal(3).astype(np.float32)}
    for max_norm in (0.5, 1e3):
        want, want_norm = jax_optim.clip_by_global_norm(
            {k: jnp.asarray(v) for k, v in grads.items()}, max_norm)
        got, norm = optim.clip_by_global_norm({k: torch.from_numpy(v) for k, v in grads.items()},
                                              max_norm)
        np.testing.assert_allclose(norm.item(), float(want_norm), rtol=1e-6)
        for k in grads:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-7)
    bf16, _ = optim.clip_by_global_norm({"a": torch.ones(3, dtype=torch.bfloat16)}, 1.0)
    assert bf16["a"].dtype == torch.bfloat16


# The upstream recipe's regularisers, erasing made frequent so that a small
# batch sees it.
STEP_SETTINGS = MAEFinetuneSettings(smoothing=0.1, mixup_alpha=0.8, cutmix_alpha=1.0,
                                    reprob=0.5, recount=1, weight_decay=0.05, layer_decay=0.75)


def _jax_step_grad(jax_clf, settings):
    """value_and_grad of the JAX engine's step loss (``mae_finetune.py:84-109``)
    after the augmentation, with the key split as the engine splits it, jitted
    once for every step.  The augmentation, on numpy draws, runs eagerly
    outside (it takes no parameter): jitted on the CPU, XLA's fusion moves the
    HSV round trip's sector ties (``maxc == r`` after the saturation step) and
    the chain then differs from the eager one, which the port's matches
    (``test_torch_finetune.py``), by up to 0.9 on a 32 px batch."""

    def loss_fn(params, images, labels, valid, key):
        _, k_erase, k_mix = jax.random.split(key, 3)
        targets = jax_augment.smooth_one_hot(labels, settings.num_classes, settings.smoothing)
        images = jax_augment.random_erasing(images, k_erase, prob=settings.reprob,
                                            count=settings.recount)
        images, targets = jax_augment.mixup_cutmix_batch(
            images, targets, k_mix, mixup_alpha=settings.mixup_alpha,
            cutmix_alpha=settings.cutmix_alpha, prob=settings.mixup_prob,
            switch_prob=settings.mixup_switch_prob, valid=valid)
        return jax_mae_finetune._soft_cross_entropy(jax_clf.apply(params, images), targets, valid)
    return jax.jit(jax.value_and_grad(loss_fn))


def _port_draws(images_u8, p, key, settings):
    _, k_erase, k_mix = jax.random.split(key, 3)
    h, w = images_u8.shape[1:3]
    return StepDraws(
        _torch_params(p),
        _jax_erasing_draws(k_erase, images_u8.shape, settings.reprob, settings.recount,
                           jnp.float32),
        _jax_mixup_draws(k_mix, h, w, settings.mixup_alpha, settings.cutmix_alpha,
                         settings.mixup_prob, settings.mixup_switch_prob))


def _assert_grads_close(got, want, what):
    for name, g in got.items():
        w = want[name]
        scale = max(1e-3, float(np.abs(w).max()))
        err = float(np.abs(g.numpy() - w).max()) / scale
        assert err < GRAD_RTOL, f"{what}: gradient of {name} off by {err:.2e} of its scale"


def test_step_and_trajectory_match_a_jax_step():
    """Three steps of ``loss_and_grads`` and ``make_finetune``'s update
    against the JAX engine's step math: value_and_grad of its loss, then
    ``adamw_update`` with the layer-wise decay's scales."""
    jax_clf, params, ours = _jax_pair()
    settings = STEP_SETTINGS
    state, ours_update = mae_finetune.make_finetune(ours, settings)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    opt = jax_optim.adamw_init(jparams)
    lr_scale = jax_optim.layerwise_lr_decay_scales(jparams, SHAPES["depth"], settings.layer_decay)
    wd_scale = jax_optim.no_weight_decay_scales(jparams)
    value_and_grad = _jax_step_grad(jax_clf, settings)
    # The JAX engine jits its update with its step.
    update = jax.jit(lambda params, grads, opt, lr: jax_optim.adamw_update(
        params, grads, opt, lr=lr, weight_decay=settings.weight_decay, lr_scale=lr_scale,
        wd_scale=wd_scale))
    rng = np.random.default_rng(5)
    erased = mixed = 0
    for it in range(3):
        images = _images(10 + it)
        labels, valid = rng.integers(0, 2, B), np.arange(B) < B - (it % 2)
        p, key = _numpy_params(10 + it), jax.random.PRNGKey(20 + it)
        draws = _port_draws(images, p, key, settings)
        erased += int(draws.erasing.do.sum())
        mixed += int(draws.mixup.apply)
        args = (torch.from_numpy(images), torch.from_numpy(labels), torch.from_numpy(valid))
        loss, grads = value_and_grad(jparams, _jax_augment(images, p), labels, valid, key)
        got, got_grads = mae_finetune.loss_and_grads(ours, state.params_c, *args, draws,
                                                     settings, state.params)
        np.testing.assert_allclose(got.item(), float(loss), rtol=LOSS_RTOL, err_msg=f"step {it}")
        if it == 0:
            want_grads = _port_names(jax.tree_util.tree_map(np.asarray, grads), ours.cfg)
            assert set(got_grads) == set(want_grads)
            _assert_grads_close(got_grads, want_grads, "step 1")
        ours_update(state, got_grads, 1e-3 * (it + 1))
        jparams, opt = update(jparams, grads, opt, jnp.float32(1e-3 * (it + 1)))
    assert erased and mixed
    want = _port_names(jax.tree_util.tree_map(np.asarray, jparams), ours.cfg)
    start = _port_names(params, ours.cfg)
    assert not np.array_equal(state.params["pos_embed"].numpy(), start["pos_embed"])
    for name, got in state.params.items():
        got, w = got.numpy(), want[name]
        if name.endswith("attn.qkv.bias"):
            d = got.shape[0] // 3
            got, w = np.concatenate([got[:d], got[2 * d:]]), np.concatenate([w[:d], w[2 * d:]])
        dist = np.linalg.norm(got - w) / max(1e-2, float(np.linalg.norm(w)))
        assert dist <= TRAJECTORY_RTOL, f"{name}: relative L2 distance {dist:.2e}"
    # The classifier's own parameters are the starting weights.
    for name, t in ours.model.named_parameters():
        np.testing.assert_array_equal(t.detach().numpy(), start[name], err_msg=name)


def _tiny_pack(tmp_path):
    from ssl4polyp_tpu.data.packs import create_classification_datasets as jax_datasets
    from ssl4polyp_tpu_torch.data.packs import create_classification_datasets
    from tests.conftest import make_image_pack

    pack = make_image_pack(tmp_path, frames_per_split=8, image_size=32)
    return (jax_datasets(train_spec=pack, image_size=32)["train"],
            create_classification_datasets(train_spec=pack, image_size=32)["train"])


TINY = dict(img_size=32, patch_size=8, embed_dim=32, depth=2, num_heads=2)


def test_linear_probe_matches_the_jax_engine(tmp_path):
    jax_index, index = _tiny_pack(tmp_path)
    jax_clf = jax_factory.get_imagenet_or_random_vit(jax.random.PRNGKey(0), None, num_classes=2,
                                                     compute_dtype=jnp.float32, **TINY)
    params = jax.tree_util.tree_map(np.asarray, jax_clf.params)
    ours = build_classifier(torch.Generator().manual_seed(0), {}, jax_params=params,
                            device="cpu", compute_dtype=torch.float32, **TINY)
    settings = MAEFinetuneSettings(epochs=2, warmup_epochs=1, batch_size=8, num_workers=1,
                                   base_lr=0.1, weight_decay=0.0, smoothing=0.0)
    want = jax_mae_finetune.run_linear_probe(jax_clf, jax_index, settings)
    got = mae_finetune.run_linear_probe(ours, index, settings, device="cpu")
    want_params = _port_names(jax.tree_util.tree_map(np.asarray, want["params"]), ours.cfg)
    start = _port_names(params, ours.cfg)
    assert set(got["params"]) == set(want_params)
    for name, t in got["params"].items():
        assert t.dtype == torch.float32
        if name.startswith("head."):
            assert not np.array_equal(t.numpy(), start[name]), name
            np.testing.assert_allclose(t.numpy(), want_params[name], rtol=PROBE_RTOL, atol=1e-7,
                                       err_msg=name)
        else:  # the encoder: bit-equal in both packages
            np.testing.assert_array_equal(t.numpy(), start[name], err_msg=name)
            np.testing.assert_array_equal(want_params[name], start[name], err_msg=name)
    np.testing.assert_allclose(got["train_loss"], want["train_loss"], rtol=PROBE_RTOL)


def test_mae_finetune_runs_twice_bit_equal_and_leaves_the_classifier(tmp_path):
    _, index = _tiny_pack(tmp_path)
    ours = build_classifier(torch.Generator().manual_seed(0), {"ss_framework": "mae"},
                            device="cpu", **TINY)
    assert ours.cfg.compute_dtype == torch.bfloat16 and ours.cfg.pos_embed == "sincos"
    before = {n: p.detach().clone() for n, p in ours.model.named_parameters()}
    settings = MAEFinetuneSettings(epochs=2, warmup_epochs=1, batch_size=4, num_workers=1,
                                   mixup_alpha=0.8, cutmix_alpha=1.0, reprob=0.5)
    first = mae_finetune.run_mae_finetune(ours, index, settings, device="cpu")
    second = mae_finetune.run_mae_finetune(ours, index, settings, device="cpu")
    assert math.isfinite(first["train_loss"]) and first["train_loss"] == second["train_loss"]
    assert set(first["params"]) == set(before)
    for name, t in first["params"].items():
        assert t.dtype == torch.float32 and torch.equal(t, second["params"][name]), name
        assert not torch.equal(t, before[name]), f"{name} did not move"
    for name, t in ours.model.named_parameters():
        assert torch.equal(t, before[name]), f"the classifier's {name} changed"
    # The fine-tune trains the position table; the classifier engine's
    # sin-cos lineage keeps it frozen.
    assert not ours.model.pos_embed.requires_grad
    state = classification.init_train_state(ours, torch.Generator().manual_seed(0))
    ctx = classification.step_context(ours, *classification.loss_settings([3, 1]), 0.05)
    scales = optim.finetune_lr_scales(state.params, "full", 2, freeze_pos_embed=True)
    classification.make_train_step(ctx)(
        state, torch.randint(0, 256, (2, 32, 32, 3), dtype=torch.uint8), torch.tensor([0, 1]),
        torch.tensor([True, True]), 1e-3, scales, optim.no_weight_decay_scales(state.params))
    assert torch.equal(ours.model.pos_embed, before["pos_embed"])
    assert not torch.equal(ours.model.patch_embed.proj.weight, before["patch_embed.proj.weight"])


def test_engines_raise_on_a_non_finite_loss(tmp_path):
    _, index = _tiny_pack(tmp_path)
    ours = build_classifier(torch.Generator().manual_seed(0), {}, device="cpu", **TINY)
    with torch.no_grad():
        ours.model.head.bias.fill_(float("nan"))
    settings = MAEFinetuneSettings(epochs=1, warmup_epochs=0, batch_size=4, num_workers=1)
    with pytest.raises(FloatingPointError, match="epoch 0"):
        mae_finetune.run_mae_finetune(ours, index, settings, device="cpu")
    with pytest.raises(FloatingPointError, match="epoch 0"):
        mae_finetune.run_linear_probe(ours, index, settings, device="cpu")


def test_engines_log_the_loss_every_log_interval_steps(tmp_path, caplog):
    """``log_interval`` is upstream's ``print_freq``: at INFO, steps 0, k, 2k
    of every epoch, with the step's loss and learning rate; 0 logs nothing,
    and nothing is logged (or read back) when no handler listens at INFO."""
    from ssl4polyp_tpu_torch.training.schedules import warmup_cosine

    _, index = _tiny_pack(tmp_path)  # 8 frames: 4 steps of 2 an epoch
    ours = build_classifier(torch.Generator().manual_seed(0), {}, device="cpu", **TINY)
    cases = ((mae_finetune.run_mae_finetune, 2, "INFO", [0, 2]),
             (mae_finetune.run_linear_probe, 3, "INFO", [0, 3]),
             (mae_finetune.run_linear_probe, 0, "INFO", []),
             (mae_finetune.run_linear_probe, 1, "WARNING", []))
    for engine, interval, level, logged in cases:
        settings = MAEFinetuneSettings(epochs=2, warmup_epochs=1, batch_size=2, num_workers=1,
                                       base_lr=1e-3, log_interval=interval)
        schedule = warmup_cosine(settings.base_lr, 8, 4)
        caplog.clear()
        with caplog.at_level(level, logger=mae_finetune.__name__):
            result = engine(ours, index, settings, device="cpu")
        lines = [r.getMessage() for r in caplog.records if r.name == mae_finetune.__name__]
        steps = [(e, it) for e in (0, 1) for it in logged]
        assert len(lines) == len(steps), (engine.__name__, interval, lines)
        for line, (e, it) in zip(lines, steps):
            head, tail = line.split(": loss ")
            loss, lr = tail.split(", lr ")
            assert head == f"epoch {e} step {it}/4" and math.isfinite(float(loss))
            assert lr == f"{schedule(4 * e + it):.6e}", line
        if logged == [0, 3]:  # the run's last step
            assert lines[-1].startswith(f"epoch 1 step 3/4: loss {result['train_loss']:.6f},")

"""The port's pretrain step against the JAX ``make_pretrain_step``.

Eight AdamW steps with ``accum_iter`` 2 of a tiny MAE in fp32, on the same
weights (carried over by ``mae_state_dict_from_jax``), the same uint8
batches and the same masking noise: the JAX step derives each microbatch's
key as ``split(fold_in(epoch_key, it), accum)`` and draws
``uniform(key, (B, L))``; the test draws the same noise and hands it to the
port.  The JAX step runs jitted on the 8-device CPU mesh, the port its plain
torch path.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl4polyp_tpu.models import mae as jax_mae
from ssl4polyp_tpu.models import vit as jax_vit
from ssl4polyp_tpu.parallel.mesh import build_mesh
from ssl4polyp_tpu.training import optim as jax_optim
from ssl4polyp_tpu.training import pretrain as jax_pretrain
from ssl4polyp_tpu_torch.models.mae import MAE, MAEConfig
from ssl4polyp_tpu_torch.models.vit import ViTConfig
from ssl4polyp_tpu_torch.models.weights import mae_state_dict_from_jax
from ssl4polyp_tpu_torch.training import pretrain
from ssl4polyp_tpu_torch.training.schedules import warmup_cosine

ENCODER = dict(img_size=32, patch_size=8, embed_dim=32, depth=2, num_heads=2)
DECODER = dict(decoder_embed_dim=16, decoder_depth=1, decoder_num_heads=2, mask_ratio=0.75)
STEPS, ACCUM, BATCH = 8, 2, 8
WEIGHT_DECAY = 0.05
# fp32 on both sides: summation order only.  AdamW divides by sqrt(nu), so a
# parameter whose gradient is tiny moves by about lr whatever its sign:
# the K slice of the qkv bias, whose exact gradient is zero, is left out
# (as in test_mae_trajectory_parity.py); the rest agree to 1e-4 relative.
LOSS_RTOL = 1e-5
GRAD_NORM_RTOL = 1e-5
PARAM_RTOL = 1e-4


def _jax_trajectory(params, jcfg, batches, epoch_key, schedule):
    mesh = build_mesh()
    step = jax_pretrain.make_pretrain_step(jcfg, mesh, ACCUM, WEIGHT_DECAY)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    params_c = jax_pretrain.init_compute_params(params, jcfg, mesh)
    opt = jax_optim.adamw_init(params)
    lr_scale = jax_optim.pretrain_lr_scales(params)
    wd_scale = jax_optim.no_weight_decay_scales(params)
    metrics = []
    for it, images in enumerate(batches):
        params, params_c, opt, m = step(params, params_c, opt, jnp.asarray(images), epoch_key,
                                        jnp.int32(it), jnp.float32(schedule(it)), lr_scale,
                                        wd_scale)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return jax.tree_util.tree_map(np.asarray, params), metrics


def _port_trajectory(params, cfg, batches, epoch_key, schedule):
    model = MAE(cfg, torch.Generator().manual_seed(0))
    model.load_state_dict(mae_state_dict_from_jax(params, cfg))
    state = pretrain.init_pretrain_state(model)
    step = pretrain.make_pretrain_step(cfg, ACCUM, WEIGHT_DECAY)
    L = cfg.encoder.num_patches
    metrics = []
    for it, images in enumerate(batches):
        keys = jax.random.split(jax.random.fold_in(epoch_key, it), ACCUM)
        noise = np.stack([np.asarray(jax.random.uniform(k, (BATCH, L))) for k in keys])
        m = step(state, torch.from_numpy(images), torch.from_numpy(noise), schedule(it))
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
    return state.params, metrics


def test_trajectory_matches_jax_make_pretrain_step():
    jcfg = jax_mae.MAEConfig(
        encoder=jax_vit.ViTConfig(compute_dtype=jnp.float32, **ENCODER), **DECODER)
    cfg = MAEConfig(encoder=ViTConfig(compute_dtype=torch.float32, **ENCODER), **DECODER)
    params = jax.tree_util.tree_map(np.asarray, jax_mae.init_mae(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(7)
    batches = [rng.integers(0, 256, (ACCUM, BATCH, 32, 32, 3), dtype=np.uint8)
               for _ in range(STEPS)]
    epoch_key = jax.random.fold_in(jax.random.PRNGKey(99), 0)
    schedule = warmup_cosine(1.5e-3, STEPS, 2)

    ref_params, ref_metrics = _jax_trajectory(params, jcfg, batches, epoch_key, schedule)
    ours, metrics = _port_trajectory(params, cfg, batches, epoch_key, schedule)

    for it, ((loss, norm), (ref_loss, ref_norm)) in enumerate(zip(metrics, ref_metrics)):
        np.testing.assert_allclose(loss, ref_loss, rtol=LOSS_RTOL, err_msg=f"loss, step {it}")
        np.testing.assert_allclose(norm, ref_norm, rtol=GRAD_NORM_RTOL,
                                   err_msg=f"grad norm, step {it}")
    assert metrics[-1][0] < metrics[0][0]
    ref_state = mae_state_dict_from_jax(ref_params, cfg)
    start = mae_state_dict_from_jax(params, cfg)
    for name, p in ours.items():
        got, want = p.numpy(), ref_state[name].numpy()
        if name.endswith("attn.qkv.bias"):
            d = got.shape[0] // 3
            got, want = np.concatenate([got[:d], got[2 * d:]]), np.concatenate([want[:d], want[2 * d:]])
        worst = float(np.abs(got - want).max()) / max(1e-3, float(np.abs(want).max()))
        assert worst < PARAM_RTOL, f"{name} diverged: rel {worst:.2e}"
    for name in ("pos_embed", "decoder_pos_embed"):
        assert torch.equal(ours[name], start[name])


def test_one_step_under_the_projection_fold_matches_jax(monkeypatch):
    # BENCH_ATTN_PROJ=1 with the decoder's 17 tokens counted as padded to 24
    # and the encoder's 5 left alone: the decoder's block folds its
    # projection into the attention kernel (here its plain version), the
    # encoder's blocks do not, and the step's loss and every gradient are
    # jax.value_and_grad's of the JAX model, as without the fold.
    from ssl4polyp_tpu.data.augment import normalize_batch as jax_normalize

    monkeypatch.setenv("BENCH_ATTN_PROJ", "1")
    wide = dict(ENCODER, embed_dim=128, num_heads=4)
    dec = dict(DECODER, decoder_embed_dim=128, decoder_num_heads=4)
    jcfg = jax_mae.MAEConfig(encoder=jax_vit.ViTConfig(compute_dtype=jnp.float32, **wide), **dec)
    cfg = MAEConfig(encoder=ViTConfig(compute_dtype=torch.float32, **wide), decoder_pad_to=24,
                    **dec)
    params = jax.tree_util.tree_map(np.asarray, jax_mae.init_mae(jax.random.PRNGKey(1), jcfg))
    model = MAE(cfg, torch.Generator().manual_seed(0))
    model.load_state_dict(mae_state_dict_from_jax(params, cfg))
    assert [b.attn.proj_fold for b in model.blocks] == [False, False]
    assert [b.attn.proj_fold for b in model.decoder_blocks] == [True]

    images = np.random.default_rng(2).integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(5)
    noise = np.array(jax.random.uniform(key, (4, cfg.encoder.num_patches)))
    ref_loss, ref_grads = jax.value_and_grad(
        lambda p: jax_mae.mae_forward(p, jax_normalize(jnp.asarray(images), jnp.float32), key,
                                      jcfg)[0])(params)
    ref_grads = mae_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, ref_grads), cfg)
    loss, grads = pretrain.loss_and_grads(pretrain.init_pretrain_state(model),
                                          torch.from_numpy(images)[None],
                                          torch.from_numpy(noise)[None])
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=LOSS_RTOL)
    assert sorted(grads) == sorted(ref_grads)
    for name, g in grads.items():
        got, want = g.numpy(), ref_grads[name].numpy()
        if name.endswith("attn.qkv.bias"):  # the K slice's exact gradient is zero
            d = got.shape[0] // 3
            got, want = np.concatenate([got[:d], got[2 * d:]]), np.concatenate([want[:d], want[2 * d:]])
        dist = float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))
        assert dist < 1e-5, f"{name}: relative L2 distance {dist:.2e}"


@pytest.fixture
def image_folder(tmp_path):
    from PIL import Image

    root = tmp_path / "frames"
    root.mkdir()
    rng = np.random.default_rng(0)
    for i in range(8):
        # Sizes and aspects vary, so the crop boxes and their fallback vary.
        h, w = 40 + 9 * i, 40 + 13 * (7 - i)
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(root / f"{i}.png")
    return root


def test_loader_yields_the_jax_loaders_batches(image_folder):
    from ssl4polyp_tpu.data import folder as jax_folder
    from ssl4polyp_tpu_torch.data import folder

    ours = folder.PretrainLoader(folder.ImageFolderIndex(image_folder, no_train_dir=True), 3,
                                 image_size=24, seed=5, num_workers=2)
    ref = jax_folder.PretrainLoader(jax_folder.ImageFolderIndex(image_folder, no_train_dir=True),
                                    3, image_size=24, seed=5, num_workers=2, use_native=False)
    assert len(ours) == len(ref) == 2
    for epoch in range(2):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = list(ours), list(ref)
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            assert a.shape == (3, 24, 24, 3) and a.dtype == np.uint8
            np.testing.assert_array_equal(a, b)


def test_loader_raises_when_a_frame_does_not_decode(image_folder):
    from ssl4polyp_tpu_torch.data import folder

    (image_folder / "8.png").write_bytes(b"not an image")
    loader = folder.PretrainLoader(folder.ImageFolderIndex(image_folder, no_train_dir=True), 9,
                                   image_size=24, num_workers=2)
    with pytest.raises(RuntimeError, match="producer failed"):
        list(loader)


def test_run_pretraining_logs_epochs(image_folder, tmp_path, monkeypatch):
    tiny = MAEConfig(encoder=ViTConfig(compute_dtype=torch.float32, **ENCODER), **DECODER)
    monkeypatch.setattr(pretrain, "model_config", lambda settings: tiny)
    settings = pretrain.PretrainSettings(
        data_root=str(image_folder), output_dir=str(tmp_path / "out"), epochs=2,
        warmup_epochs=1, batch_size=2, accum_iter=2, image_size=32, num_workers=2,
        log_interval=1, no_train_dir=True, device="cpu",
    )
    record = pretrain.run_pretraining(settings)
    lines = (tmp_path / "out" / "pretrain_log.jsonl").read_text().splitlines()
    assert [json.loads(line)["epoch"] for line in lines] == [0, 1]
    assert record == json.loads(lines[-1]) and np.isfinite(record["train_loss"])


@pytest.mark.parametrize("seed", [0, 13])
def test_noise_seed_is_distinct_across_epochs_and_steps(seed):
    # A seed linear in (epoch, step) gave step s + 7,919 of one epoch the noise
    # of step s of the next; each (seed, epoch, step) now has its own.
    cpu = torch.device("cpu")
    for step in (0, 5):
        a = (seed, 0, step + 7_919)
        b = (seed, 1, step)
        assert pretrain._noise_seed(*a) != pretrain._noise_seed(*b)
        assert not torch.equal(pretrain._step_noise(*a, (2, 49), cpu),
                               pretrain._step_noise(*b, (2, 49), cpu))
    seeds = {pretrain._noise_seed(seed, e, s) for e in range(4) for s in range(0, 40_000, 7_919)}
    assert len(seeds) == 4 * len(range(0, 40_000, 7_919))
    assert all(0 <= v < 2 ** 63 for v in seeds)
    # The same triple gives the same noise: a run and its rerun draw alike.
    assert torch.equal(pretrain._step_noise(seed, 2, 3, (2, 49), cpu),
                       pretrain._step_noise(seed, 2, 3, (2, 49), cpu))


def test_model_config_is_the_pretrain_recipe():
    cfg = pretrain.model_config(pretrain.PretrainSettings())
    enc = cfg.encoder
    assert (enc.embed_dim, enc.depth, enc.num_heads, enc.img_size, enc.patch_size) == (768, 12, 12, 224, 16)
    assert (cfg.decoder_embed_dim, cfg.decoder_depth, cfg.decoder_num_heads) == (512, 8, 16)
    assert cfg.len_keep == 49 and not cfg.norm_pix_loss
    # bf16 compute rounds the scores before the softmax (pretrain.py:126).
    assert enc.compute_dtype == torch.bfloat16 and not enc.attention_softmax_f32

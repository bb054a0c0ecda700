"""The port's one-pass AdamW against the JAX package's
``adamw_update_fused`` with its Pallas leaf kernel in interpret mode.

Parameters, gradients and scales are made with numpy from a seed and given
to both.  On the CPU the port's wrapper runs its plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl4polyp_tpu.training import optim as jax_optim
from ssl4polyp_tpu_torch import ops
from ssl4polyp_tpu_torch.models.layers import compute_copy
from ssl4polyp_tpu_torch.ops import adamw as adamw_ops
from ssl4polyp_tpu_torch.training import optim

# fp32 arithmetic on both sides in the same order; XLA may contract a
# multiply and an add into one rounding where eager torch rounds twice, so a
# few ulps of fp32 over three steps.  The bf16 copies are roundings of those
# values: equal, or one bf16 ulp (2^-8 relative) where a rounding flips.
F32_TOL = dict(rtol=2e-6, atol=1e-7)
BF16_TOL = dict(rtol=2 ** -7, atol=1e-6)
SHAPES = {
    "patch.kernel": (48, 16), "patch.bias": (16,), "cls_token": (1, 1, 16),
    "pos_embed": (1, 5, 16), "blocks.qkv": (2, 16, 48), "blocks.qkv_bias": (2, 48),
    "ln.scale": (16,), "head.kernel": (16, 2), "head.bias": (2,),
}
LR_SCALE = {name: 1.0 for name in SHAPES} | {"pos_embed": 0.0, "head.kernel": 2.5,
                                             "head.bias": 2.5}
WD_SCALE = {name: 1.0 if len(shape) >= 2 and name not in ("cls_token", "pos_embed") else 0.0
            for name, shape in SHAPES.items()}


def _arrays(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {name: (scale * rng.standard_normal(shape)).astype(np.float32)
            for name, shape in SHAPES.items()}


def _torch_state(params_np, copy_dtype=torch.bfloat16):
    params = {n: torch.from_numpy(a.copy()) for n, a in params_np.items()}
    return params, compute_copy(params, copy_dtype), optim.adamw_init(params)


@pytest.mark.parametrize("grad_dtype", ["float32", "bfloat16"])
def test_three_steps_match_the_jax_fused_update(grad_dtype):
    params_np = _arrays(0)
    params, params_c, state = _torch_state(params_np)
    jax_params = {n: jnp.asarray(a) for n, a in params_np.items()}
    jax_state = jax_optim.adamw_init(jax_params)
    kwargs = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.05)
    for step in range(3):
        grads_np = _arrays(10 + step, 0.1)
        lr = 1e-3 * (step + 1)
        grads = {n: torch.from_numpy(a).to(getattr(torch, grad_dtype))
                 for n, a in grads_np.items()}
        optim.adamw_update_fused(params, params_c, grads, state, lr=lr, lr_scale=LR_SCALE,
                                 wd_scale=WD_SCALE, **kwargs)
        jax_grads = {n: jnp.asarray(a, getattr(jnp, grad_dtype)) for n, a in grads_np.items()}
        jax_params, jax_params_c, jax_state = jax_optim.adamw_update_fused(
            jax_params, jax_grads, jax_state, lr=lr, compute_dtype=jnp.bfloat16,
            lr_scale=LR_SCALE, wd_scale=WD_SCALE, interpret=True, **kwargs)
        assert state.step == int(jax_state.step) == step + 1
        for name in SHAPES:
            np.testing.assert_allclose(params[name].numpy(), np.asarray(jax_params[name]),
                                       err_msg=name, **F32_TOL)
            np.testing.assert_allclose(state.mu[name].numpy(), np.asarray(jax_state.mu[name]),
                                       err_msg=name, **F32_TOL)
            np.testing.assert_allclose(state.nu[name].numpy(), np.asarray(jax_state.nu[name]),
                                       err_msg=name, **F32_TOL)
            # The same leaves carry a bf16 copy on both sides: rank >= 2.
            want = jax_params_c[name]
            assert (params_c[name].dtype == torch.bfloat16) == (want.dtype == jnp.bfloat16) \
                == (len(SHAPES[name]) >= 2), name
            np.testing.assert_allclose(params_c[name].float().numpy(),
                                       np.asarray(want.astype(jnp.float32)), err_msg=name,
                                       **BF16_TOL)
    # The frozen table kept its bits, and its moments moved.
    np.testing.assert_array_equal(params["pos_embed"].numpy(), params_np["pos_embed"])
    assert float(state.mu["pos_embed"].abs().sum()) > 0


def test_copies_are_the_rounded_masters_and_vectors_alias_them():
    params, params_c, state = _torch_state(_arrays(1))
    grads = {n: torch.from_numpy(a) for n, a in _arrays(2, 0.1).items()}
    optim.adamw_update_fused(params, params_c, grads, state, lr=1e-2, weight_decay=0.05,
                             lr_scale=LR_SCALE, wd_scale=WD_SCALE)
    for name, master in params.items():
        if master.dim() >= 2:
            assert params_c[name].dtype == torch.bfloat16
            assert torch.equal(params_c[name], master.to(torch.bfloat16)), name
        else:
            assert params_c[name].data_ptr() == master.data_ptr(), name


def test_fused_update_is_adamw_update_plus_the_copy():
    # The masters and moments of the one-pass step are adamw_update's bits,
    # with a bf16 copy, an fp32 "copy" (every entry its master) and no copy.
    results = []
    for mode in ("bf16", "fp32", "masters only"):
        params, params_c, state = _torch_state(
            _arrays(3), torch.bfloat16 if mode == "bf16" else torch.float32)
        for step in range(2):
            grads = {n: torch.from_numpy(a) for n, a in _arrays(20 + step, 0.1).items()}
            kwargs = dict(lr=1e-3, weight_decay=0.05, lr_scale=LR_SCALE, wd_scale=WD_SCALE)
            if mode == "masters only":
                optim.adamw_update(params, grads, state, **kwargs)
            else:
                optim.adamw_update_fused(params, params_c, grads, state, **kwargs)
        results.append((params, state))
    for params, state in results[1:]:
        for name in SHAPES:
            assert torch.equal(params[name], results[0][0][name]), name
            assert torch.equal(state.mu[name], results[0][1].mu[name]), name
            assert torch.equal(state.nu[name], results[0][1].nu[name]), name


def test_cpu_wrapper_is_the_plain_version_and_launches_nothing():
    ops.reset_launch_counts()
    out = []
    for fn in (optim.adamw_update_fused, optim.adamw_update_fused_plain):
        params, params_c, state = _torch_state(_arrays(4))
        grads = {n: torch.from_numpy(a) for n, a in _arrays(5, 0.1).items()}
        fn(params, params_c, grads, state, lr=1e-3, weight_decay=0.05, lr_scale=LR_SCALE,
           wd_scale=WD_SCALE)
        out.append((params, params_c))
    for name in SHAPES:
        assert torch.equal(out[0][0][name], out[1][0][name])
        assert torch.equal(out[0][1][name], out[1][1][name])
    assert set(ops.launch_counts().values()) == {0}


def test_the_kernel_s_table_packs_as_its_struct_lays_it_out():
    # csrc/adamw.cu asserts sizeof(AdamWChunk) == 3880; the host packs the
    # same bytes: 64 tensors a launch, the first block of each tensor.
    assert adamw_ops._CHUNK.itemsize == 3880
    count = adamw_ops.TENSORS_PER_LAUNCH + 6
    tensors = [torch.zeros(n) for n in [8193, 3, 16384] + [5] * (count - 3)]
    scales = [1.0] * count
    scales[1] = 0.0
    cache = {}
    table = adamw_ops._table(cache, tensors, [None] * count, tensors, tensors)
    grads = [t.clone() for t in tensors]
    grads[2] = grads[2].bfloat16()
    chunks = table.step(grads, scales, scales, 1e-3, 0.05, np.arange(7, dtype=np.float32))
    assert len(chunks) == 2 and chunks["count"].tolist() == [64, 6]
    assert chunks["block_start"][0, :5].tolist() == [0, 2, 3, 5, 6]
    assert chunks["block_start"][0, 64] == 5 + 61 and chunks["block_start"][1, 6] == 6
    assert chunks["n"][0, :3].tolist() == [8193, 3, 16384]
    assert chunks["p"][0, 2] == tensors[2].data_ptr() and chunks["copy"][0, 2] == 0
    assert chunks["g"][1, 5] == grads[-1].data_ptr()
    # decay; frozen (and no decay); a bf16 gradient with decay
    assert chunks["flags"][0, :3].tolist() == [4, 2, 5]
    assert chunks["lr"][0, 0] == np.float32(1e-3) and chunks["decay"][0, 1] == 0.0
    assert chunks["scalars"][1].tolist() == list(range(7))
    # The same tensors come back: the same table; another tensor: a new one.
    assert adamw_ops._table(cache, tensors, [None] * count, tensors, tensors) is table
    other = tensors[:-1] + [torch.zeros(5)]
    assert adamw_ops._table(cache, other, [None] * count, tensors, tensors) is not table
    with pytest.raises(TypeError):
        table.step([g.double() for g in grads], scales, scales, 1e-3, 0.05, np.zeros(7))
    with pytest.raises(ValueError):
        table.step(grads[::-1], scales, scales, 1e-3, 0.05, np.zeros(7))
    with pytest.raises(TypeError):  # an fp16 copy
        adamw_ops._table(None, tensors[:1], [torch.zeros(8193).half()], tensors[:1], tensors[:1])

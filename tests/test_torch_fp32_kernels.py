"""The fp32 compute path of the default route, on the CPU.

The card runs fp32 tensors (``amp: false``, ``PretrainSettings.precision =
"fp32"``) through fp32 kernels of their own: attention forward and backward,
fc1+GELU and LayerNorm forward and backward.  Here:

* the plain fp32 versions those kernels are held to on the card, against the
  JAX Pallas kernels in interpret mode at the shapes the kernels must cover
  (1, 50, 197 and 256 tokens, head dims 32 and 64, the MAE's and ViT-B's
  widths); the fp32 cases of ``test_torch_qkv_attention.py`` (N 21-37) are
  not repeated;
* the wrappers' checks on CPU tensors: fp32 and bf16 accepted, mixed dtypes
  refused, and the wrappers whose fp32 kernel is not yet ported refusing
  fp32 with the ROADMAP.md item that lists it; with a stub library, that an
  fp32 tensor reaches the ``_f32`` entry points and counters (nothing is
  built or launched);
* the precision settings of both train steps giving the JAX package's fp32
  configurations.

Inputs are made with numpy from seeds and handed to both frameworks.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl4polyp_tpu.configs.layered import load_layered_config as jax_load_config
from ssl4polyp_tpu.ops.layernorm import layernorm_fused_bwd as jax_layernorm
from ssl4polyp_tpu.ops.mlp import _forward as jax_fc1_forward
from ssl4polyp_tpu.ops.mlp import fc1_gelu as jax_fc1_gelu
from ssl4polyp_tpu.ops.qkv_attention import fused_qkv_attention as jax_attention
from ssl4polyp_tpu.ops.qkv_attention import fused_qkv_bias_attention as jax_bias_attention
from ssl4polyp_tpu.training import pretrain as jax_pretrain
from ssl4polyp_tpu.training import protocol as jax_protocol
from ssl4polyp_tpu_torch import ops
from ssl4polyp_tpu_torch.configs.layered import load_layered_config
from ssl4polyp_tpu_torch.ops import (_build, attention, attention_block, attn_proj, layernorm,
                                     ln_linear, mlp, qkv_attention)
from ssl4polyp_tpu_torch.ops.qkv_attention import (
    fused_qkv_attention,
    fused_qkv_attention_backward_reference,
)
from ssl4polyp_tpu_torch.training import pretrain, protocol

# fp32 on both sides, the same algorithm: summation order only (the attention
# forward's, LayerNorm's y and dx; the tolerance of test_torch_qkv_attention.py).
F32_TOL = 2e-5
# Gradients: two or three fp32 sums deep, relative to the largest value
# (the attention backward's tolerance of test_torch_qkv_attention.py).
GRAD_TOL = 1e-4
# fc1+GELU: the JAX kernel's erf is a polynomial within 2.2e-6 of the exact
# erf the port takes, and h sums 512 or 768 products in another order.
FC1_TOL = 2e-5
EPS = 1e-6


def _assert_close(ours, ref, tol, what):
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(ours, ref, rtol=tol, atol=tol * scale, err_msg=what)


# Token counts at the fp32 kernels' edges: one token, the MAE encoder's 50,
# the classifier's and the decoder's 197, the largest the kernels take.
ATTENTION_CASES = [
    (1, 64, None, True),
    (1, 32, None, False),
    (50, 64, 49, True),
    (50, 32, None, False),
    (197, 64, 150, True),
    (197, 32, None, False),
    (256, 64, 255, False),
    (256, 32, 200, True),
]


def _attention_inputs(seed, N, hd, with_bias, H=2, B=1):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B, N, 3 * H * hd)).astype(np.float32)
    bias = (0.5 * rng.standard_normal(3 * H * hd)).astype(np.float32) if with_bias else None
    dout = rng.standard_normal((B, N, H * hd)).astype(np.float32)
    return qkv, bias, dout, H


def _jax_attention(qkv, bias, H, valid_len):
    if bias is None:
        return lambda a: jax_attention(a, H, True, True, valid_len)
    return lambda a, b: jax_bias_attention(a, b, H, True, True, valid_len)


@pytest.mark.parametrize("N, hd, valid_len, with_bias", ATTENTION_CASES)
def test_attention_forward_matches_jax_kernel(N, hd, valid_len, with_bias):
    qkv, bias, _, H = _attention_inputs(N, N, hd, with_bias)
    args = [jnp.asarray(qkv)] + ([] if bias is None else [jnp.asarray(bias)])
    ref = np.asarray(_jax_attention(qkv, bias, H, valid_len)(*args))
    t_bias = None if bias is None else torch.from_numpy(bias)
    ours = fused_qkv_attention(torch.from_numpy(qkv), H, True, valid_len, t_bias)
    assert ours.dtype == torch.float32
    _assert_close(ours.numpy(), ref, F32_TOL, "out")


@pytest.mark.parametrize("N, hd, valid_len, with_bias", ATTENTION_CASES)
def test_attention_backward_matches_jax_kernel(N, hd, valid_len, with_bias):
    qkv, bias, dout, H = _attention_inputs(N + 1, N, hd, with_bias)
    args = [jnp.asarray(qkv)] + ([] if bias is None else [jnp.asarray(bias)])
    _, vjp = jax.vjp(_jax_attention(qkv, bias, H, valid_len), *args)
    ref = [np.asarray(g) for g in vjp(jnp.asarray(dout))]
    dqkv, dbias = fused_qkv_attention_backward_reference(
        torch.from_numpy(qkv), torch.from_numpy(dout), H, True, valid_len,
        None if bias is None else torch.from_numpy(bias))
    _assert_close(dqkv.numpy(), ref[0], GRAD_TOL, "dqkv")
    if with_bias:
        _assert_close(dbias.numpy(), ref[1], GRAD_TOL, "dbias")
    else:
        assert dbias is None


# fc1+GELU at the kernel's widths: (M, K, NF), M a multiple of 8 (the JAX
# kernel's row tiling).
FC1_SHAPES = [(56, 768, 3072), (128, 512, 2048), (200, 768, 384)]


def _fc1_inputs(seed, m, k, nf):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, nf)) / np.sqrt(k)).astype(np.float32)  # JAX (in, out)
    b = (0.5 * rng.standard_normal(nf)).astype(np.float32)
    dy = rng.standard_normal((m, nf)).astype(np.float32)
    return x, w, b, dy


@pytest.mark.parametrize("m, k, nf", FC1_SHAPES)
def test_fc1_gelu_y_and_h_match_jax_kernel(m, k, nf):
    x, w, b, _ = _fc1_inputs(m, m, k, nf)
    h_ref, y_ref = (np.asarray(a) for a in jax_fc1_forward(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), True))
    xt, bt = torch.from_numpy(x), torch.from_numpy(b)
    wt = torch.from_numpy(np.ascontiguousarray(w.T))
    _assert_close(mlp.fc1_gelu_reference(xt, wt, bt).numpy(), y_ref, FC1_TOL, "y")
    # h, the residual the backward reads: the plain forward's pre-activation.
    _assert_close((torch.matmul(xt, wt.t()) + bt).numpy(), h_ref, FC1_TOL, "h")


@pytest.mark.parametrize("m, k, nf", FC1_SHAPES)
def test_fc1_gelu_backward_matches_jax_custom_vjp(m, k, nf):
    # The port's plain backward (mlp.py's fc1_gelu_backward, from the saved h)
    # against the JAX VJP (mlp.py:155-168) in fp32.
    x, w, b, dy = _fc1_inputs(m + 1, m, k, nf)
    _, vjp = jax.vjp(lambda a, c, d: jax_fc1_gelu(a, c, d, True),
                     jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    ref = [np.asarray(g) for g in vjp(jnp.asarray(dy))]
    xt, bt = torch.from_numpy(x), torch.from_numpy(b)
    wt = torch.from_numpy(np.ascontiguousarray(w.T))
    h = torch.matmul(xt, wt.t()) + bt
    dx, dw, db = mlp.fc1_gelu_backward(xt, wt, h, torch.from_numpy(dy))
    assert dx.dtype == dw.dtype == db.dtype == torch.float32
    for name, a, r in (("dx", dx, ref[0]), ("dw", dw.t(), ref[1]), ("db", db, ref[2])):
        _assert_close(a.numpy(), r, GRAD_TOL, name)


@pytest.mark.parametrize("shape", [(2, 197, 512), (1, 50, 768), (96, 512), (64, 768)],
                         ids=["decoder-3d", "encoder-3d", "decoder-2d", "classifier-2d"])
def test_layernorm_forward_and_backward_match_jax_kernel(shape):
    rng = np.random.default_rng(sum(shape))
    D = shape[-1]
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    scale = (1 + 0.2 * rng.standard_normal(D)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(D)).astype(np.float32)
    y_ref, vjp = jax.vjp(lambda a, s, c: jax_layernorm(a, s, c, EPS, True),
                         jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    ref = [np.asarray(y_ref)] + [np.asarray(g) for g in vjp(jnp.asarray(dy))]
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, scale, bias)]
    y = layernorm.layernorm(*leaves, EPS)
    y.backward(torch.from_numpy(dy))
    ours = [y.detach()] + [t.grad for t in leaves]
    for name, a, r, tol in zip(("y", "dx", "dscale", "dbias"), ours, ref,
                               (F32_TOL, F32_TOL, GRAD_TOL, GRAD_TOL)):
        assert a.dtype == torch.float32
        _assert_close(a.numpy(), r, tol, name)


# The wrappers' checks on CPU tensors.

def _t(shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_default_route_wrappers_take_fp32_and_bf16(dtype):
    qkv_attention._check(_t((2, 9, 3 * 128), dtype), 2, 7, _t(3 * 128, dtype))
    qkv_attention._check(_t((2, 9, 3 * 64), dtype), 2, None, None)
    mlp._check(_t((4, 64), dtype), _t((24, 64), dtype), _t(24, dtype))
    layernorm._check(_t((3, 5, 64), dtype), _t(64), _t(64))


def test_default_route_wrappers_refuse_mixed_and_other_dtypes():
    bf16, f16 = torch.bfloat16, torch.float16
    with pytest.raises(ValueError, match="bias"):  # fp32 qkv, bf16 bias
        qkv_attention._check(_t((1, 8, 3 * 64)), 2, None, _t(3 * 64, bf16))
    with pytest.raises(TypeError):
        qkv_attention._check(_t((1, 8, 3 * 64), f16), 2, None, None)
    with pytest.raises(ValueError, match="fp32 kernels take head dims"):  # hd 16
        qkv_attention._check(_t((1, 8, 3 * 32)), 2, None, None)
    for x, w, b in ((_t((4, 64)), _t((24, 64), bf16), _t(24)),
                    (_t((4, 64), bf16), _t((24, 64)), _t(24, bf16)),
                    (_t((4, 64)), _t((24, 64)), _t(24, bf16)),
                    (_t((4, 64), f16), _t((24, 64), f16), _t(24, f16))):
        with pytest.raises(TypeError, match="one dtype"):
            mlp._check(x, w, b)
    with pytest.raises(TypeError):
        layernorm._check(_t((4, 64), f16), _t(64), _t(64))
    with pytest.raises(ValueError):  # a bf16 affine under fp32 rows
        layernorm._check(_t((4, 64)), _t(64, bf16), _t(64))


def _bf16_only_checks(dtype):
    """Each bf16-only wrapper's check on tensors of ``dtype``, with the
    ROADMAP.md item its refusal of fp32 names."""
    f32 = torch.float32
    x, w1, b1 = _t((8, 512), dtype), _t((64, 512), dtype), _t(64, dtype)
    w2, b2, s, t = _t((512, 64), dtype), _t(512, dtype), _t(512, f32), _t(512, f32)
    qkv, w, b = _t((1, 8, 3 * 128), dtype), _t((128, 128), dtype), _t(128, dtype)
    q = _t((1, 2, 8, 64), dtype)
    xb, wb, bb = _t((1, 8, 64), dtype), _t((64, 3 * 128), dtype), _t(3 * 128, dtype)
    return [
        ("mlp_fused", lambda: mlp._check_fused(x, None, None, w1, b1, w2, b2), 1),
        ("mlp_ln_fused", lambda: mlp._check_fused(x, s, t, w1, b1, w2, b2), 1),
        ("ln_linear", lambda: ln_linear._check(x, s, t, w1, b1), 1),
        ("fused_attention_proj", lambda: attn_proj._check(qkv, w, b, 2, None), 1),
        ("fused_qkvproj_attention", lambda: attention_block._check(xb, wb, bb, 2, None), 2),
        ("fused_attention", lambda: attention._check(q, q, q), 2),
    ]


@pytest.mark.parametrize("index", range(6), ids=["mlp_fused", "mlp_ln_fused", "ln_linear",
                                                "fused_attention_proj",
                                                "fused_qkvproj_attention", "fused_attention"])
def test_bf16_only_wrappers_refuse_fp32_naming_the_roadmap_item(index):
    _, check, item = _bf16_only_checks(torch.float32)[index]
    with pytest.raises(TypeError, match=f"not yet ported \\(ROADMAP.md §2a, item {item}\\)"):
        check()
    _, check, _ = _bf16_only_checks(torch.float16)[index]
    with pytest.raises(TypeError, match="the kernel takes bfloat16"):
        check()
    _bf16_only_checks(torch.bfloat16)[index][1]()  # accepted


class _StubLibrary:
    """Records which entry point each launch reached; launches nothing."""

    def __init__(self):
        self.called = []

    def __getattr__(self, name):
        if not name.startswith("ssl4polyp_"):
            raise AttributeError(name)

        def entry(*args):
            self.called.append(name)
            return 4 if name.startswith("ssl4polyp_layernorm_bwd_blocks") else 0
        return entry


@pytest.fixture
def stub(monkeypatch):
    library = _StubLibrary()
    monkeypatch.setattr(_build, "library", lambda: library)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("Stream", (), {"cuda_stream": 0})())
    saved = {module: dict(vars(module)) for module in (qkv_attention, mlp, layernorm)}
    ops.reset_launch_counts()
    yield library
    for module, names in saved.items():  # the counters as they were
        for name in ("launches", "backward_launches", "launches_f32", "backward_launches_f32"):
            if name in names:
                setattr(module, name, names[name])


@pytest.mark.parametrize("dtype, suffix, counter", [(torch.float32, "_f32", "_f32"),
                                                    (torch.bfloat16, "", "")],
                         ids=["fp32", "bf16"])
def test_wrappers_reach_the_entry_points_of_their_dtype(stub, dtype, suffix, counter):
    qkv, bias, dout = _t((2, 9, 3 * 128), dtype), _t(3 * 128, dtype), _t((2, 9, 128), dtype)
    qkv_attention._forward_kernel(qkv, 2, True, None, bias)
    qkv_attention._backward_kernel(qkv, dout, 2, True, None, bias)
    mlp._kernel(_t((4, 64), dtype), _t((24, 64), dtype), _t(24, dtype), write_h=True)
    x = _t((5, 64), dtype)
    layernorm._forward_kernel(x, _t(64), _t(64), EPS)
    layernorm._backward_kernel(x, x.clone(), _t(64), EPS)
    bwd = "ssl4polyp_qkv_attention_bwd" + ("_f32" if suffix else "_mode")
    assert stub.called == [
        "ssl4polyp_qkv_attention_fwd" + suffix, bwd, "ssl4polyp_fc1_gelu_fwd" + suffix,
        "ssl4polyp_layernorm_fwd" + suffix, "ssl4polyp_layernorm_bwd_blocks" + suffix,
        "ssl4polyp_layernorm_bwd" + suffix]
    counts = ops.launch_counts()
    for name in ("fused_qkv_attention", "fused_qkv_attention_backward", "fc1_gelu", "layernorm",
                 "layernorm_backward"):
        assert counts[name + counter] == 1, name
    assert sum(counts.values()) == 5


def test_fp32_backward_has_no_probe_and_no_scaled_ds_mode(stub):
    qkv, dout = _t((1, 8, 3 * 64)), _t((1, 8, 64))
    for kwargs in (dict(probe=qkv_attention.PROBE_NO_PHASE_B), dict(scaled_ds=True)):
        with pytest.raises(ValueError, match="fp32 backward"):
            qkv_attention._backward_kernel(qkv, dout, 1, True, None, None, **kwargs)
    assert stub.called == []


# The precision settings of both train steps.

def test_pretrain_fp32_settings_give_the_jax_fp32_model():
    ours = pretrain.model_config(pretrain.PretrainSettings(precision="fp32"))
    ref = jax_pretrain.model_config(jax_pretrain.PretrainSettings(precision="fp32"))
    assert ours.encoder.compute_dtype == torch.float32
    assert ref.encoder.compute_dtype == jnp.float32
    assert ours.encoder.attention_softmax_f32 is ref.encoder.attention_softmax_f32 is True
    bf16 = pretrain.model_config(pretrain.PretrainSettings())
    assert bf16.encoder.compute_dtype == torch.bfloat16 and not bf16.encoder.attention_softmax_f32


@pytest.mark.parametrize("amp, precision", [(False, "fp32"), (True, "bf16"), (None, "bf16")])
def test_amp_false_gives_fp32_in_both_engines(amp, precision):
    overrides = {} if amp is None else {"amp": amp}
    plans = [resolve(load("config/exp/exp1.yaml"), model_key="sup_imnet", seed=13,
                     overrides=overrides)
             for resolve, load in ((jax_protocol.resolve_run_plan, jax_load_config),
                                   (protocol.resolve_run_plan, load_layered_config))]
    assert [plan.precision for plan in plans] == [precision, precision]

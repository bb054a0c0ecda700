"""The fp32 compute path of the default route, on the CPU.

The card runs fp32 tensors (``amp: false``, ``PretrainSettings.precision =
"fp32"``) through fp32 kernels of their own: attention forward and backward,
fc1+GELU and LayerNorm forward and backward, and under the fusion knobs the
fused MLP, the fused LN+MLP and LN+QKV.  Here:

* the plain fp32 versions those kernels are held to on the card, against the
  JAX Pallas kernels in interpret mode at the shapes the kernels must cover
  (1, 50, 197, 256 and 300 tokens, head dims 32 and 64, the MAE's and
  ViT-B's widths); the fp32 cases of ``test_torch_qkv_attention.py`` (N
  21-37) are not repeated;
* the wrappers' checks on CPU tensors: fp32 and bf16 accepted, mixed dtypes
  refused, and a head dim no fp32 kernel takes refused with the ROADMAP.md
  item that lists it; with a stub library, that an fp32 tensor reaches the
  ``_f32`` entry points and counters and a bf16 one the bf16 entry points
  (nothing is built or launched), the attention+projection fold, the
  projection + attention and attention over separate q, k, v among them,
  that each takes any token count, that the fp32 attention backward's
  ``scaled_ds`` mode reaches its kernel, and that the autograd of the four
  hands the backward the forward's output and log-sum-exp;
* the order of operations of the fp32 kernels of the attention+projection
  fold and of the projection + attention, emulated in plain torch (the
  attention backward from the forward's log-sum-exp, key tile by key tile,
  in both of its modes; the weight gradients summed over the rows in the
  split-K kernel's slices), against the JAX kernels in interpret mode;
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
from ssl4polyp_tpu.ops.attention_block import fused_qkvproj_attention as jax_qkvproj_attention
from ssl4polyp_tpu.ops.attn_proj import fused_attention_proj as jax_attention_proj
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
    fused_qkv_attention_reference,
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
# the classifier's and the decoder's 197, 256 (the bf16 kernels' largest),
# and 300, past it (the fp32 kernels take any N).
ATTENTION_CASES = [
    (1, 64, None, True),
    (1, 32, None, False),
    (50, 64, 49, True),
    (50, 32, None, False),
    (197, 64, 150, True),
    (197, 32, None, False),
    (256, 64, 255, False),
    (256, 32, 200, True),
    (300, 32, 280, True),
    (300, 64, None, False),
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


def _fusion_checks(dtype, weight_dtype=None):
    """Each fusion knob's and public function's check on tensors of
    ``dtype`` (the weights of ``weight_dtype`` when given; for attention
    over separate q, k, v its k), with the ROADMAP.md item its refusal of
    fp32 names: None for the kernels whose fp32 version is ported, which
    since §2a item 2b is every one."""
    f32, wd = torch.float32, weight_dtype or dtype
    x, w1, b1 = _t((8, 512), dtype), _t((64, 512), wd), _t(64, wd)
    w2, b2, s, t = _t((512, 64), wd), _t(512, wd), _t(512, f32), _t(512, f32)
    qkv, w, b = _t((1, 8, 3 * 128), dtype), _t((128, 128), wd), _t(128, wd)
    q, k = _t((1, 2, 8, 64), dtype), _t((1, 2, 8, 64), wd)
    xb, wb, bb = _t((1, 8, 64), dtype), _t((64, 3 * 128), wd), _t(3 * 128, wd)
    return [
        ("mlp_fused", lambda: mlp._check_fused(x, None, None, w1, b1, w2, b2), None),
        ("mlp_ln_fused", lambda: mlp._check_fused(x, s, t, w1, b1, w2, b2), None),
        ("ln_linear", lambda: ln_linear._check(x, s, t, w1, b1), None),
        ("fused_attention_proj", lambda: attn_proj._check(qkv, w, b, 2, None), None),
        ("fused_qkvproj_attention", lambda: attention_block._check(xb, wb, bb, 2, None), None),
        ("fused_attention", lambda: attention._check(q, k, q), None),
    ]


@pytest.mark.parametrize("index", range(6), ids=["mlp_fused", "mlp_ln_fused", "ln_linear",
                                                "fused_attention_proj",
                                                "fused_qkvproj_attention", "fused_attention"])
def test_bf16_only_wrappers_refuse_fp32_naming_the_roadmap_item(index):
    """No kernel is bf16-only any longer: the fused MLPs, LN+QKV, the
    attention+projection fold, the projection + attention and attention over
    separate q, k, v (the last, ported to fp32 in §2a item 2b) take fp32 and
    bf16 and refuse fp16 and a mix of the two."""
    _, check, item = _fusion_checks(torch.float32)[index]
    if item is None:
        check()  # accepted
        for dtype, weights in ((torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)):
            with pytest.raises(TypeError, match="one dtype"):
                _fusion_checks(dtype, weights)[index][1]()
    else:
        with pytest.raises(TypeError, match=f"not yet ported \\(ROADMAP.md §2a, item {item}\\)"):
            check()
    _, check, _ = _fusion_checks(torch.float16)[index]
    with pytest.raises(TypeError, match="the kernel takes bfloat16" if item else "one dtype"):
        check()
    _fusion_checks(torch.bfloat16)[index][1]()  # accepted


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_fused_wrappers_refuse_an_affine_that_is_not_fp32(dtype):
    x, w1, b1 = _t((8, 512), dtype), _t((64, 512), dtype), _t(64, dtype)
    w2, b2, s = _t((512, 64), dtype), _t(512, dtype), _t(512, torch.bfloat16)
    with pytest.raises(TypeError, match="float32 s"):
        mlp._check_fused(x, s, _t(512), w1, b1, w2, b2)
    with pytest.raises(TypeError, match="float32 t"):
        ln_linear._check(x, _t(512), s, w1, b1)


class _StubLibrary:
    """Records which entry point each launch reached, and its arguments;
    launches nothing."""

    def __init__(self):
        self.called = []
        self.args = []

    def __getattr__(self, name):
        if not name.startswith("ssl4polyp_"):
            raise AttributeError(name)

        def entry(*args):
            self.called.append(name)
            self.args.append(args)
            if name.startswith("ssl4polyp_layernorm_bwd_blocks"):
                return 4
            return 3 if name.endswith("_slices") else 0  # the weight gradients' row slices
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
    for (module, name), value in saved.items():  # the counters as they were
        setattr(module, name, value)


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


@pytest.mark.parametrize("dtype, suffix", [(torch.float32, "_f32"), (torch.bfloat16, "")],
                         ids=["fp32", "bf16"])
def test_fusion_knob_wrappers_reach_the_entry_points_of_their_dtype(stub, dtype, suffix):
    M, K, NF, N = 10, 768, 96, 2304
    x, w1, b1 = _t((M, K), dtype), _t((NF, K), dtype), _t(NF, dtype)
    w2, b2, s, t = _t((K, NF), dtype), _t(K, dtype), _t(K), _t(K)
    h, _ = mlp._fused_kernel(x, None, None, w1, b1, w2, b2, 0.0, write_h=True)
    no_h, _ = mlp._fused_kernel(x, s, t, w1, b1, w2, b2, 1e-6, write_h=False)
    ln_linear._kernel(x, s, t, _t((N, K), dtype), _t(N, dtype), 1e-6)
    fused = "ssl4polyp_mlp_fused_fwd_f32" if suffix else "ssl4polyp_mlp_fused_probe"
    assert stub.called == [fused, fused, "ssl4polyp_ln_linear_" + ("fwd_f32" if suffix else "probe")]
    assert h.shape == (M, NF) and h.dtype == dtype and no_h is None
    # (x, s, t, w1, b1, w2, b2, h, out, M, K, NF, eps, [probe,] stream): the
    # plain MLP without the affine, h only where asked.
    first, second, third = stub.args
    assert first[1] is None and first[7] == h.data_ptr() and first[9:12] == (M, K, NF)
    assert second[1] == s.data_ptr() and second[7] is None and second[12] == 1e-6
    assert third[7:10] == (M, K, N)  # (x, s, t, w, b, stats, out, M, K, N, eps, ...)
    assert len(first) == (14 if suffix else 15)
    counts = ops.launch_counts()
    for name in ("mlp_fused", "mlp_ln_fused", "ln_linear"):
        assert counts[name + suffix] == 1, name
    assert sum(counts.values()) == 3
    if suffix:  # the probe bits are the bf16 kernels' measurement aid
        with pytest.raises(ValueError, match="no probe"):
            mlp._fused_kernel(x, None, None, w1, b1, w2, b2, 0.0, write_h=False,
                              probe=mlp.FUSED_PROBE_NO_FC2)
        with pytest.raises(ValueError, match="no probe"):
            ln_linear._kernel(x, s, t, _t((N, K)), _t(N), 1e-6, probe=ln_linear.PROBE_NO_STATS)
        assert len(stub.called) == 3


def test_fp32_backward_has_no_probe_and_no_scaled_ds_mode(stub):
    # The fp32 backward has no probe bits; its scaled_ds mode (the scale
    # inside dS, as fused_qkvproj_attention's backward takes it) reaches the
    # kernel as its own argument, off by default.
    qkv, dout = _t((1, 8, 3 * 64)), _t((1, 8, 64))
    with pytest.raises(ValueError, match="fp32 backward kernel has no probe bits"):
        qkv_attention._backward_kernel(qkv, dout, 1, True, None, None,
                                       probe=qkv_attention.PROBE_NO_PHASE_B)
    assert stub.called == []
    for scaled_ds in (True, False):
        qkv_attention._backward_kernel(qkv, dout, 1, True, None, None, scaled_ds=scaled_ds)
    # (..., n_valid, scale, scaled_ds, forward_first, stream)
    assert stub.called == ["ssl4polyp_qkv_attention_bwd_f32"] * 2
    assert [args[-3] for args in stub.args] == [1, 0]
    assert stub.args[0][-4] == qkv_attention._scale(64, torch.float32) == 0.125
    assert ops.launch_counts()["fused_qkv_attention_backward_f32"] == 2


def test_fp32_attention_takes_any_token_count_and_bf16_stops_at_256(stub):
    H, hd = 12, 64
    qkv, bias = _t((1, 577, 3 * H * hd)), _t(3 * H * hd)
    qkv_attention._check(qkv, H, 500, bias)
    qkv_attention._forward_kernel(qkv, H, True, 500, bias)
    qkv_attention._backward_kernel(qkv, _t((1, 577, H * hd)), H, True, 500, bias)
    assert stub.called == ["ssl4polyp_qkv_attention_fwd_f32", "ssl4polyp_qkv_attention_bwd_f32"]
    # (..., B, N, H, hd, n_valid, scale, stream): the forward's shape, then
    # the backward's with B * ceil(577 / 64) rows of dbias scratch first.
    assert stub.args[0][4:9] == (1, 577, H, hd, 500)
    assert stub.args[1][9:15] == (10, 1, 577, H, hd, 500)
    # In bf16 the attention kernels take any N too (past 256 the key tiles),
    # and so do the projection fold's (its composition on them there) and,
    # since ROADMAP.md §2a item 2b, attention over separate q, k, v (the key
    # tiles in its layout); in fp32 that function takes them on the fp32
    # kernels.
    D = H * hd
    for n in (256, 257, 577):
        qkv_attention._check(_t((1, n, 3 * H * hd), torch.bfloat16), H, None, None)
        attn_proj._check(_t((1, n, 3 * D), torch.bfloat16), _t((D, D), torch.bfloat16),
                         _t(D, torch.bfloat16), H, None)
        for dtype in (torch.bfloat16, torch.float32):
            q = _t((1, H, n, hd), dtype)
            attention._check(q, q.clone(), q.clone())
    with pytest.raises(ValueError):
        qkv_attention._check(_t((1, 0, 3 * H * hd)), H, None, None)


@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "no-bias"])
def test_fp32_autograd_hands_the_backward_the_forward_output_and_lse(stub, with_bias):
    B, N, H, hd = 2, 9, 2, 64
    qkv = _t((B, N, 3 * H * hd)).requires_grad_()
    bias = _t(3 * H * hd).requires_grad_() if with_bias else None
    out = qkv_attention._QKVAttention.apply(qkv, bias, H, True, 7, False)
    out.backward(torch.ones_like(out))
    assert stub.called == ["ssl4polyp_qkv_attention_fwd_f32", "ssl4polyp_qkv_attention_bwd_f32"]
    fwd, bwd = stub.args
    # The forward wrote out and lse; the backward reads those same tensors
    # (dout, out, lse: arguments 2-4) and runs no forward of its own.
    assert fwd[2] == out.data_ptr() and fwd[3] is not None
    assert bwd[3] == fwd[2] and bwd[4] == fwd[3] and bwd[-2] == 0
    assert (bwd[8] is not None) == with_bias  # dbias
    counts = ops.launch_counts()
    assert counts["fused_qkv_attention_f32"] == counts["fused_qkv_attention_backward_f32"] == 1
    # Without a backward to follow (no input requires grad, as in the eval
    # forward), no log-sum-exp is written.
    with torch.inference_mode():
        qkv_attention._QKVAttention.apply(qkv.detach(), None if bias is None else bias.detach(),
                                          H, True, 7, False)
    assert stub.args[-1][3] is None
    # From (qkv, dout) alone, the backward's one launch runs the forward first.
    qkv_attention._backward_kernel(qkv.detach(), torch.ones_like(out), H, True, 7,
                                   None if bias is None else bias.detach())
    assert stub.called[-1] == "ssl4polyp_qkv_attention_bwd_f32" and stub.args[-1][-2] == 1


def test_fp32_separate_attention_refuses_head_dims_naming_the_roadmap_item(stub):
    # The fp32 kernels of attention over separate q, k, v take head dims 32
    # and 64; 16 (the bf16 kernels take it) and 80 raise, naming the item
    # that lists them.  Nothing reaches the library.
    for hd in (16, 80):
        q = _t((1, 2, 300, hd))
        with pytest.raises(ValueError, match="not yet ported: ROADMAP.md §2a, item 4"):
            attention._check(q, q.clone(), q.clone())
    attention._check(*(_t((1, 2, 300, 16), torch.bfloat16) for _ in range(3)))
    with pytest.raises(TypeError, match="one dtype"):
        attention._check(_t((1, 2, 8, 64)), _t((1, 2, 8, 64), torch.bfloat16), _t((1, 2, 8, 64)))
    assert stub.called == []


def test_fp32_separate_attention_autograd_hands_the_backward_the_forward_output_and_lse(stub):
    B, H, N, hd = 2, 3, 9, 32
    leaves = [_t((B, H, N, hd)).requires_grad_() for _ in range(3)]
    out = attention._Attention.apply(*leaves, False)
    out.backward(torch.ones_like(out))
    assert stub.called == ["ssl4polyp_attention_fwd_f32", "ssl4polyp_attention_bwd_f32"]
    fwd, bwd = stub.args
    # The forward wrote out and lse; the backward reads those same tensors
    # (out, lse: arguments 4 and 5) and runs no forward of its own.
    assert fwd[3] == out.data_ptr() and fwd[4] is not None
    assert bwd[4] == fwd[3] and bwd[5] == fwd[4] and bwd[-2] == 0
    counts = ops.launch_counts()
    assert counts["fused_attention_f32"] == counts["fused_attention_backward_f32"] == 1
    # Without a backward to follow, no log-sum-exp is written.
    with torch.inference_mode():
        attention._Attention.apply(*(t.detach() for t in leaves), False)
    assert stub.args[-1][4] is None
    # From (q, k, v, dout) alone, the backward's one launch runs the forward
    # first.
    attention._backward_kernel(*(t.detach() for t in leaves), torch.ones_like(out))
    assert stub.called[-1] == "ssl4polyp_attention_bwd_f32" and stub.args[-1][-2] == 1
    assert ops.launch_counts()["fused_attention_backward_f32"] == 2


def _projection_inputs(dtype, N=9):
    """(qkv, w, b, dy) of the attention+projection fold and (x, w, b, dout) of
    the projection + attention, at D 128 (2 heads of 64) and Din 64."""
    H, hd, d_in = 2, 64, 64
    D = H * hd
    fold = (_t((2, N, 3 * D), dtype), _t((D, D), dtype), _t(D, dtype), _t((2, N, D), dtype))
    block = (_t((2, N, d_in), dtype), _t((d_in, 3 * D), dtype), _t(3 * D, dtype),
             _t((2, N, D), dtype))
    return H, fold, block


@pytest.mark.parametrize("dtype, suffix", [(torch.float32, "_f32"), (torch.bfloat16, "")],
                         ids=["fp32", "bf16"])
def test_projection_wrappers_reach_the_entry_points_of_their_dtype(stub, dtype, suffix):
    H, (qkv, w, b, dy), (x, wb, bb, dout) = _projection_inputs(dtype)
    y = attn_proj._forward_kernel(qkv, w, b, H, True, None)
    attn_proj._backward_kernel(qkv, w, b, dy, H, True, 7)
    out = attention_block._forward_kernel(x, wb, bb, H, True, None)
    attention_block._backward_kernel(x, wb, bb, dout, H, True, 7)
    slices = "ssl4polyp_sgemm_f32_slices" if suffix else "ssl4polyp_dw_product_slices"
    assert stub.called == [
        "ssl4polyp_attn_proj_fwd" + suffix, slices, "ssl4polyp_attn_proj_bwd" + suffix,
        "ssl4polyp_qkvproj_attention_fwd" + (suffix or "_probe"), slices,
        "ssl4polyp_qkvproj_attention_bwd" + (suffix or "_probe")]
    assert y.shape == out.shape == (2, 9, 128) and y.dtype == out.dtype == dtype
    counts = ops.launch_counts()
    for name in ("attn_proj", "attn_proj_backward", "fused_qkvproj_attention",
                 "fused_qkvproj_attention_backward"):
        assert counts[name + suffix] == 1, name
    assert sum(counts.values()) == 4
    if not suffix:
        return
    fwd, _, bwd, block_fwd, block_slices, block_bwd = stub.args
    # The fold's forward: (qkv, w, b, core, lse, y, B, N, H, hd, n_valid, ...),
    # no log-sum-exp without keep.
    assert fwd[4] is None and fwd[5] == y.data_ptr() and fwd[6:11] == (2, 9, H, 64, 9)
    # Its backward from (qkv, w, b, dy) alone: (..., dw_part, dw, db_part, db, B,
    # N, H, hd, n_valid, scale, slices, forward_first, stream); the weight
    # gradient's slices asked for (D, D) over B * N rows.
    assert stub.args[1] == (128, 128, 18)
    assert bwd[8] is not None and bwd[12:17] == (2, 9, H, 64, 7) and bwd[-3:-1] == (3, 1)
    # The projection + attention: (x, w, b, qkv, out, lse, B, N, Din, H, hd,
    # n_valid, ...); its backward's slices (Din, 3D) over B * N rows.
    assert block_fwd[4] == out.data_ptr() and block_fwd[5] is None
    assert block_fwd[6:12] == (2, 9, 64, H, 64, 9)
    assert block_slices == (64, 384, 18)
    assert block_bwd[12] is not None and block_bwd[14:20] == (2, 9, 64, H, 64, 7)
    assert block_bwd[-3:-1] == (3, 1)
    for run in (lambda: attn_proj._forward_kernel(qkv, w, b, H, True, None, ablate=1),
                lambda: attention_block._forward_kernel(x, wb, bb, H, True, None, probe=1),
                lambda: attention_block._backward_kernel(x, wb, bb, dout, H, True, None,
                                                         probe=1)):
        with pytest.raises(ValueError, match="fp32"):  # the bf16 kernels' measurement aids
            run()
    assert len(stub.called) == 6


def test_projection_wrappers_take_any_token_count_in_fp32_and_bf16_stops_at_256(stub):
    # Both projection wrappers take any token count in either dtype (in bf16
    # past 256 their compositions on the key tiles), and so, since ROADMAP.md
    # §2a item 2b, does attention over separate q, k, v.
    for dtype, N in ((torch.float32, 577), (torch.bfloat16, 256), (torch.bfloat16, 257),
                     (torch.bfloat16, 577)):
        H, (qkv, w, b, _), (x, wb, bb, _) = _projection_inputs(dtype, N)
        attn_proj._check(qkv, w, b, H, N - 1)
        attention_block._check(x, wb, bb, H, None)
        q = _t((1, 2, N, 64), dtype)
        attention._check(q, q.clone(), q.clone())
    # fp32 takes any number of heads in the fold (5 of 32: D 160); bf16 a D
    # that is a multiple of 128.
    attn_proj._check(_t((1, 8, 480)), _t((160, 160)), _t(160), 5, None)
    with pytest.raises(ValueError, match="multiple of 128"):
        attn_proj._check(_t((1, 8, 480), torch.bfloat16), _t((160, 160), torch.bfloat16),
                         _t(160, torch.bfloat16), 5, None)
    assert stub.called == []


@pytest.mark.parametrize("fold", [True, False], ids=["attn_proj", "qkvproj_attention"])
def test_fp32_projection_autograd_hands_the_backward_the_forward_output_and_lse(stub, fold):
    H, (qkv, w, b, _), (x, wb, bb, _) = _projection_inputs(torch.float32)
    if fold:
        leaves, function, names = (qkv, w, b), attn_proj._AttentionProj, "attn_proj"
        kept, lse_at = 3, 4  # the forward's core output and log-sum-exp arguments
    else:
        leaves, function = (x, wb, bb), attention_block._QKVProjAttention
        names, kept, lse_at = "fused_qkvproj_attention", 4, 5
    leaves = [t.clone().requires_grad_() for t in leaves]
    out = function.apply(*leaves, H, True, 7, False)
    out.backward(torch.ones_like(out))
    fwd, bwd = stub.args[0], stub.args[-1]
    assert stub.called[0].endswith("fwd_f32") and stub.called[-1].endswith("bwd_f32")
    # The backward reads the tensors the forward wrote (the fold's core
    # output, the projection + attention's output itself) and their
    # log-sum-exp, and runs no forward of its own.
    assert fwd[kept] is not None and fwd[lse_at] is not None
    if not fold:
        assert fwd[kept] == out.data_ptr()
    assert (bwd[kept], bwd[lse_at]) == (fwd[kept], fwd[lse_at]) and bwd[-2] == 0
    counts = ops.launch_counts()
    assert counts[names + "_f32"] == counts[names + "_backward_f32"] == 1
    # Without a backward to follow, no log-sum-exp is written.
    with torch.inference_mode():
        function.apply(*[t.detach() for t in leaves], H, True, 7, False)
    assert stub.args[-1][lse_at] is None


# The fp32 card kernels' order of operations, emulated in plain torch
# against the JAX kernels in fp32: the same arithmetic in the kernels'
# grouping, so a fault of the grouping (a slice bound, a key tile's edge, the
# scale on the wrong side) shows here, on the CPU.

def _split_k(a, g, slices):
    """a^T g summed over the rows as the fp32 split-K product sums it
    (csrc/sgemm_f32.cuh): slice z takes rows [z c, (z + 1) c) with c = 8
    ceil(ceil(K / slices) / 8), each slice's product in fp32 (zero where a
    slice is empty), the slices added in slice order."""
    chunk = -(-(-(-a.shape[0] // slices)) // 8) * 8
    total = None
    for z in range(slices):
        rows = slice(z * chunk, (z + 1) * chunk)
        part = a[rows].t() @ g[rows]
        total = part if total is None else total + part
    return total


def _card_attention_backward(qkv, bias, dout, H, valid_len, scaled_ds):
    """The fp32 attention backward's steps (csrc/qkv_attention_f32.cu): the
    forward's output O and each row's log-sum-exp L; D = rowsum(dO * O); for
    each 64-key tile in ascending order P = exp(S - L), dS = P * (dO V^T -
    D), times the scale in the scaled_ds mode, the tile's dK = dS^T Q and dV
    = P^T dO, dQ += dS K; the scale on dQ and dK at the end otherwise.
    Returns dqkv and dbias, the column sums of dqkv."""
    B, N, three_d = qkv.shape
    hd = three_d // 3 // H
    scale = qkv_attention._scale(hd, torch.float32)
    nv = N if valid_len is None else valid_len
    q, k, v = (qkv + bias).reshape(B, N, 3, H, hd).permute(2, 0, 3, 1, 4)
    s = (q * scale) @ k[..., :nv, :].transpose(-1, -2)
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    out = torch.exp(s - lse) @ v[..., :nv, :]
    do = dout.reshape(B, N, H, hd).permute(0, 2, 1, 3)
    delta = (do * out).sum(dim=-1, keepdim=True)
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    for k0 in range(0, nv, 64):
        keys = slice(k0, min(k0 + 64, nv))
        p = torch.exp(s[..., keys] - lse)
        ds = p * (do @ v[..., keys, :].transpose(-1, -2) - delta)
        if scaled_ds:
            ds = ds * scale
        dk[..., keys, :] = ds.transpose(-1, -2) @ q
        dv[..., keys, :] = p.transpose(-1, -2) @ do
        dq = dq + ds @ k[..., keys, :]
    if not scaled_ds:
        dq, dk = dq * scale, dk * scale
    dqkv = torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4).reshape(B, N, three_d)
    return dqkv, dqkv.sum(dim=(0, 1))


@pytest.mark.parametrize("scaled_ds", [True, False], ids=["scaled_ds", "default"])
@pytest.mark.parametrize("N, hd, valid_len", [(130, 32, 100), (70, 64, None), (1, 64, None)])
def test_card_attention_backward_order_matches_jax_in_both_modes(N, hd, valid_len, scaled_ds):
    """The scaled_ds mode against fused_qkvproj_attention's VJP at w = I
    (qkv = x + b, so dx is dqkv and db its column sums), the default mode
    against fused_qkv_bias_attention's, both JAX kernels in interpret mode
    in fp32; 130 tokens make three key tiles, the last ragged."""
    qkv, bias, dout, H = _attention_inputs(N + 7, N, hd, True, H=2, B=2)
    dqkv, dbias = _card_attention_backward(torch.from_numpy(qkv), torch.from_numpy(bias),
                                           torch.from_numpy(dout), H, valid_len, scaled_ds)
    if scaled_ds:
        eye = jnp.eye(qkv.shape[2], dtype=jnp.float32)
        _, vjp = jax.vjp(lambda a, c: jax_qkvproj_attention(a, eye, c, H, True, True, valid_len),
                         jnp.asarray(qkv), jnp.asarray(bias))
    else:
        _, vjp = jax.vjp(_jax_attention(qkv, bias, H, valid_len), jnp.asarray(qkv),
                         jnp.asarray(bias))
    ref = [np.asarray(g) for g in vjp(jnp.asarray(dout))]
    _assert_close(dqkv.numpy(), ref[0], GRAD_TOL, "dqkv")
    _assert_close(dbias.numpy(), ref[1], GRAD_TOL, "dbias")


# Slice counts: one (no split), two, five (the last slice ragged) and seven
# (the last slice empty: 3 * 37 = 111 rows in chunks of 16).
SLICES = [1, 2, 5, 7]


@pytest.mark.parametrize("slices", SLICES)
def test_attn_proj_card_backward_order_matches_jax(slices):
    """The fp32 attention+projection backward's steps (csrc/attn_proj_f32.cu):
    dO = dy . w, dw = dy^T O split over the rows, db the sums of 64-row
    chunks of dy added in order, then the attention backward on dO; against
    the JAX kernel's VJP in fp32, at hd 32 with a ragged token count and
    valid_len below it."""
    rng = np.random.default_rng(slices)
    B, N, H, hd, valid_len = 3, 37, 2, 32, 33
    D = H * hd
    qkv = rng.standard_normal((B, N, 3 * D)).astype(np.float32)
    w = (rng.standard_normal((D, D)) * D ** -0.5).astype(np.float32)  # (out, in)
    b = (0.5 * rng.standard_normal(D)).astype(np.float32)
    dy = rng.standard_normal((B, N, D)).astype(np.float32)
    dy[:, valid_len:] = 0
    t_qkv, t_w, t_dy = (torch.from_numpy(a) for a in (qkv, w, dy))
    out = fused_qkv_attention_reference(t_qkv, H, True, valid_len).reshape(-1, D)
    dy2 = t_dy.reshape(-1, D)
    d_out = (dy2 @ t_w).reshape(B, N, D)
    dqkv, _ = _card_attention_backward(t_qkv, torch.zeros(3 * D), d_out, H, valid_len, False)
    dw = _split_k(dy2, out, slices)
    db = torch.stack([chunk.sum(dim=0) for chunk in dy2.split(64)]).sum(dim=0)
    _, vjp = jax.vjp(lambda a, c, d: jax_attention_proj(a, c, d, H, True, True, valid_len),
                     jnp.asarray(qkv), jnp.asarray(w.T), jnp.asarray(b))
    ref_dqkv, ref_dw, ref_db = (np.asarray(g) for g in vjp(jnp.asarray(dy)))
    _assert_close(dqkv.numpy(), ref_dqkv, GRAD_TOL, "dqkv")
    _assert_close(dw.numpy(), ref_dw.T, GRAD_TOL, "dw")
    _assert_close(db.numpy(), ref_db, GRAD_TOL, "db")


@pytest.mark.parametrize("slices", SLICES)
def test_qkvproj_attention_card_backward_order_matches_jax(slices):
    """The fp32 projection + attention backward's steps
    (csrc/attention_block_f32.cu): qkv = x . w again, the attention backward
    in the scaled_ds mode with b as its bias (its dbias is db), dx = dqkv .
    w^T, dw = x^T dqkv split over the rows; against the JAX kernel's VJP in
    fp32."""
    rng = np.random.default_rng(10 + slices)
    B, N, d_in, H, hd, valid_len = 3, 37, 64, 3, 32, 30
    D = H * hd
    x = rng.standard_normal((B, N, d_in)).astype(np.float32)
    w = (rng.standard_normal((d_in, 3 * D)) * d_in ** -0.5).astype(np.float32)
    b = (0.5 * rng.standard_normal(3 * D)).astype(np.float32)
    dout = rng.standard_normal((B, N, D)).astype(np.float32)
    dout[:, valid_len:] = 0
    t_x, t_w, t_b, t_dout = (torch.from_numpy(a) for a in (x, w, b, dout))
    qkv = t_x @ t_w
    dqkv, db = _card_attention_backward(qkv, t_b, t_dout, H, valid_len, True)
    dqkv2 = dqkv.reshape(-1, 3 * D)
    dx = (dqkv2 @ t_w.t()).reshape(B, N, d_in)
    dw = _split_k(t_x.reshape(-1, d_in), dqkv2, slices)
    _, vjp = jax.vjp(lambda a, c, d: jax_qkvproj_attention(a, c, d, H, True, True, valid_len),
                     jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    ref = [np.asarray(g) for g in vjp(jnp.asarray(dout))]
    for name, got, want in zip(("dx", "dw", "db"), (dx, dw, db), ref):
        _assert_close(got.numpy(), want, GRAD_TOL, name)


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

"""The profiling script's kernel categories, and its refusal without CUDA."""

import pytest
import torch

from ssl4polyp_tpu_torch import profiling


@pytest.mark.parametrize("kernel, expected", [
    ("qkv_attention_bwd_kernel<32, true>", "attention backward kernel"),
    ("void qkv_attention_kernel<64>(bf16 const*, ...)", "attention forward kernel"),
    ("layernorm_bwd_kernel<16>", "LayerNorm backward kernel"),
    ("layernorm_fwd_kernel<24>", "LayerNorm forward kernel"),
    ("column_sum_kernel", "column sums of the kernels' parameter gradients"),
    ("fc1_gelu_kernel", "fc1+GELU kernel"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<...>",
     "foreach ops (gradient norm and sums)"),
    ("adamw_kernel(AdamWChunk)", "AdamW kernel (one pass, with the compute copy)"),
    ("void attn_proj_kernel<64, 13, false>(bf16 const*, ...)",
     "attention+projection kernel (forward, and the backward's O and dO)"),
    ("dw_product_kernel(CUtensorMap, CUtensorMap, float*, ...)",
     "attention+projection backward: dW kernel"),
    ("(anonymous namespace)::dw_product_kernel(CUtensorMap, CUtensorMap, float*, int, ...)",
     "attention+projection backward: dW kernel"),
    ("void (anonymous namespace)::fc1_gelu_kernel<256, true>(CUtensorMap, CUtensorMap, ...)",
     "fc1+GELU kernel"),
    ("void (anonymous namespace)::qkv_attention_kernel<64, 13>(__nv_bfloat16 const*, ...)",
     "attention forward kernel"),
    ("dy_column_partial_kernel", "column sums of the kernels' parameter gradients"),
    ("(anonymous namespace)::dw_slice_sum_kernel(float4 const*, int, long, float4*)",
     "column sums of the kernels' parameter gradients"),
    ("void (anonymous namespace)::ln_linear_kernel<256>(CUtensorMap, CUtensorMap, ...)",
     "LN+QKV kernel"),
    ("(anonymous namespace)::ln_linear_stats_kernel(__nv_bfloat16 const*, float2*, ...)",
     "LN+QKV kernel"),
    ("void (anonymous namespace)::attn_proj_kernel<64, 13, true>(CUtensorMap, ...)",
     "attention+projection kernel (forward, and the backward's O and dO)"),
    ("(anonymous namespace)::attn_proj_transpose_kernel(__nv_bfloat16 const*, ...)",
     "attention+projection kernel (forward, and the backward's O and dO)"),
    ("void (anonymous namespace)::layernorm_bwd_kernel<3, true>(__nv_bfloat16 const*, ...)",
     "LayerNorm backward kernel"),
    ("void (anonymous namespace)::column_sum_kernel<32>(float const*, int, int, float*)",
     "column sums of the kernels' parameter gradients"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "cuBLAS GEMM"),
    ("nvjet_tst_128x256_64x4_2x1_v_bz_coopA_TNN", "cuBLAS GEMM"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, ...>>", "reductions"),
    ("void at::native::indexSelectLargeIndex<float, long>", "gathers, scatters and sorts"),
    ("Memcpy HtoD (Pageable -> Device)", "copies and casts"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::direct_copy_kernel_cuda>",
     "copies and casts"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>",
     "elementwise"),
    ("void at::native::(anonymous namespace)::distribution_elementwise_grid_stride_kernel",
     "elementwise"),
    ("some_new_kernel", "the rest"),
])
def test_category(kernel, expected):
    assert profiling.category(kernel) == expected


def test_projection_fold_sets_and_restores_the_knob(monkeypatch):
    from ssl4polyp_tpu_torch.ops.attn_proj import attn_proj_fold_enabled

    monkeypatch.delenv("BENCH_ATTN_PROJ", raising=False)
    with profiling.projection_fold(True):
        assert attn_proj_fold_enabled()
        with profiling.projection_fold(False):
            assert not attn_proj_fold_enabled()
        assert attn_proj_fold_enabled()
    assert not attn_proj_fold_enabled() and "BENCH_ATTN_PROJ" not in __import__("os").environ
    assert [fold for _, _, fold in profiling.FINETUNE_CONFIGS] == [False, False, False, True]


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a CUDA device")
def test_main_refuses_without_cuda():
    with pytest.raises(SystemExit, match="no CUDA device"):
        profiling.main([])

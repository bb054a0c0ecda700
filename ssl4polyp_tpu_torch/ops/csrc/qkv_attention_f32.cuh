// The fp32 attention kernels' C entry points (qkv_attention_f32.cu), which
// the fp32 attention+projection and projection+attention kernels
// (attn_proj_f32.cu, attention_block_f32.cu) launch as their attention
// phase.  The arguments are documented beside the definitions.
#pragma once

extern "C" int ssl4polyp_qkv_attention_fwd_f32(const void* qkv, const void* bias, void* out,
                                               void* lse, int B, int N, int H, int head_dim,
                                               int n_valid, float scale, void* stream);

extern "C" int ssl4polyp_qkv_attention_bwd_f32(const void* qkv, const void* bias,
                                               const void* dout, void* out, void* lse,
                                               void* delta, void* dqkv, void* dbias_part,
                                               void* dbias, int part_rows, int B, int N, int H,
                                               int head_dim, int n_valid, float scale,
                                               int scaled_ds, int forward_first, void* stream);

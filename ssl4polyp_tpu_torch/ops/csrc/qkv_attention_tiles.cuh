// The bf16 attention kernels past 256 tokens (qkv_attention_tiles.cu), whose
// C entry points qkv_attention.cu's forward and backward entries call for N
// > 256.  The arguments are documented beside the definitions.
#pragma once

// The most tokens the bf16 kernels that hold a head's whole K and V on chip
// take (attention_core.cuh's SSL4POLYP_FOR_TOKENS ends at 16 key tiles).  The
// library's bf16 entry points of attention, attention with the projection and
// the QKV projection with attention send more to these key tiles.
constexpr int kTilesPast = 256;

extern "C" int ssl4polyp_qkv_attention_tiles_fwd(const void* qkv, const void* bias, void* out,
                                                 int B, int N, int H, int head_dim, int n_valid,
                                                 float scale_c, int softmax_f32, void* stream);

extern "C" int ssl4polyp_qkv_attention_tiles_bwd(const void* qkv, const void* bias,
                                                 const void* dout, void* dqkv, void* stats,
                                                 void* dq_acc, void* dbias_part, void* dbias,
                                                 int B, int N, int H, int head_dim, int n_valid,
                                                 float scale_c, float scale, int softmax_f32,
                                                 int mode, void* stream);

extern "C" int ssl4polyp_qkv_attention_tiles_bwd_plan(int head_dim, int* warps, int* smem_bytes);

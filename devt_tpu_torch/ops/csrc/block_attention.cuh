// The attention launch of the fused blocks' forwards, written once: kernel
// 1 (fused_block_fwd.cu), kernel 7 (attn_half.cu) and kernel 5
// (quant_block_fwd.cu) take it on their qkv scratch.
//
// Per (sequence, head) of the packed qkv (B, S, 3*H*d) in bfloat16: att
// (B, S, H*d) = softmax(q k^T * scale + mask) v normalised after P V, keys
// at or past kv_len masked, and lse at lane h of rows of `lanes` floats
// (kernels 1 and 7: the residual lanes; kernel 5: (B, S, H) scratch, lanes
// = H).  The rule one_shot_on_wgmma (flash_fwd_sm90.cuh) with kv_len as
// the key count picks the body: the one-shot wgmma body in its
// normalise-after instance at head dims 16-64 with at most 256 live keys
// (every main-path shape), else attention_fwd.cuh's streamed body.

#pragma once

#include "attention_fwd.cuh"
#include "flash_fwd_sm90.cuh"

namespace {

template <int HD>
cudaError_t block_attention_bf16(const bf16* qkv, bf16* att, float* lse,
                                 int B, int S, int H, int kv_len, int lanes,
                                 float scale, cudaStream_t stream) {
  if (!one_shot_on_wgmma(1, HD, kv_len))
    return launch_attention_bf16<HD>(qkv, att, lse, B, S, H, kv_len, lanes,
                                     scale, stream);
  return launch_one_shot<false, true>(
      packed_qkv_heads(qkv, att, lse, S, H, HD, kv_len, lanes, scale), B, HD,
      stream);
}

}  // namespace

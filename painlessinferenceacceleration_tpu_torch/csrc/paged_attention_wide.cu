// Paged attention (K2 decode / verify, K3 prefill, K5 per-token e4m3) at
// GPT-J's head dims (256, 256) and DeepSeek's expanded MLA (192, 128): the
// body and its notes are in paged_attention.cuh; a library of its own,
// compiled beside paged_attention.cu.

#include "paged_attention.cuh"

namespace {

cudaError_t pa_dispatch(int mode, PA_PARAMS) {
  if (dk == 256 && dv == 256) return launch_alibi<256, 256>(mode, PA_ARGS);
  if (dk == 192 && dv == 128) return launch_alibi<192, 128>(mode, PA_ARGS);
  return cudaErrorInvalidValue;
}

int pa_smem_bytes(int DK, int DV, int mode) {
  if (DK == 256 && DV == 256) return smem_bytes<256, 256>(mode);
  if (DK == 192 && DV == 128) return smem_bytes<192, 128>(mode);
  return -1;
}

}  // namespace

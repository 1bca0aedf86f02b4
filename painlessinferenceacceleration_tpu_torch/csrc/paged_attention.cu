// Paged attention (K2 decode / verify, K3 prefill, K5 per-token e4m3) at the
// head dims (64, 64) and (128, 128), and (80, 80) / (96, 96) (OPT, BLOOM)
// through the 128-lane build at their own widths: the body and its notes
// are in paged_attention.cuh; paged_attention_wide.cu builds the wider
// pairs.

#include "paged_attention.cuh"

namespace {

cudaError_t pa_dispatch(int mode, PA_PARAMS) {
  if (dk == 64 && dv == 64) return launch_alibi<64, 64>(mode, PA_ARGS);
  if (dk == dv && (dk == 80 || dk == 96 || dk == 128))
    return launch_alibi<128, 128>(mode, PA_ARGS);
  return cudaErrorInvalidValue;
}

int pa_smem_bytes(int DK, int DV, int mode) {
  if (DK == 64 && DV == 64) return smem_bytes<64, 64>(mode);
  if (DK == DV && (DK == 80 || DK == 96 || DK == 128)) return smem_bytes<128, 128>(mode);
  return -1;
}

}  // namespace

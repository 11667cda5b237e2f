// Flash attention for Hopper (sm_90a) at head dims 16, 32 and 64: the C
// entry points over the kernels of flash_attention.cuh (which holds their
// design, error model and bounds).  flash_attention_wide.cu takes 80 and
// 128 (flash_attention_wide.cuh) in a library of its own, so that nvcc
// builds the two side by side; both export the same entry points.
#include "flash_attention.cuh"

extern "C" {

// Returns a cudaError_t (0 on success), kBadHeadDim (-1) for an
// unsupported head dimension, kBadRoute (-2) for a route other than 0 (the
// FFMA P V, the only one at these head dims).  D in {16, 32, 64}; the
// kernel tiles 64 x 64 itself.
int flash_attention_launch(const float* q, const float* k, const float* v,
                           float* out, int BH, int Sq, int Skv, int D,
                           int causal, float scale, int route,
                           void* stream) {
  if (route != 0) return kBadRoute;
  return exact_dispatch<16, 32, 64>(q, k, v, out, BH, Sq, Skv, D, causal,
                                    scale, static_cast<cudaStream_t>(stream));
}

// Sqp, Skvp: the padded lengths, multiples of bq and bk (1..128); kv_len:
// the valid KV positions; codes int16; D in {16, 32, 64}; route 0 (the
// CUDA-core products, the only one here).  s_out, pv_out, pc_out and
// ps_out may be null.
int flash_attention_amm_launch(const float* qf, const float* kf,
                               const float* vf, const short* qc,
                               const short* kc, const short* vc,
                               const float* qs, const float* ks,
                               const float* vs, float* out, float* s_out,
                               float* pv_out, short* pc_out, float* ps_out,
                               int BH, int Sqp, int Skvp, int D, int bq,
                               int bk, int kv_len, int causal, int wl,
                               int vbl, int kind, int R, int chunk,
                               float inv_lim, int route, void* stream) {
  if (route != 0) return kBadRoute;
  const AmmArgs g = make_amm_args(BH, Sqp, Skvp, bq, bk, kv_len, causal, wl,
                                  vbl, R, chunk, inv_lim);
  return amm_dispatch<16, 32, 64>(qf, kf, vf, qc, kc, vc, qs, ks, vs, out,
                                  s_out, pv_out, pc_out, ps_out, g, D, kind,
                                  static_cast<cudaStream_t>(stream));
}

const char* flash_attention_error_string(int err) {
  return error_string(err);
}

}  // extern "C"

// Flash attention for Hopper (sm_90a) at head dims 80 and 128: the C entry
// points over the kernels of flash_attention_wide.cuh (which holds their
// design, error model and bounds).  flash_attention.cu takes 16, 32 and 64
// in a library of its own, so that nvcc builds the two side by side; both
// export the same entry points.
#include "flash_attention_wide.cuh"

extern "C" {

// Returns a cudaError_t (0 on success), kBadHeadDim (-1) for an
// unsupported head dimension, kBadRoute (-2) for an unknown route.  D in
// {80, 128}; route 1: P V in 3xTF32 (the host takes it from 26 keys on), 0:
// P V with FFMA.  The kernel tiles 128 query rows by 32 keys itself.
int flash_attention_launch(const float* q, const float* k, const float* v,
                           float* out, int BH, int Sq, int Skv, int D,
                           int causal, float scale, int route,
                           void* stream) {
  return exact_wide_dispatch<80, 128>(q, k, v, out, BH, Sq, Skv, D, causal,
                                      scale, route,
                                      static_cast<cudaStream_t>(stream));
}

// Sqp, Skvp: the padded lengths, multiples of bq and bk (1..128); kv_len:
// the valid KV positions; codes int16; D in {80, 128}; route 1: the
// integer products on the int8 tensor cores (kBadRoute where x's and bq's
// bytes need a third significance), 0: on the CUDA cores.  s_out, pv_out,
// pc_out and ps_out may be null.
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
  const AmmArgs g = make_amm_args(BH, Sqp, Skvp, bq, bk, kv_len, causal, wl,
                                  vbl, R, chunk, inv_lim);
  return amm_wide_dispatch<80, 128>(qf, kf, vf, qc, kc, vc, qs, ks, vs, out,
                                    s_out, pv_out, pc_out, ps_out, g, D,
                                    kind, route,
                                    static_cast<cudaStream_t>(stream));
}

const char* flash_attention_error_string(int err) {
  return error_string(err);
}

}  // extern "C"

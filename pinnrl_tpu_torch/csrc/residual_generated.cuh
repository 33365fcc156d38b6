// Kernel 1's generated residual: the skeleton around a PDE's residual traced
// by ops/kernels/residual_codegen.py. The emitted translation unit defines
// GEN_STREAMS (S, the stacked output streams [u; per axis u_x..; u_t]),
// GEN_COLS (d + 1, the columns of z) and
//     float gen_residual(const float* U, const float* z, int n, int i, float* g)
// (r at point i, g[s] = dr/dU_s), then includes this file.
//
// Replaces the residual arithmetic that the JAX kernel traces into its Pallas
// body (pinnrl_tpu/ops/kernels/fused_step.py: _tile_residuals, a vmap of
// pde.residual_pointwise over one tile) for a PDE that no hand residual of
// csrc/fused_residual.cu covers. The contract is theirs (burgers_kernel):
// one thread per point; plain, out = r^2 and dU = (2/N) r dr/dU; causal,
// out = r and dU = dr/dU (scaled later by causal_scale_kernel). What bounds
// it: U and z read once and dU and out written once, (2S + d + 2) N floats;
// at the trainer's batches that is a few MB, below a microsecond of the
// card's memory rate, so the launch sets its time.

#include <cuda_runtime.h>

namespace {

__global__ void generated_residual_kernel(const float* __restrict__ U,
                                          const float* __restrict__ z, float* __restrict__ dU,
                                          float* __restrict__ out, int n, float two_over_n,
                                          int causal) {
    // Member blockIdx.y of a deep ensemble's stacked members: its streams,
    // points and outputs (fused_residual.cu's member axis).
    const long long e = blockIdx.y;
    U += e * GEN_STREAMS * n;
    dU += e * GEN_STREAMS * n;
    z += e * GEN_COLS * n;
    out += e * n;
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    float g[GEN_STREAMS];
    const float r = gen_residual(U, z, n, i, g);
    const float c = causal ? 1.0f : two_over_n * r;
    out[i] = causal ? r : r * r;
#pragma unroll
    for (int s = 0; s < GEN_STREAMS; ++s) dU[(long long)s * n + i] = causal ? g[s] : c * g[s];
}

}  // namespace

// U, dU ((GEN_STREAMS n), 1); z (n, GEN_COLS); out (n, 1); each per member.
// Launches on the given stream and returns cudaGetLastError().
extern "C" int gr_residual(const float* U, const float* z, float* dU, float* out, int n,
                           int causal, int members, void* stream) {
    if (members < 1 || members > 65535) return (int)cudaErrorInvalidValue;
    if (n > 0)
        generated_residual_kernel<<<dim3((n + 255) / 256, members), 256, 0,
                                    (cudaStream_t)stream>>>(U, z, dU, out, n, 2.0f / (float)n,
                                                            causal);
    return (int)cudaGetLastError();
}

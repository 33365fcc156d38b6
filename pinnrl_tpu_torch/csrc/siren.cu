// SIREN layer: out = sin(omega * (x @ W + b)), x (n, k), W (k, m), b (m).
//
// Replaces the Pallas kernel pinnrl_tpu/ops/kernels/siren.py
// (_siren_kernel / _pallas_siren, behind siren_layer).
//
// What bounds it on an H100: at the shipped SIREN (124 wide, batch 2048)
// one hidden layer is 2 n k m = 63 MFLOP over ~2 MB of traffic, ~0.9 us of
// FP32 CUDA-core time at the card's peak, so at this size launch latency
// and the card's fill (64 tiles for 132 SMs) dominate, not bytes or FLOPs.
// Design: the shared 64x64x16 FP32 tile of sgemm_f32.cuh (FMA, no TF32,
// every edge guarded: 124 is no multiple of a tile and the first layer has
// k = 2), then bias, scale and sin in the epilogue, so the pre-activation
// never goes to memory. The reverse pass and the jvp rule recompute it in
// plain ops, as the JAX rule does (ops/kernels/siren.py).
// Precision: full-range sinf, never __sinf and never --use_fast_math: at
// omega = 30 the phases reach tens of radians.

#include <cuda_runtime.h>

#include "sgemm_f32.cuh"

namespace {

__global__ void __launch_bounds__(GEMM_THREADS)
siren_kernel(int n, int k, int m, const float* __restrict__ x, const float* __restrict__ W,
             const float* __restrict__ b, float omega, float* __restrict__ out) {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;  // m0: rows of x, n0: features
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    sgemm_tile(n, m, x, k, 1, W, m, 1, m0, n0, 0, k, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = m0 + ty * 4 + i;
        if (row >= n) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int col = n0 + tx * 4 + j;
            if (col >= m) continue;
            out[(long long)row * m + col] = sinf(omega * (acc[i][j] + b[col]));
        }
    }
}

inline unsigned cdiv(long long a, long long c) { return (unsigned)((a + c - 1) / c); }

}  // namespace

// Launches on the given stream and returns cudaGetLastError().
extern "C" int siren_forward(const float* x, const float* W, const float* b, float* out, int n,
                             int k, int m, float omega, void* stream) {
    if (n > 0 && m > 0) {
        dim3 grid(cdiv(m, BN), cdiv(n, BM));
        siren_kernel<<<grid, GEMM_THREADS, 0, (cudaStream_t)stream>>>(n, k, m, x, W, b, omega, out);
    }
    return (int)cudaGetLastError();
}

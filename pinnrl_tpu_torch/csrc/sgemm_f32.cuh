// FP32 tiled GEMM and a warp reduction. Only mlp_score.cu (kernel 4) uses
// them now; kernels 1 and 3 run on the Hopper core of sgemm_sm90.cuh, and
// chip_smoke.py times this tile (through ms_gemm) beside it as the yardstick.
//
// sgemm_tile: one block's 64x64 output tile, 64x64x16 tiles in shared
// memory, a 4x4 register micro-tile per thread, FMA on the CUDA cores (no
// TF32), any strides; kernels add their own epilogue. sgemm_kernel: the
// plain product with an optional bias on the first bias_rows rows and an
// optional split over K.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int GEMM_THREADS = 256;

// acc += the (BM x BN) tile at rows m0.., columns n0.. of
// sum_{k in [kbeg, kend)} A[m*sam + k*sak] * B[k*sbk + n*sbn], by a block of
// GEMM_THREADS threads; thread tid holds rows m0 + 4 (tid / 16) + i and
// columns n0 + 4 (tid % 16) + j. Rows, columns and k past the ends read 0.
__device__ __forceinline__ void sgemm_tile(int M, int N, const float* __restrict__ A, long long sam,
                                           long long sak, const float* __restrict__ B, long long sbk,
                                           long long sbn, int m0, int n0, int kbeg, int kend,
                                           float (&acc)[4][4]) {
    __shared__ float As[BK][BM + 4];
    __shared__ float Bs[BK][BN + 4];
    const int tid = threadIdx.x;
    const int tx = tid % 16, ty = tid / 16;
    const bool a_kfast = (sak == 1);
    const bool b_nfast = (sbn == 1);

    for (int k0 = kbeg; k0 < kend; k0 += BK) {
        for (int i = tid; i < BM * BK; i += GEMM_THREADS) {
            int mm, kk;
            if (a_kfast) { kk = i % BK; mm = i / BK; } else { mm = i % BM; kk = i / BM; }
            const int gm = m0 + mm, gk = k0 + kk;
            As[kk][mm] = (gm < M && gk < kend) ? A[(long long)gm * sam + (long long)gk * sak] : 0.0f;
        }
        for (int i = tid; i < BN * BK; i += GEMM_THREADS) {
            int nn, kk;
            if (b_nfast) { nn = i % BN; kk = i / BN; } else { kk = i % BK; nn = i / BK; }
            const int gn = n0 + nn, gk = k0 + kk;
            Bs[kk][nn] = (gn < N && gk < kend) ? B[(long long)gk * sbk + (long long)gn * sbn] : 0.0f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            float a[4], b[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }
}

// C[m, n] = sum_{k in split} A[m*sam + k*sak] * B[k*sbk + n*sbn] (+ bias[n]
// for m < bias_rows). blockIdx.z is the K split; split z writes to
// C + z * split_stride.

__global__ void __launch_bounds__(GEMM_THREADS)
sgemm_kernel(int M, int N, int K, const float* __restrict__ A, long long sam, long long sak,
             const float* __restrict__ B, long long sbk, long long sbn, float* __restrict__ C,
             long long ldc, const float* __restrict__ bias, int bias_rows, int k_chunk,
             long long split_stride) {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
    const int kbeg = blockIdx.z * k_chunk;
    const int kend = min(K, kbeg + k_chunk);
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    sgemm_tile(M, N, A, sam, sak, B, sbk, sbn, m0, n0, kbeg, kend, acc);
    float* Cz = C + (long long)blockIdx.z * split_stride;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int gm = m0 + ty * 4 + i;
        if (gm >= M) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int gn = n0 + tx * 4 + j;
            if (gn >= N) continue;
            float v = acc[i][j];
            if (bias != nullptr && gm < bias_rows) v += bias[gn];
            Cz[(long long)gm * ldc + gn] = v;
        }
    }
}

__device__ __forceinline__ float warp_sum(float v) {
    // Butterfly: every lane ends with the same value (float + commutes).
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

}  // namespace

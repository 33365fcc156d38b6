// SIREN layer: out = sin(omega * (x @ W + b)), x (n, k), W (k, m), b (m).
//
// Replaces the Pallas kernel pinnrl_tpu/ops/kernels/siren.py
// (_siren_kernel / _pallas_siren, behind siren_layer).
//
// What bounds it on an H100: at the shipped SIREN (124 wide, batch 2048)
// one hidden layer is 2 n k m = 63 MFLOP over ~2 MB of traffic, ~0.9 us of
// FP32 CUDA-core time at the card's peak, so at this size launch latency
// and the card's fill dominate, not bytes or FLOPs. A 64x64 tile gives 64
// blocks for 132 SMs and left half the card idle.
// Design: the 32x32 tile of the GEMM core in sgemm_sm90.cuh (64 threads,
// 4x4 per thread, k in slices of 8 through a 3-slice ring; FMA, no TF32):
// 256 blocks at (2048, 124) -> 124, 628 at (5000, 124) -> 124. x is
// k-contiguous (float4 loads stored transposed), W n-contiguous (cp.async);
// the guarded scalar path takes k = 2 in the first layer and any operand
// that is not 16-byte aligned. Bias, scale and sin run in the epilogue, so
// the pre-activation never goes to memory. The reverse pass and the jvp rule
// recompute it in plain ops, as the JAX rule does (ops/kernels/siren.py).
// Members: blockIdx.z is a deep ensemble's member, with its own x (or a
// shared one, stride 0), W, b and output; each member's blocks do what a
// single call's do (the reference's vmap of this kernel over stacked
// members, one pallas_call with a member axis).
// Precision: full-range sinf, never __sinf and never --use_fast_math: at
// omega = 30 the phases reach tens of radians.

#include <cuda_runtime.h>

#include "sgemm_sm90.cuh"

namespace {

// out[row, col..col+3] = sin(omega (v + b)), float4 stores where aligned.
struct SirenEpi {
    float* out;
    const float* b;
    float omega;
    int m;
    bool vec;
    __device__ __forceinline__ void operator()(int row, int col, const float* v) const {
        float o[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) o[j] = col + j < m ? sinf(omega * (v[j] + b[col + j])) : 0.0f;
        float* c = out + (long long)row * m + col;
        if (vec && col + 3 < m) {
            *reinterpret_cast<float4*>(c) = make_float4(o[0], o[1], o[2], o[3]);
        } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
                if (col + j < m) c[j] = o[j];
        }
    }
};

template <bool VEC>
__global__ void __launch_bounds__(TileSmall::THREADS)
siren_sm90_kernel(int n, int k, int m, const float* __restrict__ x, const float* __restrict__ W,
                  const float* __restrict__ b, float omega, float* __restrict__ out, int vec_store,
                  long long sx, long long sW, long long sb) {
    x += blockIdx.z * sx;
    W += blockIdx.z * sW;
    b += blockIdx.z * sb;
    out += blockIdx.z * (long long)n * m;
    const int m0 = blockIdx.y * TileSmall::BM, n0 = blockIdx.x * TileSmall::BN;  // rows, features
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    gemm_sm90_tile<TileSmall, true, false, VEC>(n, m, x, k, 1, W, m, 1, m0, n0, 0, k, acc);
    gemm_sm90_store<TileSmall>(acc, n, m, m0, n0, SirenEpi{out, b, omega, m, vec_store != 0});
}

inline unsigned cdiv(long long a, long long c) { return (unsigned)((a + c - 1) / c); }

}  // namespace

// Blocks siren_forward launches for an (n, k) x (k, m) layer.
extern "C" int siren_blocks(int n, int m) {
    return (int)(cdiv(m, TileSmall::BN) * cdiv(n, TileSmall::BM));
}

// Launches on the given stream and returns cudaGetLastError(). members: x,
// W, b and out hold that many members at strides sx (0: shared), sW, sb and
// n m.
extern "C" int siren_forward(const float* x, const float* W, const float* b, float* out, int n,
                             int k, int m, float omega, int members, long long sx, long long sW,
                             long long sb, void* stream) {
    if (members < 1 || members > 65535) return (int)cudaErrorInvalidValue;
    if (n > 0 && m > 0) {
        const dim3 grid(cdiv(m, TileSmall::BN), cdiv(n, TileSmall::BM), (unsigned)members);
        const bool vec = sm90_vec_ok(x, 1, k, k) && sm90_vec_ok(W, 1, m, m) && sx % 4 == 0 &&
                         sW % 4 == 0;
        const int vec_store = m % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
        if (vec)
            siren_sm90_kernel<true><<<grid, TileSmall::THREADS, 0, (cudaStream_t)stream>>>(
                n, k, m, x, W, b, omega, out, vec_store, sx, sW, sb);
        else
            siren_sm90_kernel<false><<<grid, TileSmall::THREADS, 0, (cudaStream_t)stream>>>(
                n, k, m, x, W, b, omega, out, vec_store, sx, sW, sb);
    }
    return (int)cudaGetLastError();
}

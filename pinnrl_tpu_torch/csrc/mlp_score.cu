// Fused MLP scorer of the DQN agent: Dense -> LayerNorm -> ReLU, twice,
// then Dense, forward only, in f32:
//
//   H1  = relu(LN(x W1^T + b1))           x (N, d), W1 (h, d)
//   H2  = H1 W2^T + b2                    W2 (h, h)
//   out = relu(LN(H2)) W3^T + b3          W3 (A, h), out (N, A)
//
// LayerNorm uses eps (1e-6, flax's default) and the two-pass variance
// mean((y - mean(y))^2), as the TPU kernel does.
//
// Replaces the Pallas kernel pinnrl_tpu/ops/kernels/mlp.py:75
// (fused_mlp_score, body _mlp_kernel), which keeps all three weight
// matrices and a row block in VMEM. Here the host launches three
// kernels in sequence on torch's current stream (ops/kernels/mlp.py):
//
//   dense_ln_relu_in_kernel  one warp per row: the K = d (2-4) product as
//                            plain FMAs, recomputed in each of the three
//                            passes (mean, variance, write), then LayerNorm
//                            and ReLU; writes H1 (N, h).
//   sgemm_kernel             the FP32 tiled GEMM of sgemm_f32.cuh for H2.
//   ln_relu_head_kernel      one warp per row: LayerNorm and ReLU of H2 and
//                            the dot product with each of W3's A rows,
//                            plus b3; writes out (N, A).
//
// What bounds it on an H100: the middle GEMM, 10000 x 512 x 512 FMAs on the
// FP32 CUDA cores at the adaptive sampler's grid (about 5.2 GFLOP per
// call); the two row passes are memory-bound (H1 and H2 are 20.5 MB each at
// N = 10000, h = 512, and stay in device memory between kernels). A fused
// single-pass version, with the H1 and H2 row blocks held in shared memory,
// and tensor cores are later work.

#include <cuda_runtime.h>

#include "sgemm_f32.cuh"

namespace {

constexpr int ROW_THREADS = 256;  // 8 warps, one row each
constexpr int ROWS_PER_BLOCK = ROW_THREADS / 32;

// y_j = x_row . W1[j, :] + b1[j]
__device__ __forceinline__ float affine_in(const float* __restrict__ xr,
                                           const float* __restrict__ W1,
                                           const float* __restrict__ b1, int d, int j) {
    const float* w = W1 + (long long)j * d;
    float acc = 0.0f;
    for (int k = 0; k < d; ++k) acc = fmaf(xr[k], w[k], acc);
    return acc + b1[j];
}

__global__ void __launch_bounds__(ROW_THREADS)
dense_ln_relu_in_kernel(const float* __restrict__ x, const float* __restrict__ W1,
                        const float* __restrict__ b1, const float* __restrict__ g1,
                        const float* __restrict__ be1, float* __restrict__ H1, int n, int d,
                        int h, float eps) {
    const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= n) return;
    const float* xr = x + (long long)row * d;
    const float fh = (float)h;
    float s = 0.0f;
    for (int j = lane; j < h; j += 32) s += affine_in(xr, W1, b1, d, j);
    const float mean = warp_sum(s) / fh;
    float v = 0.0f;
    for (int j = lane; j < h; j += 32) {
        const float c = affine_in(xr, W1, b1, d, j) - mean;
        v += c * c;
    }
    const float rs = rsqrtf(warp_sum(v) / fh + eps);
    float* out = H1 + (long long)row * h;
    for (int j = lane; j < h; j += 32) {
        const float y = (affine_in(xr, W1, b1, d, j) - mean) * rs * g1[j] + be1[j];
        out[j] = fmaxf(y, 0.0f);
    }
}

__global__ void __launch_bounds__(ROW_THREADS)
ln_relu_head_kernel(const float* __restrict__ H2, const float* __restrict__ g2,
                    const float* __restrict__ be2, const float* __restrict__ W3,
                    const float* __restrict__ b3, float* __restrict__ out, int n, int h,
                    int a_dim, float eps) {
    const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= n) return;
    const float* hr = H2 + (long long)row * h;
    const float fh = (float)h;
    float s = 0.0f;
    for (int j = lane; j < h; j += 32) s += hr[j];
    const float mean = warp_sum(s) / fh;
    float v = 0.0f;
    for (int j = lane; j < h; j += 32) {
        const float c = hr[j] - mean;
        v += c * c;
    }
    const float rs = rsqrtf(warp_sum(v) / fh + eps);
    for (int a = 0; a < a_dim; ++a) {
        const float* w = W3 + (long long)a * h;
        float acc = 0.0f;
        for (int j = lane; j < h; j += 32) {
            const float z = fmaxf((hr[j] - mean) * rs * g2[j] + be2[j], 0.0f);
            acc = fmaf(z, w[j], acc);
        }
        acc = warp_sum(acc);
        if (lane == 0) out[(long long)row * a_dim + a] = acc + b3[a];
    }
}

inline unsigned cdiv(long long a, long long b) { return (unsigned)((a + b - 1) / b); }

}  // namespace

// ------------------------------------------------------- C entry points --
// Each launches on the given stream and returns cudaGetLastError().

extern "C" int ms_dense_ln_relu_in(const float* x, const float* W1, const float* b1,
                                   const float* g1, const float* be1, float* H1, int n, int d,
                                   int h, float eps, void* stream) {
    if (n > 0)
        dense_ln_relu_in_kernel<<<cdiv(n, ROWS_PER_BLOCK), ROW_THREADS, 0, (cudaStream_t)stream>>>(
            x, W1, b1, g1, be1, H1, n, d, h, eps);
    return (int)cudaGetLastError();
}

extern "C" int ms_gemm(int M, int N, int K, const float* A, long long sam, long long sak,
                       const float* B, long long sbk, long long sbn, float* C, long long ldc,
                       const float* bias, int bias_rows, int splits, int k_chunk,
                       long long split_stride, void* stream) {
    if (M > 0 && N > 0) {
        dim3 grid(cdiv(N, BN), cdiv(M, BM), (unsigned)splits);
        sgemm_kernel<<<grid, GEMM_THREADS, 0, (cudaStream_t)stream>>>(
            M, N, K, A, sam, sak, B, sbk, sbn, C, ldc, bias, bias_rows, k_chunk, split_stride);
    }
    return (int)cudaGetLastError();
}

extern "C" int ms_ln_relu_head(const float* H2, const float* g2, const float* be2,
                               const float* W3, const float* b3, float* out, int n, int h,
                               int a_dim, float eps, void* stream) {
    if (n > 0)
        ln_relu_head_kernel<<<cdiv(n, ROWS_PER_BLOCK), ROW_THREADS, 0, (cudaStream_t)stream>>>(
            H2, g2, be2, W3, b3, out, n, h, a_dim, eps);
    return (int)cudaGetLastError();
}

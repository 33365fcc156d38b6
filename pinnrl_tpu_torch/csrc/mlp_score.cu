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
// matrices and a row block in VMEM. Here the host launches four kernels in
// sequence on torch's current stream (ops/kernels/mlp.py: _score):
//
//   dense_ln_relu_in_kernel  one warp per row: the K = d (2-4) product as
//                            plain FMAs into registers, then LayerNorm and
//                            ReLU; writes H1 (N, h) as float4.
//   transpose_kernel         W2 (out, in) -> W2^T (in, out), 32x32 tiles
//                            through shared memory (1 MB at h = 512), every
//                            call: the agent's parameters change every step.
//   gemm_sm90_kernel<..>     the product H1 W2^T on the GEMM core of
//                            sgemm_sm90.cuh (kernel 1's linear-layer GEMM,
//                            ROW_BIAS = false); its epilogue adds b2, or
//                            writes one split's partial.
//   ln_relu_head_kernel      one warp per row: sums the split partials and
//                            b2 in a fixed order, then LayerNorm, ReLU and
//                            the dot product with each of W3's A rows, plus
//                            b3; writes out (N, A).
//
// What bounds it on an H100: the middle product, 10000 x 512 x 512 FMAs at
// the adaptive sampler's grid; with the row passes' arithmetic, 5.36 GFLOP
// per call, 0.0799 ms at the 67 TFLOP/s FP32 peak (TF32 is excluded by the
// port's precision rule). The row passes are bound by bytes: H1 and H2 are
// 20.5 MB each at N = 10000, h = 512.
//
// Design, against the 64x64x16 tile this kernel used first (8 scalar shared
// loads per 16 FFMAs, scalar global loads, one buffer; 17 TFLOP/s):
//   - the product runs on the core's 128x128 tile (8x8 per thread, float4
//     shared loads, a 3-slice cp.async / register ring);
//   - layout: B is W2^T, n-contiguous, so it streams through 16-byte
//     cp.async; only H1 (k-contiguous) takes the register-transpose path
//     (the core's dX layout, not its slower forward layout with both
//     operands transposed);
//   - waves: at N = 10000 the 79 x 4 = 316 tiles fill 1.2 waves of the 264
//     blocks the card holds at two per SM; split in two over K the 632
//     blocks fill 2.4 waves of half the length. The host picks the split
//     (mlp._product_split); the partials (41 MB, inside the 50 MB L2) are
//     summed by the head in a fixed order, with no atomics and no extra
//     launch, so two calls give the same bits;
//   - the row passes hold a row in registers (16 floats per lane at
//     h = 512) and take mean, variance and LayerNorm from there: the first
//     pass computes x W1^T + b1 once from float4 loads of W1, b1, g1, be1
//     (recomputing it per pass from scalar loads, as this kernel first did,
//     took 0.040 ms against its 0.0061 ms write bound); the head reads each
//     partial once as float4, then ReLU and the A dot products. Widths that
//     are no multiple of 4, above 512, d above 4 or unaligned operands take a
//     guarded scalar path in the same kernel (the first pass recomputes
//     there).
// FMA only: no TF32, no tensor cores, no library call.

#include <cuda_runtime.h>

#include "sgemm_sm90.cuh"

namespace {

constexpr int ROW_THREADS = 256;  // 8 warps, one row each
constexpr int ROWS_PER_BLOCK = ROW_THREADS / 32;
constexpr int ROW_V4 = 4;         // float4 per lane in the row passes' register paths: h <= 512
constexpr int TR_TILE = 32;       // transpose tile, TR_TILE x TR_ROWS threads
constexpr int TR_ROWS = 8;

__device__ __forceinline__ float warp_sum(float v) {
    // Butterfly: every lane ends with the same value (float + commutes).
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// y_j = x_row . W1[j, :] + b1[j]
__device__ __forceinline__ float affine_in(const float* __restrict__ xr,
                                           const float* __restrict__ W1,
                                           const float* __restrict__ b1, int d, int j) {
    const float* w = W1 + (long long)j * d;
    float acc = 0.0f;
    for (int k = 0; k < d; ++k) acc = fmaf(xr[k], w[k], acc);
    return acc + b1[j];
}

// D in 1..4: the register path (d == D, h % 4 == 0, h <= 512, W1, b1, g1,
// be1 and H1 16-byte aligned): each lane computes its float4 columns of y
// once into registers (W1's four columns' D weights are D contiguous float4)
// and takes mean, variance and the write from there. D = 0: any shape, the
// affine map recomputed in each of the three passes, scalar loads and stores.
template <int D>
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
    float* out = H1 + (long long)row * h;
    if constexpr (D > 0) {
        const int h4 = h / 4;
        float xv[D];
#pragma unroll
        for (int k = 0; k < D; ++k) xv[k] = xr[k];
        float4 y[ROW_V4];
        float s = 0.0f;
#pragma unroll
        for (int i = 0; i < ROW_V4; ++i) {
            const int q = lane + 32 * i;
            y[i] = make_float4(0.f, 0.f, 0.f, 0.f);
            if (q < h4) {
                float w[4 * D];
#pragma unroll
                for (int m = 0; m < D; ++m) {
                    const float4 t = __ldg(reinterpret_cast<const float4*>(W1 + 4LL * q * D) + m);
                    w[4 * m] = t.x; w[4 * m + 1] = t.y; w[4 * m + 2] = t.z; w[4 * m + 3] = t.w;
                }
                const float4 b = __ldg(reinterpret_cast<const float4*>(b1) + q);
                float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
                for (int c = 0; c < 4; ++c)
#pragma unroll
                    for (int k = 0; k < D; ++k) o[c] = fmaf(xv[k], w[c * D + k], o[c]);
                y[i] = make_float4(o[0] + b.x, o[1] + b.y, o[2] + b.z, o[3] + b.w);
                s += (y[i].x + y[i].y) + (y[i].z + y[i].w);
            }
        }
        const float mean = warp_sum(s) / fh;
        float v = 0.0f;
#pragma unroll
        for (int i = 0; i < ROW_V4; ++i) {
            if (lane + 32 * i < h4) {
                const float cx = y[i].x - mean, cy = y[i].y - mean;
                const float cz = y[i].z - mean, cw = y[i].w - mean;
                v += (cx * cx + cy * cy) + (cz * cz + cw * cw);
            }
        }
        const float rs = rsqrtf(warp_sum(v) / fh + eps);
#pragma unroll
        for (int i = 0; i < ROW_V4; ++i) {
            const int q = lane + 32 * i;
            if (q < h4) {
                const float4 g = __ldg(reinterpret_cast<const float4*>(g1) + q);
                const float4 b = __ldg(reinterpret_cast<const float4*>(be1) + q);
                reinterpret_cast<float4*>(out)[q] =
                    make_float4(fmaxf((y[i].x - mean) * rs * g.x + b.x, 0.0f),
                                fmaxf((y[i].y - mean) * rs * g.y + b.y, 0.0f),
                                fmaxf((y[i].z - mean) * rs * g.z + b.z, 0.0f),
                                fmaxf((y[i].w - mean) * rs * g.w + b.w, 0.0f));
            }
        }
    } else {
        float s = 0.0f;
        for (int j = lane; j < h; j += 32) s += affine_in(xr, W1, b1, d, j);
        const float mean = warp_sum(s) / fh;
        float v = 0.0f;
        for (int j = lane; j < h; j += 32) {
            const float c = affine_in(xr, W1, b1, d, j) - mean;
            v += c * c;
        }
        const float rs = rsqrtf(warp_sum(v) / fh + eps);
        for (int j = lane; j < h; j += 32)
            out[j] = fmaxf((affine_in(xr, W1, b1, d, j) - mean) * rs * g1[j] + be1[j], 0.0f);
    }
}

// WT (cols, rows) = W (rows, cols)^T; coalesced on both sides through a
// padded shared tile.
__global__ void __launch_bounds__(TR_TILE * TR_ROWS)
transpose_kernel(const float* __restrict__ W, float* __restrict__ WT, int rows, int cols) {
    __shared__ float t[TR_TILE][TR_TILE + 1];
    const int r0 = blockIdx.y * TR_TILE, c0 = blockIdx.x * TR_TILE;
    for (int i = threadIdx.y; i < TR_TILE; i += TR_ROWS) {
        const int r = r0 + i, c = c0 + threadIdx.x;
        if (r < rows && c < cols) t[i][threadIdx.x] = W[(long long)r * cols + c];
    }
    __syncthreads();
    for (int i = threadIdx.y; i < TR_TILE; i += TR_ROWS) {
        const int c = c0 + i, r = r0 + threadIdx.x;
        if (c < cols && r < rows) WT[(long long)c * rows + r] = t[threadIdx.x][i];
    }
}

// One row's pre-activation y_j = P_0[j] + ... + P_{splits-1}[j] (+ b2[j]),
// summed in that order on both paths.
__device__ __forceinline__ float head_in(const float* __restrict__ pr, int splits,
                                         long long split_stride, const float* __restrict__ b2,
                                         int j) {
    float y = pr[j];
    for (int s = 1; s < splits; ++s) y += pr[s * split_stride + j];
    return b2 != nullptr ? y + b2[j] : y;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
    return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// P: the product's splits partials (splits, n, h), split_stride apart; b2
// null when the product added it. vec: the register path (h % 4 == 0,
// h <= 32 lanes x ROW_V4 float4 = 512, every operand 16-byte aligned,
// split_stride % 4 == 0).
__global__ void __launch_bounds__(ROW_THREADS)
ln_relu_head_kernel(const float* __restrict__ P, int splits, long long split_stride,
                    const float* __restrict__ b2, const float* __restrict__ g2,
                    const float* __restrict__ be2, const float* __restrict__ W3,
                    const float* __restrict__ b3, float* __restrict__ out, int n, int h,
                    int a_dim, float eps, int vec) {
    const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= n) return;
    const float* pr = P + (long long)row * h;
    const float fh = (float)h;
    if (vec) {
        const int h4 = h / 4;
        float4 z[ROW_V4];
        float s = 0.0f;
#pragma unroll
        for (int i = 0; i < ROW_V4; ++i) {
            const int q = lane + 32 * i;
            z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
            if (q < h4) {
                float4 y = __ldg(reinterpret_cast<const float4*>(pr) + q);
                for (int sp = 1; sp < splits; ++sp)
                    y = add4(y, __ldg(reinterpret_cast<const float4*>(pr + sp * split_stride) + q));
                if (b2 != nullptr) y = add4(y, __ldg(reinterpret_cast<const float4*>(b2) + q));
                z[i] = y;
                s += (y.x + y.y) + (y.z + y.w);
            }
        }
        const float mean = warp_sum(s) / fh;
        float v = 0.0f;
#pragma unroll
        for (int i = 0; i < ROW_V4; ++i) {
            if (lane + 32 * i < h4) {
                const float cx = z[i].x - mean, cy = z[i].y - mean;
                const float cz = z[i].z - mean, cw = z[i].w - mean;
                v += (cx * cx + cy * cy) + (cz * cz + cw * cw);
            }
        }
        const float rs = rsqrtf(warp_sum(v) / fh + eps);
#pragma unroll
        for (int i = 0; i < ROW_V4; ++i) {
            const int q = lane + 32 * i;
            if (q < h4) {
                const float4 g = __ldg(reinterpret_cast<const float4*>(g2) + q);
                const float4 b = __ldg(reinterpret_cast<const float4*>(be2) + q);
                z[i].x = fmaxf((z[i].x - mean) * rs * g.x + b.x, 0.0f);
                z[i].y = fmaxf((z[i].y - mean) * rs * g.y + b.y, 0.0f);
                z[i].z = fmaxf((z[i].z - mean) * rs * g.z + b.z, 0.0f);
                z[i].w = fmaxf((z[i].w - mean) * rs * g.w + b.w, 0.0f);
            }
        }
        for (int a = 0; a < a_dim; ++a) {
            const float4* w = reinterpret_cast<const float4*>(W3 + (long long)a * h);
            float acc = 0.0f;
#pragma unroll
            for (int i = 0; i < ROW_V4; ++i) {
                const int q = lane + 32 * i;
                if (q < h4) {
                    const float4 c = __ldg(w + q);
                    acc = fmaf(z[i].x, c.x, acc);
                    acc = fmaf(z[i].y, c.y, acc);
                    acc = fmaf(z[i].z, c.z, acc);
                    acc = fmaf(z[i].w, c.w, acc);
                }
            }
            acc = warp_sum(acc);
            if (lane == 0) out[(long long)row * a_dim + a] = acc + b3[a];
        }
        return;
    }
    float s = 0.0f;
    for (int j = lane; j < h; j += 32) s += head_in(pr, splits, split_stride, b2, j);
    const float mean = warp_sum(s) / fh;
    float v = 0.0f;
    for (int j = lane; j < h; j += 32) {
        const float c = head_in(pr, splits, split_stride, b2, j) - mean;
        v += c * c;
    }
    const float rs = rsqrtf(warp_sum(v) / fh + eps);
    for (int a = 0; a < a_dim; ++a) {
        const float* w = W3 + (long long)a * h;
        float acc = 0.0f;
        for (int j = lane; j < h; j += 32) {
            const float y = head_in(pr, splits, split_stride, b2, j);
            acc = fmaf(fmaxf((y - mean) * rs * g2[j] + be2[j], 0.0f), w[j], acc);
        }
        acc = warp_sum(acc);
        if (lane == 0) out[(long long)row * a_dim + a] = acc + b3[a];
    }
}

inline unsigned cdiv(long long a, long long b) { return (unsigned)((a + b - 1) / b); }

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// ------------------------------------------------------- C entry points --
// Each launches on the given stream and returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments it does not take).

extern "C" int ms_dense_ln_relu_in(const float* x, const float* W1, const float* b1,
                                   const float* g1, const float* be1, float* H1, int n, int d,
                                   int h, float eps, void* stream) {
    const bool vec = h % 4 == 0 && h <= 128 * ROW_V4 && d >= 1 && d <= 4 && aligned16(W1) &&
                     aligned16(b1) && aligned16(g1) && aligned16(be1) && aligned16(H1);
    const auto launch = [&](auto D) {
        dense_ln_relu_in_kernel<decltype(D)::value>
            <<<cdiv(n, ROWS_PER_BLOCK), ROW_THREADS, 0, (cudaStream_t)stream>>>(
                x, W1, b1, g1, be1, H1, n, d, h, eps);
    };
    using std::integral_constant;
    if (n > 0) {
        switch (vec ? d : 0) {
            case 1: launch(integral_constant<int, 1>{}); break;
            case 2: launch(integral_constant<int, 2>{}); break;
            case 3: launch(integral_constant<int, 3>{}); break;
            case 4: launch(integral_constant<int, 4>{}); break;
            default: launch(integral_constant<int, 0>{});
        }
    }
    return (int)cudaGetLastError();
}

extern "C" int ms_transpose(const float* W, float* WT, int rows, int cols, void* stream) {
    if (rows > 0 && cols > 0) {
        const dim3 grid(cdiv(cols, TR_TILE), cdiv(rows, TR_TILE));
        transpose_kernel<<<grid, dim3(TR_TILE, TR_ROWS), 0, (cudaStream_t)stream>>>(W, WT, rows,
                                                                                  cols);
    }
    return (int)cudaGetLastError();
}

// The core's linear-layer GEMM (sm90_gemm, as fr_gemm, without its row
// test); the scorer's product is H1 (k-contiguous) times W2^T
// (n-contiguous). A bias goes on every row (bias_rows = M) and with one split
// only: each split's epilogue would add it.
extern "C" int ms_gemm(int M, int N, int K, const float* A, long long sam, long long sak,
                       const float* B, long long sbk, long long sbn, float* C, long long ldc,
                       const float* bias, int bias_rows, int splits, int k_chunk,
                       long long split_stride, void* stream) {
    if (splits < 1 || (bias != nullptr && (splits > 1 || bias_rows != M)))
        return (int)cudaErrorInvalidValue;
    sm90_gemm<false>(M, N, K, A, sam, sak, B, sbk, sbn, C, ldc, bias, bias_rows, splits, k_chunk,
                     split_stride, (cudaStream_t)stream);
    return (int)cudaGetLastError();
}

// Thread blocks ms_gemm launches for an (M, N) product in `splits` over K.
extern "C" int ms_gemm_blocks(int M, int N, int splits) {
    const dim3 grid = sm90_grid(M, N, splits);
    return (int)(grid.x * grid.y * grid.z);
}

// P (splits, n, h) partials, split_stride apart; b2 null when the product
// added it.
extern "C" int ms_ln_relu_head(const float* P, int splits, long long split_stride,
                               const float* b2, const float* g2, const float* be2,
                               const float* W3, const float* b3, float* out, int n, int h,
                               int a_dim, float eps, void* stream) {
    if (splits < 1) return (int)cudaErrorInvalidValue;
    const int vec = h % 4 == 0 && h <= 128 * ROW_V4 && split_stride % 4 == 0 && aligned16(P) &&
                    (b2 == nullptr || aligned16(b2)) && aligned16(g2) && aligned16(be2) &&
                    aligned16(W3);
    if (n > 0)
        ln_relu_head_kernel<<<cdiv(n, ROWS_PER_BLOCK), ROW_THREADS, 0, (cudaStream_t)stream>>>(
            P, splits, split_stride, b2, g2, be2, W3, b3, out, n, h, a_dim, eps, vec);
    return (int)cudaGetLastError();
}

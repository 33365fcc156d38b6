// Fused residual loss of the Fourier PINN: loss = mean_i r(z_i)^2 and its
// gradient with respect to every network parameter, for the Burgers residual
// r = u_t + u u_x - nu u_xx.
//
// Replaces the Pallas kernel pinnrl_tpu/ops/kernels/fused_step.py
// (make_fused_residual_loss: _run / _tile_loss, behind the custom-VJP
// fused_loss). The TPU program keeps one batch tile's whole forward and
// backward live set in VMEM and takes the backward from jax.vjp inside the
// kernel. An SM's 227 KB cannot hold that live set (S = 4 stacked streams x
// width 256 x several saved tensors per point), and there is no AD inside a
// CUDA kernel, so the work is split into a few kernels that the host
// launches in sequence on one stream (ops/kernels/fused_step.py):
//
//   embed_kernel          z -> affine map -> [sin, cos] and the closed-form
//                         phase-rotation streams, written as the stacked
//                         (4N, 2m) input [value; d/dx; d2/dx2; d/dt].
//   sgemm_kernel          FP32 tiled GEMM (64x64x16 tiles in shared memory,
//                         4x4 register micro-tile, FMA on the CUDA cores, no
//                         TF32), any strides: the stacked forward X W^T, the
//                         backward dX = dY W and dW = dY^T X (split over K;
//                         the split partials are summed by colsum).
//   transport_fwd_kernel  one warp per point: LayerNorm + tanh Taylor
//                         transport of the 4 streams (ops/jet_mlp.py).
//   transport_bwd_kernel  its hand-derived reverse pass. It recomputes the
//                         forward quantities from the saved pre-activation
//                         instead of storing them, and writes per-point
//                         LayerNorm scale/bias gradient rows.
//   burgers_kernel        r and the stream cotangents 2r/N * dr/d(u, u_x,
//                         u_xx, u_t) = 2r/N * (u_x, u, -nu, 1).
//   colsum_*_kernel       deterministic column sums (fixed-order partials,
//                         then a fixed-order second pass; no float atomics),
//                         so the result is identical from run to run.
//
// What bounds it on an H100: at batch 8192 and width 256 each layer's three
// products are ~32768 x 256 x 256 FMAs; the FP32 CUDA-core GEMMs are
// compute-bound (67 TFLOP/s FP32 peak), while transport, embedding, residual
// and column sums are memory-bound row passes over (4N, 256) tensors. This
// first version keeps every stacked activation in device memory between
// kernels and aims at being right; tensor-core (wgmma/TMA) GEMMs and fusing
// the transport into the GEMM epilogue are later work.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int GEMM_THREADS = 256;
constexpr int COLSUM_ROWS = 256;
constexpr float LN_EPS = 1e-6f;  // flax.linen.LayerNorm default

// ---------------------------------------------------------------- embed --

__global__ void embed_kernel(const float* __restrict__ z, const float* __restrict__ lo,
                             const float* __restrict__ sc, const float* __restrict__ B,
                             float* __restrict__ X, int n, int m, float s) {
    const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= (long long)n * m) return;
    const int row = (int)(idx / m);
    const int j = (int)(idx % m);
    const float w0 = (z[2LL * row] - lo[0]) * sc[0] - 1.0f;
    const float w1 = (z[2LL * row + 1] - lo[1]) * sc[1] - 1.0f;
    const float b0 = B[j];
    const float b1 = B[m + j];
    const float p = s * (w0 * b0 + w1 * b1);
    const float p1x = s * (sc[0] * b0);  // d p / dx (constant over the batch)
    const float p1t = s * (sc[1] * b1);  // d p / dt
    float sn, cs;
    sincosf(p, &sn, &cs);
    const long long w2 = 2LL * m;
    float* r0 = X + (long long)row * w2;
    float* r1 = X + ((long long)n + row) * w2;
    float* r2 = X + (2LL * n + row) * w2;
    float* r3 = X + (3LL * n + row) * w2;
    r0[j] = sn;
    r0[m + j] = cs;
    const float s1 = cs * p1x, c1 = -sn * p1x;
    r1[j] = s1;
    r1[m + j] = c1;
    r2[j] = c1 * p1x;
    r2[m + j] = -s1 * p1x;
    r3[j] = cs * p1t;
    r3[m + j] = -sn * p1t;
}

// ----------------------------------------------------------------- gemm --
// C[m, n] = sum_{k in split} A[m*sam + k*sak] * B[k*sbk + n*sbn] (+ bias[n]
// for m < bias_rows). blockIdx.z is the K split; split z writes to
// C + z * split_stride.

__global__ void __launch_bounds__(GEMM_THREADS)
sgemm_kernel(int M, int N, int K, const float* __restrict__ A, long long sam, long long sak,
             const float* __restrict__ B, long long sbk, long long sbn, float* __restrict__ C,
             long long ldc, const float* __restrict__ bias, int bias_rows, int k_chunk,
             long long split_stride) {
    __shared__ float As[BK][BM + 4];
    __shared__ float Bs[BK][BN + 4];
    const int tid = threadIdx.x;
    const int tx = tid % 16, ty = tid / 16;
    const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
    const int kbeg = blockIdx.z * k_chunk;
    const int kend = min(K, kbeg + k_chunk);
    const bool a_kfast = (sak == 1);
    const bool b_nfast = (sbn == 1);
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

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

// ------------------------------------------------------------ transport --

__device__ __forceinline__ float warp_sum(float v) {
    // Butterfly: every lane ends with the same value (float + commutes).
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// Row statistics of the LayerNorm streams for one point (two-pass, as the
// plain transport computes them).
struct RowStats {
    float mu0, mu1, mu2, mut;
    float r;   // 1 / sqrt(var0 + eps)
    float S1;  // s1 of the x-group  = mean(c0 c1) r
    float V2;  // mean(c1^2 + c0 c2)
    float S2;  // (V2 - S1^2) r
    float St;  // s1 of the t-group  = mean(c0 ct) r
};

__device__ RowStats row_stats(const float* h0, const float* h1, const float* h2,
                              const float* ht, int W, int lane) {
    RowStats st;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, at = 0.f;
    for (int j = lane; j < W; j += 32) { a0 += h0[j]; a1 += h1[j]; a2 += h2[j]; at += ht[j]; }
    const float fw = (float)W;
    st.mu0 = warp_sum(a0) / fw;
    st.mu1 = warp_sum(a1) / fw;
    st.mu2 = warp_sum(a2) / fw;
    st.mut = warp_sum(at) / fw;
    float v0 = 0.f, v01 = 0.f, v2 = 0.f, v0t = 0.f;
    for (int j = lane; j < W; j += 32) {
        const float c0 = h0[j] - st.mu0, c1 = h1[j] - st.mu1;
        const float c2 = h2[j] - st.mu2, ct = ht[j] - st.mut;
        v0 += c0 * c0;
        v01 += c0 * c1;
        v2 += c1 * c1 + c0 * c2;
        v0t += c0 * ct;
    }
    const float var0 = warp_sum(v0) / fw;
    st.r = 1.0f / sqrtf(var0 + LN_EPS);
    st.S1 = (warp_sum(v01) / fw) * st.r;
    st.V2 = warp_sum(v2) / fw;
    st.S2 = (st.V2 - st.S1 * st.S1) * st.r;
    st.St = (warp_sum(v0t) / fw) * st.r;
    return st;
}

// Forward quantities of one element (LayerNorm on).
struct Elem {
    float c0, c1, c2, ct, q0, q1, q2, qt, y0, y1, y2, yt, a0, d1, d2;
};

__device__ __forceinline__ Elem elem_ln(const RowStats& st, float h0, float h1, float h2,
                                        float ht, float g, float b) {
    Elem e;
    e.c0 = h0 - st.mu0; e.c1 = h1 - st.mu1; e.c2 = h2 - st.mu2; e.ct = ht - st.mut;
    e.q0 = e.c0 * st.r;
    e.q1 = (e.c1 - e.q0 * st.S1) * st.r;
    e.q2 = (e.c2 - 2.0f * e.q1 * st.S1 - e.q0 * st.S2) * st.r;
    e.qt = (e.ct - e.q0 * st.St) * st.r;
    e.y0 = e.q0 * g + b;
    e.y1 = e.q1 * g; e.y2 = e.q2 * g; e.yt = e.qt * g;
    e.a0 = tanhf(e.y0);
    e.d1 = 1.0f - e.a0 * e.a0;
    e.d2 = -2.0f * e.a0 * e.d1;
    return e;
}

__device__ __forceinline__ Elem elem_plain(float h0, float h1, float h2, float ht) {
    Elem e;
    e.y0 = h0; e.y1 = h1; e.y2 = h2; e.yt = ht;
    e.a0 = tanhf(e.y0);
    e.d1 = 1.0f - e.a0 * e.a0;
    e.d2 = -2.0f * e.a0 * e.d1;
    return e;
}

// H: stacked (4n, W) pre-activations [value; x1; x2; t1] (bias included).
// A: stacked (4n, W) outputs [tanh; o1; o2; ot].
__global__ void transport_fwd_kernel(const float* __restrict__ H, const float* __restrict__ gamma,
                                     const float* __restrict__ beta, float* __restrict__ A,
                                     int n, int W, int use_ln) {
    const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (warp >= n) return;
    const long long stride = (long long)n * W;
    const float* h0 = H + (long long)warp * W;
    const float* h1 = h0 + stride;
    const float* h2 = h1 + stride;
    const float* ht = h2 + stride;
    float* o0 = A + (long long)warp * W;
    float* o1 = o0 + stride;
    float* o2 = o1 + stride;
    float* ot = o2 + stride;
    RowStats st;
    if (use_ln) st = row_stats(h0, h1, h2, ht, W, lane);
    for (int j = lane; j < W; j += 32) {
        const Elem e = use_ln ? elem_ln(st, h0[j], h1[j], h2[j], ht[j], gamma[j], beta[j])
                              : elem_plain(h0[j], h1[j], h2[j], ht[j]);
        o0[j] = e.a0;
        o1[j] = e.d1 * e.y1;
        o2[j] = e.d1 * e.y2 + e.d2 * e.y1 * e.y1;
        ot[j] = e.d1 * e.yt;
    }
}

// Cotangents of one element before the row reductions (see the derivation
// in ops/kernels/fused_step.py: _transport_bwd_plain).
struct ElemGrad {
    float Gy0, Gy1, Gy2, Gyt;  // cotangents of y0, y1, y2, yt
    float Gq0, Gq1, Gq2, Gqt;  // complete cotangents of the q streams
};

__device__ __forceinline__ ElemGrad elem_grad(const Elem& e, const RowStats& st, float g,
                                              float Ga0, float Go1, float Go2, float Got,
                                              int use_ln) {
    ElemGrad r;
    const float Gd1 = Go1 * e.y1 + Go2 * e.y2 + Got * e.yt;
    const float Gd2 = Go2 * e.y1 * e.y1;
    r.Gy1 = Go1 * e.d1 + 2.0f * Go2 * e.d2 * e.y1;
    r.Gy2 = Go2 * e.d1;
    r.Gyt = Got * e.d1;
    const float Ga = Ga0 - 2.0f * e.a0 * Gd1 + Gd2 * (4.0f * e.a0 * e.a0 - 2.0f * e.d1);
    r.Gy0 = Ga * e.d1;
    if (use_ln) {
        r.Gq2 = r.Gy2 * g;
        r.Gqt = r.Gyt * g;
        r.Gq1 = r.Gy1 * g - 2.0f * r.Gq2 * st.S1 * st.r;
        r.Gq0 = r.Gy0 * g - (r.Gqt * st.St + r.Gq2 * st.S2 + r.Gq1 * st.S1) * st.r;
    }
    return r;
}

struct RowScalars {
    float GSt, GS2, GV2, GS1, Gvar0;
};

// Cotangents of the centred streams c0, c1, c2, ct of one element.
__device__ __forceinline__ void centred_grads(const Elem& e, const ElemGrad& gr,
                                              const RowStats& st, const RowScalars& sc,
                                              float inv_w, float& Gc0, float& Gc1,
                                              float& Gc2, float& Gct) {
    Gc1 = gr.Gq1 * st.r + (2.0f * sc.GV2 * e.c1 + sc.GS1 * st.r * e.c0) * inv_w;
    Gc2 = gr.Gq2 * st.r + sc.GV2 * e.c0 * inv_w;
    Gct = gr.Gqt * st.r + sc.GSt * st.r * e.c0 * inv_w;
    Gc0 = gr.Gq0 * st.r
        + (sc.GSt * st.r * e.ct + sc.GV2 * e.c2 + sc.GS1 * st.r * e.c1 + 2.0f * sc.Gvar0 * e.c0) * inv_w;
}

// GA: stacked (4n, W) cotangents of the transport outputs. Writes GH
// (cotangents of H) and, with LayerNorm, per-point rows of the scale and
// bias gradients (summed over points by colsum afterwards).
__global__ void transport_bwd_kernel(const float* __restrict__ H, const float* __restrict__ gamma,
                                     const float* __restrict__ beta, const float* __restrict__ GA,
                                     float* __restrict__ GH, float* __restrict__ Ggamma,
                                     float* __restrict__ Gbeta, int n, int W, int use_ln) {
    const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (warp >= n) return;
    const long long stride = (long long)n * W;
    const long long base = (long long)warp * W;
    const float* h0 = H + base;
    const float* h1 = h0 + stride;
    const float* h2 = h1 + stride;
    const float* ht = h2 + stride;
    const float* g0 = GA + base;
    const float* g1 = g0 + stride;
    const float* g2 = g1 + stride;
    const float* gt = g2 + stride;
    float* o0 = GH + base;
    float* o1 = o0 + stride;
    float* o2 = o1 + stride;
    float* ot = o2 + stride;

    if (!use_ln) {
        for (int j = lane; j < W; j += 32) {
            const Elem e = elem_plain(h0[j], h1[j], h2[j], ht[j]);
            const ElemGrad gr = elem_grad(e, RowStats{}, 1.0f, g0[j], g1[j], g2[j], gt[j], 0);
            o0[j] = gr.Gy0; o1[j] = gr.Gy1; o2[j] = gr.Gy2; ot[j] = gr.Gyt;
        }
        return;
    }

    const RowStats st = row_stats(h0, h1, h2, ht, W, lane);
    // Pass A: row sums of the q-stream cotangents against the q streams.
    float Rt0 = 0.f, Rtt = 0.f, R21 = 0.f, R20 = 0.f, R22 = 0.f, R10 = 0.f, R11 = 0.f, R00 = 0.f;
    for (int j = lane; j < W; j += 32) {
        const float g = gamma[j];
        const Elem e = elem_ln(st, h0[j], h1[j], h2[j], ht[j], g, beta[j]);
        const ElemGrad gr = elem_grad(e, st, g, g0[j], g1[j], g2[j], gt[j], 1);
        Rt0 += gr.Gqt * e.q0; Rtt += gr.Gqt * e.qt;
        R21 += gr.Gq2 * e.q1; R20 += gr.Gq2 * e.q0; R22 += gr.Gq2 * e.q2;
        R10 += gr.Gq1 * e.q0; R11 += gr.Gq1 * e.q1;
        R00 += gr.Gq0 * e.q0;
        Ggamma[base + j] = gr.Gy0 * e.q0 + gr.Gy1 * e.q1 + gr.Gy2 * e.q2 + gr.Gyt * e.qt;
        Gbeta[base + j] = gr.Gy0;
    }
    Rt0 = warp_sum(Rt0); Rtt = warp_sum(Rtt); R21 = warp_sum(R21); R20 = warp_sum(R20);
    R22 = warp_sum(R22); R10 = warp_sum(R10); R11 = warp_sum(R11); R00 = warp_sum(R00);
    RowScalars sc;
    const float r = st.r;
    sc.GSt = -Rt0 * r;
    sc.GS2 = -R20 * r;
    sc.GV2 = sc.GS2 * r;
    sc.GS1 = -2.0f * R21 * r - 2.0f * st.S1 * r * sc.GS2 - R10 * r;
    const float Gr = (Rtt + R22 + R11 + R00 + sc.GSt * st.St + sc.GS2 * st.S2 + sc.GS1 * st.S1) / r;
    sc.Gvar0 = -0.5f * r * r * r * Gr;
    const float inv_w = 1.0f / (float)W;

    // Pass B: means of the centred-stream cotangents.
    float m0 = 0.f, m1 = 0.f, m2 = 0.f, mt = 0.f;
    for (int j = lane; j < W; j += 32) {
        const float g = gamma[j];
        const Elem e = elem_ln(st, h0[j], h1[j], h2[j], ht[j], g, beta[j]);
        const ElemGrad gr = elem_grad(e, st, g, g0[j], g1[j], g2[j], gt[j], 1);
        float Gc0, Gc1, Gc2, Gct;
        centred_grads(e, gr, st, sc, inv_w, Gc0, Gc1, Gc2, Gct);
        m0 += Gc0; m1 += Gc1; m2 += Gc2; mt += Gct;
    }
    m0 = warp_sum(m0) * inv_w; m1 = warp_sum(m1) * inv_w;
    m2 = warp_sum(m2) * inv_w; mt = warp_sum(mt) * inv_w;

    // Pass C: centring is self-adjoint: G_h = G_c - mean(G_c).
    for (int j = lane; j < W; j += 32) {
        const float g = gamma[j];
        const Elem e = elem_ln(st, h0[j], h1[j], h2[j], ht[j], g, beta[j]);
        const ElemGrad gr = elem_grad(e, st, g, g0[j], g1[j], g2[j], gt[j], 1);
        float Gc0, Gc1, Gc2, Gct;
        centred_grads(e, gr, st, sc, inv_w, Gc0, Gc1, Gc2, Gct);
        o0[j] = Gc0 - m0; o1[j] = Gc1 - m1; o2[j] = Gc2 - m2; ot[j] = Gct - mt;
    }
}

// -------------------------------------------------------------- burgers --
// U: stacked (4n, 1) network outputs [u; u_x; u_xx; u_t] (bias included).

__global__ void burgers_kernel(const float* __restrict__ U, float* __restrict__ dU,
                               float* __restrict__ r2, int n, float nu, float two_over_n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float u = U[i], ux = U[n + i], uxx = U[2 * n + i], ut = U[3 * n + i];
    const float r = (ut + u * ux) - nu * uxx;
    r2[i] = r * r;
    const float c = two_over_n * r;
    dU[i] = c * ux;
    dU[n + i] = c * u;
    dU[2 * n + i] = -c * nu;
    dU[3 * n + i] = c;
}

// --------------------------------------------------------------- colsum --

__global__ void colsum_partial_kernel(const float* __restrict__ A, int rows, int cols,
                                      long long ld, float* __restrict__ partial) {
    __shared__ float sm[8][33];
    const int col = blockIdx.x * 32 + threadIdx.x;
    const int r0 = blockIdx.y * COLSUM_ROWS;
    const int r1 = min(rows, r0 + COLSUM_ROWS);
    float acc = 0.0f;
    if (col < cols)
        for (int r = r0 + threadIdx.y; r < r1; r += 8) acc += A[(long long)r * ld + col];
    sm[threadIdx.y][threadIdx.x] = acc;
    __syncthreads();
    if (threadIdx.y == 0 && col < cols) {
        float s = 0.0f;
#pragma unroll
        for (int k = 0; k < 8; ++k) s += sm[k][threadIdx.x];
        partial[(long long)blockIdx.y * cols + col] = s;
    }
}

__global__ void colsum_final_kernel(const float* __restrict__ partial, int chunks, int cols,
                                    float scale, float* __restrict__ out) {
    const int col = blockIdx.x * blockDim.x + threadIdx.x;
    if (col >= cols) return;
    float s = 0.0f;
    for (int c = 0; c < chunks; ++c) s += partial[(long long)c * cols + col];
    out[col] = s * scale;
}

inline unsigned cdiv(long long a, long long b) { return (unsigned)((a + b - 1) / b); }

}  // namespace

// ------------------------------------------------------- C entry points --
// Each launches on the given stream and returns cudaGetLastError().

extern "C" int fr_embed(const float* z, const float* lo, const float* sc, const float* B,
                        float* X, int n, int m, int two_pi, void* stream) {
    const float s = two_pi ? 6.283185307179586f : 1.0f;
    const long long total = (long long)n * m;
    if (total > 0)
        embed_kernel<<<cdiv(total, 256), 256, 0, (cudaStream_t)stream>>>(z, lo, sc, B, X, n, m, s);
    return (int)cudaGetLastError();
}

extern "C" int fr_gemm(int M, int N, int K, const float* A, long long sam, long long sak,
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

extern "C" int fr_transport_fwd(const float* H, const float* gamma, const float* beta, float* A,
                                int n, int W, int use_ln, void* stream) {
    if (n > 0)
        transport_fwd_kernel<<<cdiv(n, 8), 256, 0, (cudaStream_t)stream>>>(H, gamma, beta, A, n, W, use_ln);
    return (int)cudaGetLastError();
}

extern "C" int fr_transport_bwd(const float* H, const float* gamma, const float* beta,
                                const float* GA, float* GH, float* Ggamma, float* Gbeta, int n,
                                int W, int use_ln, void* stream) {
    if (n > 0)
        transport_bwd_kernel<<<cdiv(n, 8), 256, 0, (cudaStream_t)stream>>>(
            H, gamma, beta, GA, GH, Ggamma, Gbeta, n, W, use_ln);
    return (int)cudaGetLastError();
}

extern "C" int fr_burgers(const float* U, float* dU, float* r2, int n, float nu, void* stream) {
    if (n > 0)
        burgers_kernel<<<cdiv(n, 256), 256, 0, (cudaStream_t)stream>>>(U, dU, r2, n, nu, 2.0f / (float)n);
    return (int)cudaGetLastError();
}

extern "C" int fr_colsum(const float* A, int rows, int cols, long long ld, float scale,
                         float* partial, float* out, void* stream) {
    const int chunks = (int)cdiv(rows, COLSUM_ROWS);
    if (cols > 0 && rows > 0) {
        dim3 grid(cdiv(cols, 32), (unsigned)chunks);
        colsum_partial_kernel<<<grid, dim3(32, 8), 0, (cudaStream_t)stream>>>(A, rows, cols, ld, partial);
        colsum_final_kernel<<<cdiv(cols, 256), 256, 0, (cudaStream_t)stream>>>(partial, chunks, cols, scale, out);
    }
    return (int)cudaGetLastError();
}

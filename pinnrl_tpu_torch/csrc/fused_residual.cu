// Fused residual loss of a Fourier or feedforward PINN in one space dimension
// and its gradient with respect to every network parameter, for the residuals
//   Burgers         r = u_t + u u_x - nu u_xx
//   heat            r = u_t - alpha u_xx
//   KdV             r = u_t + 6 u u_x + u_xxx
//   convection      r = u_t + v u_x
//   Allen-Cahn      r = u_t - eps^2 u_xx - u + u^3
//   Black-Scholes   r = V_t - s rate V + s (sigma^2/2 S^2 V_SS + rate S V_S),
//                   S = x, s = +1 (calendar time) or -1 (time to maturity),
// plain (loss = mean_i r_i^2) or causally weighted (loss = sum_i w_i r_i^2 /
// sum_i w_i with w_i = exp(-eps sum_{j<i} r_j^2 / N) over the time-sorted
// batch; the weights carry no gradient).
//
// Replaces the whole of the Pallas kernel pinnrl_tpu/ops/kernels/fused_step.py:277
// (make_fused_residual_loss: _run / _tile_loss, behind the custom-VJP
// fused_loss) in one space dimension: every residual above, spatial order 1
// (convection), 2 or 3 (KdV), causal or not, on either trunk; two space
// dimensions and the moving frame are not ported yet. The TPU program keeps one
// batch tile's whole forward and backward live set in VMEM, takes the
// backward from jax.vjp inside the kernel, and carries the causal prefix
// from one grid step to the next because its grid runs in order on one
// core. An SM's 227 KB cannot hold that live set (S = 4 or 5 stacked streams
// x width 256 x several saved tensors per point), there is no AD inside a
// CUDA kernel, and CTAs run in no order, so the work is split into a few
// kernels that the host launches in sequence on one stream
// (ops/kernels/fused_step.py):
//
//   embed_kernel<K>       z -> affine map -> [sin, cos] and the closed-form
//                         phase-rotation streams, written as the stacked
//                         ((2+K)N, 2m) input [value; x1..xK; t1], K = 1
//                         (convection), 2 (Burgers, heat, Allen-Cahn,
//                         Black-Scholes) or 3 (KdV).
//   affine_input_kernel   the feedforward trunk's ((2+K)N, 2) input: the
//                         affine map and its constant direction rows; the
//                         first GEMM then has two input columns (the core's
//                         guarded scalar path).
//   gemm_sm90_kernel<..>  the FP32 GEMM core of sgemm_sm90.cuh (shared with
//                         siren.cu and mlp_score.cu): 128x128 tiles, 8x8 per thread, a 3-slice
//                         cp.async / register ring, FMA on the CUDA cores, no
//                         TF32, templated on the operands' layouts: the
//                         stacked forward X W^T (A, B k-contiguous), the
//                         backward dX = dY W (B n-contiguous) and
//                         dW = dY^T X (A m-contiguous, split over K; the
//                         split partials are summed by colsum).
//   rowdot_kernel, outer_kernel, colsum_partial_kernel<true>  the output
//                         layer's products (out = 1) as row passes: U = X w + b
//                         one warp per row, dX = dU w an outer product, dW =
//                         dU^T X a weighted deterministic column sum.
//   transport_fwd_kernel<K>  one warp per point: LayerNorm + tanh Taylor
//                         transport of the 2+K streams (ops/jet_mlp.py);
//                         every term of stream 2 sits behind KX >= 2.
//   transport_bwd_kernel<K>  its hand-derived reverse pass (the formulas are
//                         in fused_step.py: _transport_bwd_plain). It
//                         recomputes the forward quantities from the saved
//                         pre-activation instead of storing them, and writes
//                         per-point LayerNorm scale/bias gradient rows.
//   burgers_kernel, heat_kernel, kdv_kernel, convection_kernel,
//   allen_cahn_kernel, black_scholes_kernel  r and the stream cotangents:
//                         plain, r^2 and 2r/N dr/dU; causal, r and the
//                         unscaled dr/dU. black_scholes_kernel reads z (S).
//   causal scan           three deterministic passes over the sorted r^2:
//                         per-block sums, one block's exclusive scan of the
//                         block sums, then each block's local exclusive scan
//                         plus its offset, giving w_i and w_i r_i^2 (expf,
//                         not __expf). causal_scale_kernel then scales dr/dU
//                         by 2 w_i r_i / sum w, read from device memory.
//   colsum_*_kernel       deterministic column sums (fixed-order partials,
//                         then a fixed-order second pass; no float atomics),
//                         so the result is identical from run to run; they
//                         also give sum w and sum w r^2.
//
// What bounds it on an H100: at batch 8192 and width 256 each hidden layer's
// three products are S*8192 x 256 x 256 FMAs, S = 3 (convection), 4 (Burgers,
// heat, Allen-Cahn, Black-Scholes) or 5 (KdV); these FP32 CUDA-core GEMMs are
// bound by operations (67 TFLOP/s FP32 peak) and take most of the device
// time. The GEMM core feeds the FFMA pipes
// with float4 shared loads (4 per 64 FFMAs) and overlaps the next slices'
// loads with the arithmetic (sgemm_sm90.cuh). The output layer's products
// (one column) are bound by bytes, so they skip the tile and stream their
// operand once. Transport, embedding, residual, scan and column sums are
// memory-bound row passes over (S N, 256) tensors in device memory between
// kernels; fusing the transport into the GEMM epilogue is later work.

#include <cuda_runtime.h>

#include "sgemm_sm90.cuh"

namespace {

constexpr int COLSUM_ROWS = 256;
constexpr int SCAN_BLOCK = 1024;   // points per block of the causal scan = threads per block
constexpr float LN_EPS = 1e-6f;    // flax.linen.LayerNorm default
constexpr int ROW_THREADS = 256;   // 8 warps, one row each (rowdot_kernel)

__device__ __forceinline__ float warp_sum(float v) {
    // Butterfly: every lane ends with the same value (float + commutes).
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// ------------------------------------------------- output layer (out = 1) --
// Y[r] = X[r, :] . w (+ b[0] for r < bias_rows), one warp per row;
// vec: X's rows and w allow float4 loads.
__global__ void __launch_bounds__(ROW_THREADS)
rowdot_kernel(const float* __restrict__ X, const float* __restrict__ w,
              const float* __restrict__ b, float* __restrict__ Y, int R, int K, int bias_rows,
              int vec) {
    const int row = blockIdx.x * (ROW_THREADS / 32) + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= R) return;
    const float* x = X + (long long)row * K;
    float s = 0.0f;
    if (vec) {
        const float4* x4 = reinterpret_cast<const float4*>(x);
        const float4* w4 = reinterpret_cast<const float4*>(w);
        for (int j = lane; j < K / 4; j += 32) {
            const float4 a = x4[j], c = __ldg(w4 + j);
            s = fmaf(a.x, c.x, s);
            s = fmaf(a.y, c.y, s);
            s = fmaf(a.z, c.z, s);
            s = fmaf(a.w, c.w, s);
        }
    } else {
        for (int j = lane; j < K; j += 32) s = fmaf(x[j], w[j], s);
    }
    s = warp_sum(s);
    if (lane == 0) Y[row] = (b != nullptr && row < bias_rows) ? s + b[0] : s;
}

// out[r, k] = g[r] * w[k] over (R, K); vec: four columns per thread.
__global__ void outer_kernel(const float* __restrict__ g, const float* __restrict__ w,
                             float* __restrict__ out, int R, int K, int vec) {
    const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (vec) {
        const int kq = K / 4;
        if (idx >= (long long)R * kq) return;
        const int r = (int)(idx / kq), c = (int)(idx % kq) * 4;
        const float gr = g[r];
        const float4 wv = __ldg(reinterpret_cast<const float4*>(w + c));
        *reinterpret_cast<float4*>(out + (long long)r * K + c) =
            make_float4(gr * wv.x, gr * wv.y, gr * wv.z, gr * wv.w);
    } else {
        if (idx >= (long long)R * K) return;
        out[idx] = g[idx / K] * w[idx % K];
    }
}

// ---------------------------------------------------------------- embed --

template <int KX>
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
    const long long stride = (long long)n * w2;
    float* r0 = X + (long long)row * w2;
    r0[j] = sn;
    r0[m + j] = cs;
    // d sin(p) = cos(p) p1 ; d cos(p) = -sin(p) p1, order by order.
    float sk = sn, ck = cs;
#pragma unroll
    for (int k = 1; k <= KX; ++k) {
        const float s_next = ck * p1x, c_next = -sk * p1x;
        sk = s_next;
        ck = c_next;
        float* rk = r0 + k * stride;
        rk[j] = sk;
        rk[m + j] = ck;
    }
    float* rt = r0 + (KX + 1) * stride;
    rt[j] = cs * p1t;
    rt[m + j] = -sn * p1t;
}

// Feedforward trunk: the stacked ((2+KX)n, 2) input [w0; sc_x e_x; 0 x (KX-1);
// sc_t e_t] of the first Dense layer, w0 = (z - lo) sc - 1 (the input map is
// affine, so each direction is a constant row). One thread per point.
__global__ void affine_input_kernel(const float* __restrict__ z, const float* __restrict__ lo,
                                    const float* __restrict__ sc, float* __restrict__ X, int n,
                                    int kx) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float s0 = sc[0], s1 = sc[1];
    const long long stride = 2LL * n;
    float* r = X + 2LL * i;
    r[0] = (z[2LL * i] - lo[0]) * s0 - 1.0f;
    r[1] = (z[2LL * i + 1] - lo[1]) * s1 - 1.0f;
    r[stride] = s0;
    r[stride + 1] = 0.0f;
    for (int k = 2; k <= kx; ++k) {
        r[k * stride] = 0.0f;
        r[k * stride + 1] = 0.0f;
    }
    r[(kx + 1) * stride] = 0.0f;
    r[(kx + 1) * stride + 1] = s1;
}

// ------------------------------------------------------------ transport --
// Streams of one point: index 0 the value, 1..KX the x-group, KX+1 = T the
// first t-derivative. h points at the value row; stream s is h[s * stride].

// Row statistics of the LayerNorm streams for one point (two-pass, as the
// plain transport computes them).
template <int KX>
struct RowStats {
    float mu[KX + 2];
    float r;   // 1 / sqrt(var0 + eps)
    float S1;  // s1 of the x-group = mean(c0 c1) r
    float V2;  // mean(c1^2 + c0 c2)            (KX >= 2)
    float S2;  // (V2 - S1^2) r                 (KX >= 2)
    float V3;  // mean(3 c1 c2 + c0 c3)        (KX = 3)
    float S3;  // (V3 - 3 S1 S2) r              (KX = 3)
    float St;  // s1 of the t-group = mean(c0 ct) r
};

template <int KX>
__device__ RowStats<KX> row_stats(const float* h, long long stride, int W, int lane) {
    constexpr int T = KX + 1;
    RowStats<KX> st;
    float a[KX + 2];
#pragma unroll
    for (int s = 0; s <= T; ++s) a[s] = 0.f;
    for (int j = lane; j < W; j += 32) {
#pragma unroll
        for (int s = 0; s <= T; ++s) a[s] += h[s * stride + j];
    }
    const float fw = (float)W;
#pragma unroll
    for (int s = 0; s <= T; ++s) st.mu[s] = warp_sum(a[s]) / fw;
    float v0 = 0.f, v01 = 0.f, v2 = 0.f, v3 = 0.f, v0t = 0.f;
    for (int j = lane; j < W; j += 32) {
        const float c0 = h[j] - st.mu[0], c1 = h[stride + j] - st.mu[1];
        const float ct = h[T * stride + j] - st.mu[T];
        v0 += c0 * c0;
        v01 += c0 * c1;
        v0t += c0 * ct;
        if constexpr (KX >= 2) {
            const float c2 = h[2 * stride + j] - st.mu[2];
            v2 += c1 * c1 + c0 * c2;
            if constexpr (KX >= 3) {
                const float c3 = h[3 * stride + j] - st.mu[3];
                v3 += 3.0f * c1 * c2 + c0 * c3;
            }
        }
    }
    const float var0 = warp_sum(v0) / fw;
    st.r = 1.0f / sqrtf(var0 + LN_EPS);
    st.S1 = (warp_sum(v01) / fw) * st.r;
    st.V2 = 0.f;
    st.S2 = 0.f;
    if constexpr (KX >= 2) {
        st.V2 = warp_sum(v2) / fw;
        st.S2 = (st.V2 - st.S1 * st.S1) * st.r;
    }
    st.St = (warp_sum(v0t) / fw) * st.r;
    st.V3 = 0.f;
    st.S3 = 0.f;
    if constexpr (KX >= 3) {
        st.V3 = warp_sum(v3) / fw;
        st.S3 = (st.V3 - 3.0f * st.S1 * st.S2) * st.r;
    }
    return st;
}

// Forward quantities of one element.
template <int KX>
struct Elem {
    float c[KX + 2], q[KX + 2], y[KX + 2];
    float a0, d1, d2, d3;
};

template <int KX>
__device__ __forceinline__ void activate(Elem<KX>& e) {
    e.a0 = tanhf(e.y[0]);
    e.d1 = 1.0f - e.a0 * e.a0;
    e.d2 = -2.0f * e.a0 * e.d1;
    e.d3 = 0.f;
    if constexpr (KX >= 3) e.d3 = -2.0f * e.d1 * (1.0f - 3.0f * e.a0 * e.a0);
}

template <int KX>
__device__ __forceinline__ Elem<KX> elem_ln(const RowStats<KX>& st, const float* hv, float g,
                                            float b) {
    constexpr int T = KX + 1;
    Elem<KX> e;
#pragma unroll
    for (int s = 0; s <= T; ++s) e.c[s] = hv[s] - st.mu[s];
    e.q[0] = e.c[0] * st.r;
    e.q[1] = (e.c[1] - e.q[0] * st.S1) * st.r;
    if constexpr (KX >= 2) e.q[2] = (e.c[2] - 2.0f * e.q[1] * st.S1 - e.q[0] * st.S2) * st.r;
    if constexpr (KX >= 3)
        e.q[3] = (e.c[3] - 3.0f * e.q[2] * st.S1 - 3.0f * e.q[1] * st.S2 - e.q[0] * st.S3) * st.r;
    e.q[T] = (e.c[T] - e.q[0] * st.St) * st.r;
    e.y[0] = e.q[0] * g + b;
#pragma unroll
    for (int s = 1; s <= T; ++s) e.y[s] = e.q[s] * g;
    activate(e);
    return e;
}

template <int KX>
__device__ __forceinline__ Elem<KX> elem_plain(const float* hv) {
    Elem<KX> e;
#pragma unroll
    for (int s = 0; s <= KX + 1; ++s) e.y[s] = hv[s];
    activate(e);
    return e;
}

template <int KX>
__device__ __forceinline__ void load_streams(const float* p, long long stride, int j, float* v) {
#pragma unroll
    for (int s = 0; s <= KX + 1; ++s) v[s] = p[s * stride + j];
}

// H: stacked ((2+KX)n, W) pre-activations [value; x1..xKX; t1] (bias
// included). A: the stacked outputs [tanh; o1..oKX; ot].
template <int KX>
__global__ void transport_fwd_kernel(const float* __restrict__ H, const float* __restrict__ gamma,
                                     const float* __restrict__ beta, float* __restrict__ A,
                                     int n, int W, int use_ln) {
    constexpr int T = KX + 1;
    const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (warp >= n) return;
    const long long stride = (long long)n * W;
    const float* h = H + (long long)warp * W;
    float* o = A + (long long)warp * W;
    RowStats<KX> st;
    if (use_ln) st = row_stats<KX>(h, stride, W, lane);
    for (int j = lane; j < W; j += 32) {
        float hv[KX + 2];
        load_streams<KX>(h, stride, j, hv);
        const Elem<KX> e = use_ln ? elem_ln<KX>(st, hv, gamma[j], beta[j]) : elem_plain<KX>(hv);
        o[j] = e.a0;
        o[stride + j] = e.d1 * e.y[1];
        if constexpr (KX >= 2) o[2 * stride + j] = e.d1 * e.y[2] + e.d2 * e.y[1] * e.y[1];
        if constexpr (KX >= 3)
            o[3 * stride + j] = e.d1 * e.y[3] + 3.0f * e.d2 * e.y[1] * e.y[2]
                              + e.d3 * e.y[1] * e.y[1] * e.y[1];
        o[T * stride + j] = e.d1 * e.y[T];
    }
}

// Cotangents of one element before the row reductions (see the derivation
// in ops/kernels/fused_step.py: _transport_bwd_plain).
template <int KX>
struct ElemGrad {
    float Gy[KX + 2];  // cotangents of the y streams
    float Gq[KX + 2];  // complete cotangents of the q streams (LayerNorm on)
};

template <int KX>
__device__ __forceinline__ ElemGrad<KX> elem_grad(const Elem<KX>& e, const RowStats<KX>& st,
                                                  float g, const float* Go, int use_ln) {
    constexpr int T = KX + 1;
    ElemGrad<KX> r;
    float Ga;
    if constexpr (KX >= 2) {
        const float Gd1 = Go[1] * e.y[1] + Go[2] * e.y[2] + Go[T] * e.y[T];
        const float Gd2 = Go[2] * e.y[1] * e.y[1];
        r.Gy[1] = Go[1] * e.d1 + 2.0f * Go[2] * e.d2 * e.y[1];
        r.Gy[2] = Go[2] * e.d1;
        Ga = Go[0] - 2.0f * e.a0 * Gd1 + Gd2 * (4.0f * e.a0 * e.a0 - 2.0f * e.d1);
    } else {
        const float Gd1 = Go[1] * e.y[1] + Go[T] * e.y[T];
        r.Gy[1] = Go[1] * e.d1;
        Ga = Go[0] - 2.0f * e.a0 * Gd1;
    }
    r.Gy[T] = Go[T] * e.d1;
    if constexpr (KX >= 3) {
        const float Go3 = Go[3];
        const float y1 = e.y[1], y2 = e.y[2], a0 = e.a0;
        Ga = Ga + Go3 * (-2.0f * a0 * e.y[3] + 3.0f * y1 * y2 * (4.0f * a0 * a0 - 2.0f * e.d1)
                         + y1 * y1 * y1 * (4.0f * a0 * (1.0f - 3.0f * a0 * a0) + 12.0f * a0 * e.d1));
        r.Gy[1] = r.Gy[1] + Go3 * (3.0f * e.d2 * y2 + 3.0f * e.d3 * y1 * y1);
        r.Gy[2] = r.Gy[2] + 3.0f * Go3 * e.d2 * y1;
        r.Gy[3] = Go3 * e.d1;
    }
    r.Gy[0] = Ga * e.d1;
    if (use_ln) {
        r.Gq[T] = r.Gy[T] * g;
        if constexpr (KX >= 3) {
            r.Gq[3] = r.Gy[3] * g;
            r.Gq[2] = r.Gy[2] * g - 3.0f * r.Gq[3] * st.S1 * st.r;
            r.Gq[1] = r.Gy[1] * g - 2.0f * r.Gq[2] * st.S1 * st.r - 3.0f * r.Gq[3] * st.S2 * st.r;
            r.Gq[0] = r.Gy[0] * g
                    - (r.Gq[T] * st.St + r.Gq[3] * st.S3 + r.Gq[2] * st.S2 + r.Gq[1] * st.S1) * st.r;
        } else if constexpr (KX == 2) {
            r.Gq[2] = r.Gy[2] * g;
            r.Gq[1] = r.Gy[1] * g - 2.0f * r.Gq[2] * st.S1 * st.r;
            r.Gq[0] = r.Gy[0] * g - (r.Gq[T] * st.St + r.Gq[2] * st.S2 + r.Gq[1] * st.S1) * st.r;
        } else {
            r.Gq[1] = r.Gy[1] * g;
            r.Gq[0] = r.Gy[0] * g - (r.Gq[T] * st.St + r.Gq[1] * st.S1) * st.r;
        }
    }
    return r;
}

struct RowScalars {
    float GSt, GS1, GS2, GS3, GV2, GV3, Gvar0;
};

// Cotangents of the centred streams c of one element.
template <int KX>
__device__ __forceinline__ void centred_grads(const Elem<KX>& e, const ElemGrad<KX>& gr,
                                              const RowStats<KX>& st, const RowScalars& sc,
                                              float inv_w, float* Gc) {
    constexpr int T = KX + 1;
    const float r = st.r;
    Gc[T] = gr.Gq[T] * r + sc.GSt * r * e.c[0] * inv_w;
    if constexpr (KX >= 2) {
        Gc[1] = gr.Gq[1] * r + (2.0f * sc.GV2 * e.c[1] + sc.GS1 * r * e.c[0]) * inv_w;
        Gc[2] = gr.Gq[2] * r + sc.GV2 * e.c[0] * inv_w;
        Gc[0] = gr.Gq[0] * r
              + (sc.GSt * r * e.c[T] + sc.GV2 * e.c[2] + sc.GS1 * r * e.c[1]
                 + 2.0f * sc.Gvar0 * e.c[0]) * inv_w;
    } else {
        Gc[1] = gr.Gq[1] * r + sc.GS1 * r * e.c[0] * inv_w;
        Gc[0] = gr.Gq[0] * r
              + (sc.GSt * r * e.c[T] + sc.GS1 * r * e.c[1] + 2.0f * sc.Gvar0 * e.c[0]) * inv_w;
    }
    if constexpr (KX >= 3) {
        Gc[0] = Gc[0] + sc.GV3 * e.c[3] * inv_w;
        Gc[1] = Gc[1] + 3.0f * sc.GV3 * e.c[2] * inv_w;
        Gc[2] = Gc[2] + 3.0f * sc.GV3 * e.c[1] * inv_w;
        Gc[3] = gr.Gq[3] * r + sc.GV3 * e.c[0] * inv_w;
    }
}

// GA: stacked ((2+KX)n, W) cotangents of the transport outputs. Writes GH
// (cotangents of H) and, with LayerNorm, per-point rows of the scale and
// bias gradients (summed over points by colsum afterwards).
template <int KX>
__global__ void transport_bwd_kernel(const float* __restrict__ H, const float* __restrict__ gamma,
                                     const float* __restrict__ beta, const float* __restrict__ GA,
                                     float* __restrict__ GH, float* __restrict__ Ggamma,
                                     float* __restrict__ Gbeta, int n, int W, int use_ln) {
    constexpr int T = KX + 1;
    const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (warp >= n) return;
    const long long stride = (long long)n * W;
    const long long base = (long long)warp * W;
    const float* h = H + base;
    const float* ga = GA + base;
    float* o = GH + base;

    if (!use_ln) {
        for (int j = lane; j < W; j += 32) {
            float hv[KX + 2], Go[KX + 2];
            load_streams<KX>(h, stride, j, hv);
            load_streams<KX>(ga, stride, j, Go);
            const Elem<KX> e = elem_plain<KX>(hv);
            const ElemGrad<KX> gr = elem_grad<KX>(e, RowStats<KX>{}, 1.0f, Go, 0);
#pragma unroll
            for (int s = 0; s <= T; ++s) o[s * stride + j] = gr.Gy[s];
        }
        return;
    }

    const RowStats<KX> st = row_stats<KX>(h, stride, W, lane);
    // Pass A: row sums of the q-stream cotangents against the q streams.
    float R00 = 0.f, R10 = 0.f, R11 = 0.f, R20 = 0.f, R21 = 0.f, R22 = 0.f, Rt0 = 0.f, Rtt = 0.f;
    float R30 = 0.f, R31 = 0.f, R32 = 0.f, R33 = 0.f;
    for (int j = lane; j < W; j += 32) {
        const float g = gamma[j];
        float hv[KX + 2], Go[KX + 2];
        load_streams<KX>(h, stride, j, hv);
        load_streams<KX>(ga, stride, j, Go);
        const Elem<KX> e = elem_ln<KX>(st, hv, g, beta[j]);
        const ElemGrad<KX> gr = elem_grad<KX>(e, st, g, Go, 1);
        Rt0 += gr.Gq[T] * e.q[0]; Rtt += gr.Gq[T] * e.q[T];
        if constexpr (KX >= 2) {
            R21 += gr.Gq[2] * e.q[1]; R20 += gr.Gq[2] * e.q[0]; R22 += gr.Gq[2] * e.q[2];
        }
        R10 += gr.Gq[1] * e.q[0]; R11 += gr.Gq[1] * e.q[1];
        R00 += gr.Gq[0] * e.q[0];
        if constexpr (KX >= 3) {
            R30 += gr.Gq[3] * e.q[0]; R31 += gr.Gq[3] * e.q[1];
            R32 += gr.Gq[3] * e.q[2]; R33 += gr.Gq[3] * e.q[3];
        }
        float gg = 0.f;
#pragma unroll
        for (int s = 0; s <= T; ++s) gg += gr.Gy[s] * e.q[s];
        Ggamma[base + j] = gg;
        Gbeta[base + j] = gr.Gy[0];
    }
    Rt0 = warp_sum(Rt0); Rtt = warp_sum(Rtt);
    R10 = warp_sum(R10); R11 = warp_sum(R11); R00 = warp_sum(R00);
    RowScalars sc;
    const float r = st.r;
    sc.GSt = -Rt0 * r;
    sc.GS2 = 0.f;
    sc.GS1 = -R10 * r;
    float Rdiag = Rtt + R11 + R00;
    if constexpr (KX >= 2) {
        R21 = warp_sum(R21); R20 = warp_sum(R20); R22 = warp_sum(R22);
        sc.GS2 = -R20 * r;
        sc.GS1 = -2.0f * R21 * r - R10 * r;
        Rdiag = Rtt + R22 + R11 + R00;
    }
    sc.GS3 = 0.f;
    sc.GV3 = 0.f;
    if constexpr (KX >= 3) {
        R30 = warp_sum(R30); R31 = warp_sum(R31); R32 = warp_sum(R32); R33 = warp_sum(R33);
        sc.GS3 = -R30 * r;
        sc.GS2 = sc.GS2 - 3.0f * R31 * r - 3.0f * st.S1 * r * sc.GS3;
        sc.GS1 = sc.GS1 - 3.0f * R32 * r - 3.0f * st.S2 * r * sc.GS3;
        sc.GV3 = sc.GS3 * r;
        Rdiag = Rdiag + R33 + sc.GS3 * st.S3;
    }
    sc.GV2 = sc.GS2 * r;
    float Gr;
    if constexpr (KX >= 2) {
        sc.GS1 = sc.GS1 - 2.0f * st.S1 * r * sc.GS2;
        Gr = (Rdiag + sc.GSt * st.St + sc.GS2 * st.S2 + sc.GS1 * st.S1) / r;
    } else {
        Gr = (Rdiag + sc.GSt * st.St + sc.GS1 * st.S1) / r;
    }
    sc.Gvar0 = -0.5f * r * r * r * Gr;
    const float inv_w = 1.0f / (float)W;

    // Pass B: means of the centred-stream cotangents.
    float m[KX + 2];
#pragma unroll
    for (int s = 0; s <= T; ++s) m[s] = 0.f;
    for (int j = lane; j < W; j += 32) {
        const float g = gamma[j];
        float hv[KX + 2], Go[KX + 2], Gc[KX + 2];
        load_streams<KX>(h, stride, j, hv);
        load_streams<KX>(ga, stride, j, Go);
        const Elem<KX> e = elem_ln<KX>(st, hv, g, beta[j]);
        const ElemGrad<KX> gr = elem_grad<KX>(e, st, g, Go, 1);
        centred_grads<KX>(e, gr, st, sc, inv_w, Gc);
#pragma unroll
        for (int s = 0; s <= T; ++s) m[s] += Gc[s];
    }
#pragma unroll
    for (int s = 0; s <= T; ++s) m[s] = warp_sum(m[s]) * inv_w;

    // Pass C: centring is self-adjoint: G_h = G_c - mean(G_c).
    for (int j = lane; j < W; j += 32) {
        const float g = gamma[j];
        float hv[KX + 2], Go[KX + 2], Gc[KX + 2];
        load_streams<KX>(h, stride, j, hv);
        load_streams<KX>(ga, stride, j, Go);
        const Elem<KX> e = elem_ln<KX>(st, hv, g, beta[j]);
        const ElemGrad<KX> gr = elem_grad<KX>(e, st, g, Go, 1);
        centred_grads<KX>(e, gr, st, sc, inv_w, Gc);
#pragma unroll
        for (int s = 0; s <= T; ++s) o[s * stride + j] = Gc[s] - m[s];
    }
}

// ------------------------------------------------------------ residuals --
// U: stacked network outputs (bias included), Burgers and heat
// [u; u_x; u_xx; u_t], KdV [u; u_x; u_xx; u_xxx; u_t]. Plain: out = r^2, dU = 2r/N dr/dU.
// Causal: out = r, dU = dr/dU (scaled later by causal_scale_kernel).

__global__ void burgers_kernel(const float* __restrict__ U, float* __restrict__ dU,
                               float* __restrict__ out, int n, float nu, float two_over_n,
                               int causal) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float u = U[i], ux = U[n + i], uxx = U[2 * n + i], ut = U[3 * n + i];
    const float r = (ut + u * ux) - nu * uxx;
    if (causal) {
        out[i] = r;
        dU[i] = ux;
        dU[n + i] = u;
        dU[2 * n + i] = -nu;
        dU[3 * n + i] = 1.0f;
        return;
    }
    out[i] = r * r;
    const float c = two_over_n * r;
    dU[i] = c * ux;
    dU[n + i] = c * u;
    dU[2 * n + i] = -c * nu;
    dU[3 * n + i] = c;
}

// Heat: r = u_t - alpha u_xx, linear (dr/du_t = 1, dr/du_xx = -alpha).
__global__ void heat_kernel(const float* __restrict__ U, float* __restrict__ dU,
                            float* __restrict__ out, int n, float alpha, float two_over_n,
                            int causal) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float uxx = U[2 * n + i], ut = U[3 * n + i];
    const float r = ut - alpha * uxx;
    out[i] = causal ? r : r * r;
    const float c = causal ? 1.0f : two_over_n * r;
    dU[i] = 0.0f;
    dU[n + i] = 0.0f;
    dU[2 * n + i] = -c * alpha;
    dU[3 * n + i] = c;
}

__global__ void kdv_kernel(const float* __restrict__ U, float* __restrict__ dU,
                           float* __restrict__ out, int n, float two_over_n, int causal) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float u = U[i], ux = U[n + i], uxxx = U[3 * n + i], ut = U[4 * n + i];
    const float r = ut + 6.0f * u * ux + uxxx;
    out[i] = causal ? r : r * r;
    const float c = causal ? 1.0f : two_over_n * r;
    dU[i] = c * (6.0f * ux);
    dU[n + i] = c * (6.0f * u);
    dU[2 * n + i] = 0.0f;
    dU[3 * n + i] = c;
    dU[4 * n + i] = c;
}

// Convection: r = u_t + v u_x over U = [u; u_x; u_t] (dr/dU = [0, v, 1]).
__global__ void convection_kernel(const float* __restrict__ U, float* __restrict__ dU,
                                  float* __restrict__ out, int n, float v, float two_over_n,
                                  int causal) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float ux = U[n + i], ut = U[2 * n + i];
    const float r = ut + v * ux;
    out[i] = causal ? r : r * r;
    const float c = causal ? 1.0f : two_over_n * r;
    dU[i] = 0.0f;
    dU[n + i] = c * v;
    dU[2 * n + i] = c;
}

// Allen-Cahn: r = u_t - eps^2 u_xx - u + u^3 (dr/dU = [3u^2 - 1, 0, -eps^2, 1]).
__global__ void allen_cahn_kernel(const float* __restrict__ U, float* __restrict__ dU,
                                  float* __restrict__ out, int n, float eps2, float two_over_n,
                                  int causal) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float u = U[i], uxx = U[2 * n + i], ut = U[3 * n + i];
    const float r = ((ut - eps2 * uxx) - u) + u * u * u;
    out[i] = causal ? r : r * r;
    const float c = causal ? 1.0f : two_over_n * r;
    dU[i] = c * (3.0f * u * u - 1.0f);
    dU[n + i] = 0.0f;
    dU[2 * n + i] = -c * eps2;
    dU[3 * n + i] = c;
}

// Black-Scholes with time sign s (+1 calendar, -1 to maturity) and S = z[i, 0]:
// r = V_t - s rate V + s (h S^2 V_SS + rate S V_S), h = sigma^2 / 2
// (dr/dU = [-s rate, s rate S, s h S^2, 1]). The one residual that reads z.
__global__ void black_scholes_kernel(const float* __restrict__ U, const float* __restrict__ z,
                                     float* __restrict__ dU, float* __restrict__ out, int n,
                                     float sign, float half_sigma2, float rate, float two_over_n,
                                     int causal) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float V = U[i], VS = U[n + i], VSS = U[2 * n + i], Vt = U[3 * n + i];
    const float S = z[2LL * i];
    const float cSS = half_sigma2 * (S * S), cS = rate * S;
    const float r = (Vt - (sign * rate) * V) + sign * (cSS * VSS + cS * VS);
    out[i] = causal ? r : r * r;
    const float c = causal ? 1.0f : two_over_n * r;
    dU[i] = -c * (sign * rate);
    dU[n + i] = c * (sign * cS);
    dU[2 * n + i] = c * (sign * cSS);
    dU[3 * n + i] = c;
}

// ---------------------------------------------------------- causal scan --
// Exclusive scan of one value per thread over a block of exactly
// SCAN_BLOCK threads (32 warps), in a fixed order; also returns the block's
// total. warp_tot is shared scratch of 33 floats.
__device__ float block_exclusive_scan(float x, float* warp_tot, float& total) {
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    float incl = x;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += y;
    }
    if (lane == 31) warp_tot[wid] = incl;
    __syncthreads();
    if (wid == 0) {
        const float t = warp_tot[lane];
        float ti = t;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const float y = __shfl_up_sync(0xffffffffu, ti, off);
            if (lane >= off) ti += y;
        }
        float ex = __shfl_up_sync(0xffffffffu, ti, 1);
        if (lane == 0) ex = 0.0f;
        warp_tot[lane] = ex;
        if (lane == 31) warp_tot[32] = ti;
    }
    __syncthreads();
    float ex_in_warp = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) ex_in_warp = 0.0f;
    const float result = warp_tot[wid] + ex_in_warp;
    total = warp_tot[32];
    __syncthreads();  // warp_tot is reused by the caller's next scan
    return result;
}

// Pass 1: sum of r^2 over each block of SCAN_BLOCK points.
__global__ void __launch_bounds__(SCAN_BLOCK)
scan_block_sums_kernel(const float* __restrict__ r, int n, float* __restrict__ sums) {
    __shared__ float warp_tot[33];
    const int i = blockIdx.x * SCAN_BLOCK + threadIdx.x;
    float x = 0.0f;
    if (i < n) {
        const float v = r[i];
        x = v * v;
    }
    float total;
    block_exclusive_scan(x, warp_tot, total);
    if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

// Pass 2: one block turns the block sums into exclusive offsets, in place.
__global__ void __launch_bounds__(SCAN_BLOCK)
scan_offsets_kernel(float* __restrict__ sums, int nb) {
    __shared__ float warp_tot[33];
    float carry = 0.0f;
    for (int first = 0; first < nb; first += SCAN_BLOCK) {
        const int i = first + threadIdx.x;
        const float x = i < nb ? sums[i] : 0.0f;
        float total;
        const float ex = block_exclusive_scan(x, warp_tot, total);
        if (i < nb) sums[i] = carry + ex;
        carry += total;
    }
}

// Pass 3: w_i = exp(-eps cum_i / N) with cum_i = sum_{j<i} r_j^2;
// WR (n, 2) = [w_i, w_i r_i^2].
__global__ void __launch_bounds__(SCAN_BLOCK)
causal_weights_kernel(const float* __restrict__ r, int n, float eps,
                      const float* __restrict__ offsets, float* __restrict__ WR) {
    __shared__ float warp_tot[33];
    const int i = blockIdx.x * SCAN_BLOCK + threadIdx.x;
    float x = 0.0f;
    if (i < n) {
        const float v = r[i];
        x = v * v;
    }
    float total;
    const float ex = block_exclusive_scan(x, warp_tot, total);
    if (i < n) {
        const float cum = offsets[blockIdx.x] + ex;
        const float w = expf((-eps * cum) / (float)n);
        WR[2LL * i] = w;
        WR[2LL * i + 1] = w * x;
    }
}

// dU (S n) <- dU * 2 w_i r_i / sum w, in place; sums[0] = sum w.
__global__ void causal_scale_kernel(float* __restrict__ dU, const float* __restrict__ r,
                                    const float* __restrict__ WR, const float* __restrict__ sums,
                                    int n, int S) {
    const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= (long long)S * n) return;
    const int i = (int)(idx % n);
    dU[idx] *= 2.0f * WR[2LL * i] * r[i] / sums[0];
}

// --------------------------------------------------------------- colsum --

// WEIGHTED: sums g[r] A[r, col] (the output layer's dW), else A[r, col].
template <bool WEIGHTED>
__global__ void colsum_partial_kernel(const float* __restrict__ A, const float* __restrict__ g,
                                      int rows, int cols, long long ld,
                                      float* __restrict__ partial) {
    __shared__ float sm[8][33];
    const int col = blockIdx.x * 32 + threadIdx.x;
    const int r0 = blockIdx.y * COLSUM_ROWS;
    const int r1 = min(rows, r0 + COLSUM_ROWS);
    float acc = 0.0f;
    if (col < cols)
        for (int r = r0 + threadIdx.y; r < r1; r += 8) {
            if constexpr (WEIGHTED)
                acc = fmaf(g[r], A[(long long)r * ld + col], acc);
            else
                acc += A[(long long)r * ld + col];
        }
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
// Each launches on the given stream and returns cudaGetLastError() (or
// cudaErrorInvalidValue for an x-order other than 1, 2 or 3).

inline bool kx_ok(int kx) { return kx >= 1 && kx <= 3; }

extern "C" int fr_embed(const float* z, const float* lo, const float* sc, const float* B,
                        float* X, int n, int m, int two_pi, int kx, void* stream) {
    const float s = two_pi ? 6.283185307179586f : 1.0f;
    const long long total = (long long)n * m;
    if (!kx_ok(kx)) return (int)cudaErrorInvalidValue;
    if (total > 0) {
        const unsigned grid = cdiv(total, 256);
        cudaStream_t st = (cudaStream_t)stream;
        if (kx == 3)
            embed_kernel<3><<<grid, 256, 0, st>>>(z, lo, sc, B, X, n, m, s);
        else if (kx == 2)
            embed_kernel<2><<<grid, 256, 0, st>>>(z, lo, sc, B, X, n, m, s);
        else
            embed_kernel<1><<<grid, 256, 0, st>>>(z, lo, sc, B, X, n, m, s);
    }
    return (int)cudaGetLastError();
}

// X ((2+kx)n, 2): the feedforward trunk's stacked input.
extern "C" int fr_affine_input(const float* z, const float* lo, const float* sc, float* X, int n,
                               int kx, void* stream) {
    if (!kx_ok(kx)) return (int)cudaErrorInvalidValue;
    if (n > 0)
        affine_input_kernel<<<cdiv(n, 256), 256, 0, (cudaStream_t)stream>>>(z, lo, sc, X, n, kx);
    return (int)cudaGetLastError();
}

// The layouts pick the kernel (sm90_gemm): kernel 1's forward (A and B
// k-contiguous), dX (A k-contiguous, B n-contiguous) and dW (A m-contiguous,
// B n-contiguous).
extern "C" int fr_gemm(int M, int N, int K, const float* A, long long sam, long long sak,
                       const float* B, long long sbk, long long sbn, float* C, long long ldc,
                       const float* bias, int bias_rows, int splits, int k_chunk,
                       long long split_stride, void* stream) {
    sm90_gemm<true>(M, N, K, A, sam, sak, B, sbk, sbn, C, ldc, bias, bias_rows, splits, k_chunk,
                    split_stride, (cudaStream_t)stream);
    return (int)cudaGetLastError();
}

// Y (R, 1) = X (R, K) w^T (+ b on the first bias_rows rows).
extern "C" int fr_rowdot(const float* X, const float* w, const float* b, float* Y, int R, int K,
                         int bias_rows, void* stream) {
    const int vec = K % 4 == 0 && (reinterpret_cast<uintptr_t>(X) & 15) == 0 &&
                    (reinterpret_cast<uintptr_t>(w) & 15) == 0;
    if (R > 0)
        rowdot_kernel<<<cdiv(R, ROW_THREADS / 32), ROW_THREADS, 0, (cudaStream_t)stream>>>(
            X, w, b, Y, R, K, bias_rows, vec);
    return (int)cudaGetLastError();
}

// out (R, K) = g (R, 1) w (1, K).
extern "C" int fr_outer(const float* g, const float* w, float* out, int R, int K, void* stream) {
    const int vec = K % 4 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0 &&
                    (reinterpret_cast<uintptr_t>(out) & 15) == 0;
    const long long total = (long long)R * (vec ? K / 4 : K);
    if (total > 0)
        outer_kernel<<<cdiv(total, 256), 256, 0, (cudaStream_t)stream>>>(g, w, out, R, K, vec);
    return (int)cudaGetLastError();
}

extern "C" int fr_transport_fwd(const float* H, const float* gamma, const float* beta, float* A,
                                int n, int W, int use_ln, int kx, void* stream) {
    if (!kx_ok(kx)) return (int)cudaErrorInvalidValue;
    if (n > 0) {
        cudaStream_t st = (cudaStream_t)stream;
        if (kx == 3)
            transport_fwd_kernel<3><<<cdiv(n, 8), 256, 0, st>>>(H, gamma, beta, A, n, W, use_ln);
        else if (kx == 2)
            transport_fwd_kernel<2><<<cdiv(n, 8), 256, 0, st>>>(H, gamma, beta, A, n, W, use_ln);
        else
            transport_fwd_kernel<1><<<cdiv(n, 8), 256, 0, st>>>(H, gamma, beta, A, n, W, use_ln);
    }
    return (int)cudaGetLastError();
}

extern "C" int fr_transport_bwd(const float* H, const float* gamma, const float* beta,
                                const float* GA, float* GH, float* Ggamma, float* Gbeta, int n,
                                int W, int use_ln, int kx, void* stream) {
    if (!kx_ok(kx)) return (int)cudaErrorInvalidValue;
    if (n > 0) {
        cudaStream_t st = (cudaStream_t)stream;
        if (kx == 3)
            transport_bwd_kernel<3><<<cdiv(n, 8), 256, 0, st>>>(H, gamma, beta, GA, GH, Ggamma,
                                                                Gbeta, n, W, use_ln);
        else if (kx == 2)
            transport_bwd_kernel<2><<<cdiv(n, 8), 256, 0, st>>>(H, gamma, beta, GA, GH, Ggamma,
                                                                Gbeta, n, W, use_ln);
        else
            transport_bwd_kernel<1><<<cdiv(n, 8), 256, 0, st>>>(H, gamma, beta, GA, GH, Ggamma,
                                                                Gbeta, n, W, use_ln);
    }
    return (int)cudaGetLastError();
}

extern "C" int fr_burgers(const float* U, float* dU, float* out, int n, float nu, int causal,
                          void* stream) {
    if (n > 0)
        burgers_kernel<<<cdiv(n, 256), 256, 0, (cudaStream_t)stream>>>(U, dU, out, n, nu,
                                                                       2.0f / (float)n, causal);
    return (int)cudaGetLastError();
}

extern "C" int fr_heat(const float* U, float* dU, float* out, int n, float alpha, int causal,
                       void* stream) {
    if (n > 0)
        heat_kernel<<<cdiv(n, 256), 256, 0, (cudaStream_t)stream>>>(U, dU, out, n, alpha,
                                                                    2.0f / (float)n, causal);
    return (int)cudaGetLastError();
}

extern "C" int fr_kdv(const float* U, float* dU, float* out, int n, int causal, void* stream) {
    if (n > 0)
        kdv_kernel<<<cdiv(n, 256), 256, 0, (cudaStream_t)stream>>>(U, dU, out, n, 2.0f / (float)n,
                                                                   causal);
    return (int)cudaGetLastError();
}

extern "C" int fr_convection(const float* U, float* dU, float* out, int n, float v, int causal,
                             void* stream) {
    if (n > 0)
        convection_kernel<<<cdiv(n, 256), 256, 0, (cudaStream_t)stream>>>(U, dU, out, n, v,
                                                                          2.0f / (float)n, causal);
    return (int)cudaGetLastError();
}

extern "C" int fr_allen_cahn(const float* U, float* dU, float* out, int n, float eps2, int causal,
                             void* stream) {
    if (n > 0)
        allen_cahn_kernel<<<cdiv(n, 256), 256, 0, (cudaStream_t)stream>>>(U, dU, out, n, eps2,
                                                                          2.0f / (float)n, causal);
    return (int)cudaGetLastError();
}

// z: the (n, 2) points, S = z[i, 0].
extern "C" int fr_black_scholes(const float* U, const float* z, float* dU, float* out, int n,
                                float sign, float half_sigma2, float rate, int causal,
                                void* stream) {
    if (n > 0)
        black_scholes_kernel<<<cdiv(n, 256), 256, 0, (cudaStream_t)stream>>>(
            U, z, dU, out, n, sign, half_sigma2, rate, 2.0f / (float)n, causal);
    return (int)cudaGetLastError();
}

// block_sums: scratch of ceil(n / SCAN_BLOCK) floats; WR: (n, 2) output.
extern "C" int fr_causal_weights(const float* r, int n, float eps, float* block_sums, float* WR,
                                 void* stream) {
    if (n > 0) {
        const int nb = (int)cdiv(n, SCAN_BLOCK);
        cudaStream_t st = (cudaStream_t)stream;
        scan_block_sums_kernel<<<nb, SCAN_BLOCK, 0, st>>>(r, n, block_sums);
        scan_offsets_kernel<<<1, SCAN_BLOCK, 0, st>>>(block_sums, nb);
        causal_weights_kernel<<<nb, SCAN_BLOCK, 0, st>>>(r, n, eps, block_sums, WR);
    }
    return (int)cudaGetLastError();
}

extern "C" int fr_causal_scale(float* dU, const float* r, const float* WR, const float* sums,
                               int n, int S, void* stream) {
    const long long total = (long long)S * n;
    if (total > 0)
        causal_scale_kernel<<<cdiv(total, 256), 256, 0, (cudaStream_t)stream>>>(dU, r, WR, sums, n, S);
    return (int)cudaGetLastError();
}

extern "C" int fr_colsum(const float* A, int rows, int cols, long long ld, float scale,
                         float* partial, float* out, void* stream) {
    const int chunks = (int)cdiv(rows, COLSUM_ROWS);
    if (cols > 0 && rows > 0) {
        dim3 grid(cdiv(cols, 32), (unsigned)chunks);
        colsum_partial_kernel<false><<<grid, dim3(32, 8), 0, (cudaStream_t)stream>>>(
            A, nullptr, rows, cols, ld, partial);
        colsum_final_kernel<<<cdiv(cols, 256), 256, 0, (cudaStream_t)stream>>>(partial, chunks, cols, scale, out);
    }
    return (int)cudaGetLastError();
}

// out (cols) = sum_r g[r] A[r, :], the fixed-order two passes of fr_colsum;
// partial: ceil(rows / COLSUM_ROWS) x cols scratch.
extern "C" int fr_wcolsum(const float* g, const float* A, int rows, int cols, long long ld,
                          float* partial, float* out, void* stream) {
    const int chunks = (int)cdiv(rows, COLSUM_ROWS);
    if (cols > 0 && rows > 0) {
        dim3 grid(cdiv(cols, 32), (unsigned)chunks);
        colsum_partial_kernel<true><<<grid, dim3(32, 8), 0, (cudaStream_t)stream>>>(
            A, g, rows, cols, ld, partial);
        colsum_final_kernel<<<cdiv(cols, 256), 256, 0, (cudaStream_t)stream>>>(partial, chunks, cols, 1.0f, out);
    }
    return (int)cudaGetLastError();
}

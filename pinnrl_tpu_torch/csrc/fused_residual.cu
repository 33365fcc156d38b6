// Fused residual loss of the Fourier PINN and its gradient with respect to
// every network parameter, for the Burgers residual r = u_t + u u_x - nu u_xx
// and the KdV residual r = u_t + 6 u u_x + u_xxx, plain (loss = mean_i r_i^2)
// or causally weighted (loss = sum_i w_i r_i^2 / sum_i w_i with
// w_i = exp(-eps sum_{j<i} r_j^2 / N) over the time-sorted batch; the
// weights carry no gradient).
//
// Replaces the whole of the Pallas kernel pinnrl_tpu/ops/kernels/fused_step.py:277
// (make_fused_residual_loss: _run / _tile_loss, behind the custom-VJP
// fused_loss) for Burgers and KdV, causal or not. The TPU program keeps one
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
//                         ((2+K)N, 2m) input [value; x1..xK; t1], K = 2
//                         (Burgers) or 3 (KdV).
//   sgemm_kernel          FP32 tiled GEMM from sgemm_f32.cuh (shared with
//                         mlp_score.cu: 64x64x16 tiles in shared memory, 4x4
//                         register micro-tile, FMA on the CUDA cores, no
//                         TF32), any strides: the stacked forward X W^T, the
//                         backward dX = dY W and dW = dY^T X (split over K;
//                         the split partials are summed by colsum).
//   transport_fwd_kernel<K>  one warp per point: LayerNorm + tanh Taylor
//                         transport of the 2+K streams (ops/jet_mlp.py).
//   transport_bwd_kernel<K>  its hand-derived reverse pass (the formulas are
//                         in fused_step.py: _transport_bwd_plain). It
//                         recomputes the forward quantities from the saved
//                         pre-activation instead of storing them, and writes
//                         per-point LayerNorm scale/bias gradient rows.
//   burgers_kernel, kdv_kernel  r and the stream cotangents: plain, r^2 and
//                         2r/N dr/dU; causal, r and the unscaled dr/dU.
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
// What bounds it on an H100: at batch 8192 and width 256 each layer's three
// products are S*8192 x 256 x 256 FMAs, S = 5 for KdV (40960 rows); these
// FP32 CUDA-core GEMMs are compute-bound (67 TFLOP/s FP32 peak) and take most
// of the device time, while transport, embedding, residual, scan and column
// sums are memory-bound row passes over (S N, 256) tensors. This version
// keeps every stacked activation in device memory between kernels and aims
// at being right; tensor-core (wgmma/TMA) GEMMs and fusing the transport
// into the GEMM epilogue are later work.

#include <cuda_runtime.h>

#include "sgemm_f32.cuh"

namespace {

constexpr int COLSUM_ROWS = 256;
constexpr int SCAN_BLOCK = 1024;   // points per block of the causal scan = threads per block
constexpr float LN_EPS = 1e-6f;    // flax.linen.LayerNorm default

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
    float V2;  // mean(c1^2 + c0 c2)
    float S2;  // (V2 - S1^2) r
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
        const float c2 = h[2 * stride + j] - st.mu[2], ct = h[T * stride + j] - st.mu[T];
        v0 += c0 * c0;
        v01 += c0 * c1;
        v2 += c1 * c1 + c0 * c2;
        v0t += c0 * ct;
        if constexpr (KX >= 3) {
            const float c3 = h[3 * stride + j] - st.mu[3];
            v3 += 3.0f * c1 * c2 + c0 * c3;
        }
    }
    const float var0 = warp_sum(v0) / fw;
    st.r = 1.0f / sqrtf(var0 + LN_EPS);
    st.S1 = (warp_sum(v01) / fw) * st.r;
    st.V2 = warp_sum(v2) / fw;
    st.S2 = (st.V2 - st.S1 * st.S1) * st.r;
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
    e.q[2] = (e.c[2] - 2.0f * e.q[1] * st.S1 - e.q[0] * st.S2) * st.r;
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
        o[2 * stride + j] = e.d1 * e.y[2] + e.d2 * e.y[1] * e.y[1];
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
    const float Gd1 = Go[1] * e.y[1] + Go[2] * e.y[2] + Go[T] * e.y[T];
    const float Gd2 = Go[2] * e.y[1] * e.y[1];
    r.Gy[1] = Go[1] * e.d1 + 2.0f * Go[2] * e.d2 * e.y[1];
    r.Gy[2] = Go[2] * e.d1;
    r.Gy[T] = Go[T] * e.d1;
    float Ga = Go[0] - 2.0f * e.a0 * Gd1 + Gd2 * (4.0f * e.a0 * e.a0 - 2.0f * e.d1);
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
        } else {
            r.Gq[2] = r.Gy[2] * g;
            r.Gq[1] = r.Gy[1] * g - 2.0f * r.Gq[2] * st.S1 * st.r;
            r.Gq[0] = r.Gy[0] * g - (r.Gq[T] * st.St + r.Gq[2] * st.S2 + r.Gq[1] * st.S1) * st.r;
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
    Gc[1] = gr.Gq[1] * r + (2.0f * sc.GV2 * e.c[1] + sc.GS1 * r * e.c[0]) * inv_w;
    Gc[2] = gr.Gq[2] * r + sc.GV2 * e.c[0] * inv_w;
    Gc[T] = gr.Gq[T] * r + sc.GSt * r * e.c[0] * inv_w;
    Gc[0] = gr.Gq[0] * r
          + (sc.GSt * r * e.c[T] + sc.GV2 * e.c[2] + sc.GS1 * r * e.c[1] + 2.0f * sc.Gvar0 * e.c[0])
                * inv_w;
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
        R21 += gr.Gq[2] * e.q[1]; R20 += gr.Gq[2] * e.q[0]; R22 += gr.Gq[2] * e.q[2];
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
    Rt0 = warp_sum(Rt0); Rtt = warp_sum(Rtt); R21 = warp_sum(R21); R20 = warp_sum(R20);
    R22 = warp_sum(R22); R10 = warp_sum(R10); R11 = warp_sum(R11); R00 = warp_sum(R00);
    RowScalars sc;
    const float r = st.r;
    sc.GSt = -Rt0 * r;
    sc.GS2 = -R20 * r;
    sc.GS1 = -2.0f * R21 * r - R10 * r;
    float Rdiag = Rtt + R22 + R11 + R00;
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
    sc.GS1 = sc.GS1 - 2.0f * st.S1 * r * sc.GS2;
    const float Gr = (Rdiag + sc.GSt * st.St + sc.GS2 * st.S2 + sc.GS1 * st.S1) / r;
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
// U: stacked network outputs (bias included), Burgers [u; u_x; u_xx; u_t],
// KdV [u; u_x; u_xx; u_xxx; u_t]. Plain: out = r^2, dU = 2r/N dr/dU.
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
// Each launches on the given stream and returns cudaGetLastError() (or
// cudaErrorInvalidValue for an x-order other than 2 or 3).

extern "C" int fr_embed(const float* z, const float* lo, const float* sc, const float* B,
                        float* X, int n, int m, int two_pi, int kx, void* stream) {
    const float s = two_pi ? 6.283185307179586f : 1.0f;
    const long long total = (long long)n * m;
    if (kx != 2 && kx != 3) return (int)cudaErrorInvalidValue;
    if (total > 0) {
        if (kx == 3)
            embed_kernel<3><<<cdiv(total, 256), 256, 0, (cudaStream_t)stream>>>(z, lo, sc, B, X, n, m, s);
        else
            embed_kernel<2><<<cdiv(total, 256), 256, 0, (cudaStream_t)stream>>>(z, lo, sc, B, X, n, m, s);
    }
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
                                int n, int W, int use_ln, int kx, void* stream) {
    if (kx != 2 && kx != 3) return (int)cudaErrorInvalidValue;
    if (n > 0) {
        if (kx == 3)
            transport_fwd_kernel<3><<<cdiv(n, 8), 256, 0, (cudaStream_t)stream>>>(H, gamma, beta, A, n, W, use_ln);
        else
            transport_fwd_kernel<2><<<cdiv(n, 8), 256, 0, (cudaStream_t)stream>>>(H, gamma, beta, A, n, W, use_ln);
    }
    return (int)cudaGetLastError();
}

extern "C" int fr_transport_bwd(const float* H, const float* gamma, const float* beta,
                                const float* GA, float* GH, float* Ggamma, float* Gbeta, int n,
                                int W, int use_ln, int kx, void* stream) {
    if (kx != 2 && kx != 3) return (int)cudaErrorInvalidValue;
    if (n > 0) {
        if (kx == 3)
            transport_bwd_kernel<3><<<cdiv(n, 8), 256, 0, (cudaStream_t)stream>>>(
                H, gamma, beta, GA, GH, Ggamma, Gbeta, n, W, use_ln);
        else
            transport_bwd_kernel<2><<<cdiv(n, 8), 256, 0, (cudaStream_t)stream>>>(
                H, gamma, beta, GA, GH, Ggamma, Gbeta, n, W, use_ln);
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

extern "C" int fr_kdv(const float* U, float* dU, float* out, int n, int causal, void* stream) {
    if (n > 0)
        kdv_kernel<<<cdiv(n, 256), 256, 0, (cudaStream_t)stream>>>(U, dU, out, n, 2.0f / (float)n,
                                                                   causal);
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
        colsum_partial_kernel<<<grid, dim3(32, 8), 0, (cudaStream_t)stream>>>(A, rows, cols, ld, partial);
        colsum_final_kernel<<<cdiv(cols, 256), 256, 0, (cudaStream_t)stream>>>(partial, chunks, cols, scale, out);
    }
    return (int)cudaGetLastError();
}

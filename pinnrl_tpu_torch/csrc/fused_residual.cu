// Fused residual loss of a Fourier or feedforward PINN in any number d of
// space dimensions and its gradient with respect to every network parameter,
// for the residuals (sums over the axes ax)
//   Burgers         r = u_t + u sum u_x - nu sum u_xx
//   heat            r = u_t - alpha sum u_xx
//   KdV             r = u_t + 6 u sum u_x + sum u_xxx
//   convection      r = u_t + sum v_ax u_x
//   Allen-Cahn      r = u_t - eps^2 sum u_xx - u + u^3
//   Black-Scholes   r = V_t - s rate V + s sum (sigma^2/2 S^2 V_SS + rate S V_S),
//                   S = x_ax, s = +1 (calendar time) or -1 (time to maturity),
// plain (loss = mean_i r_i^2) or causally weighted (loss = sum_i w_i r_i^2 /
// sum_i w_i with w_i = exp(-eps sum_{j<i} r_j^2 / N) over the time-sorted
// batch; the weights carry no gradient), with or without a co-moving frame
// (the network sees (x - c t, t)).
//
// Replaces the whole of the Pallas kernel pinnrl_tpu/ops/kernels/fused_step.py:277
// (make_fused_residual_loss: _run / _tile_loss, behind the custom-VJP
// fused_loss): every residual above, spatial order 1 (convection), 2 or 3
// (KdV), causal or not, framed or not, on either trunk, in any dimension.
// The stacked streams are [value; D x-groups of KX; t1], S = 2 + D KX
// (jet_mlp's order); the x-groups share the value stream's LayerNorm
// statistics and activation derivatives. For D = 1, 2 and 3 each kernel
// takes D and KX as template parameters, and D = 1 evaluates the
// one-dimensional expressions unchanged; d >= 4 runs the *_nd kernels
// (section "d >= 4" below), which take d at run time and walk the x-groups
// one at a time, so their registers do not grow with d. The activation is
// every one the reference's transport takes (tanh, gelu in flax's tanh
// approximation, sigmoid, silu/swish, sin),
// passed to the transport kernels as a runtime code (ACT_*): one switch
// that every thread takes alike, not a template parameter, so the
// instantiations stay D x KX per direction. The TPU program keeps one
// batch tile's whole forward and backward live set in VMEM, takes the
// backward from jax.vjp inside the kernel, and carries the causal prefix
// from one grid step to the next because its grid runs in order on one
// core. An SM's 227 KB cannot hold that live set (S = 3 to 11 stacked streams
// x width 256 x several saved tensors per point), there is no AD inside a
// CUDA kernel, and CTAs run in no order, so the work is split into a few
// kernels that the host launches in sequence on one stream
// (ops/kernels/fused_step.py):
//
//   embed_kernel<D,K>     z -> affine map -> [sin, cos] and the closed-form
//                         phase-rotation streams, written as the stacked
//                         ((2+DK)N, 2m) input [value; per axis x1..xK; t1],
//                         K = 1 (convection), 2 (Burgers, heat, Allen-Cahn,
//                         Black-Scholes) or 3 (KdV).
//   embed_bwd_partial_kernel<D,K>  with a trainable basis, dL/dB from the
//                         embedding's cotangent G = dH W0 ((2+DK)N, 2m): per
//                         point and feature the cotangents of the phase p and
//                         of each direction's rate, folded into D+1 rows of
//                         per-block partials; colsum_final_kernel sums them.
//   affine_input_kernel<D>  the feedforward trunk's ((2+DK)N, D+1) input: the
//                         affine map and its constant direction rows; the
//                         first GEMM then has D+1 input columns (the core's
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
//   transport_fwd_kernel<D,K>  one warp per point: LayerNorm + activation
//                         Taylor transport of the 2+DK streams (ops/jet_mlp.py)
//                         in d_k = f^(k)(y0) at the primal pre-activation
//                         (act_derivs: closed forms to order 4); every term
//                         of a group's stream 2 sits behind KX >= 2.
//   transport_bwd_kernel<D,K>  its hand-derived reverse pass (the formulas are
//                         in fused_step.py: _transport_bwd_plain; the value
//                         stream's cotangent is G_y0 = d1 G_o0 + d2 G_d1 +
//                         d3 G_d2 + d4 G_d3, d4 only at KX = 3). It
//                         recomputes the forward quantities from the saved
//                         pre-activation instead of storing them, and writes
//                         per-point LayerNorm scale/bias gradient rows.
//   burgers_kernel<D>, heat_kernel<D>, kdv_kernel<D>, convection_kernel<D>,
//   allen_cahn_kernel<D>, black_scholes_kernel<D>  r and the stream cotangents:
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
//   *_nd_kernel           the same work for d >= 4 space dimensions, d a
//                         run-time argument: embed_nd_kernel<K>,
//                         embed_bwd_nd_partial_kernel<K> (dynamic shared
//                         memory, blocks along z over tiles of 32 axes),
//                         affine_input_nd_kernel, transport_fwd_nd_kernel<K>,
//                         transport_bwd_nd_kernel<K> (one x-group at a time
//                         through the D = 1 element code) and one residual
//                         kernel per PDE (convection reads its d velocities
//                         from device memory).
//
// What bounds it on an H100: at batch 8192 and width 256 each hidden layer's
// three products are S*8192 x 256 x 256 FMAs, S = 2 + D K: in one dimension 3
// (convection), 4 (Burgers, heat, Allen-Cahn, Black-Scholes) or 5 (KdV), in two
// 6 for heat_2d; these FP32 CUDA-core GEMMs are
// bound by operations (67 TFLOP/s FP32 peak) and take most of the device
// time. The GEMM core feeds the FFMA pipes
// with float4 shared loads (4 per 64 FFMAs) and overlaps the next slices'
// loads with the arithmetic (sgemm_sm90.cuh). The output layer's products
// (one column) are bound by bytes, so they skip the tile and stream their
// operand once. Transport, embedding, residual, scan and column sums are
// memory-bound row passes over (S N, 256) tensors in device memory between
// kernels; fusing the transport into the GEMM epilogue is later work.

#include <cuda_runtime.h>

#include <type_traits>

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

// The member axis. A deep ensemble's E members run in one launch of each
// kernel: their tensors are stacked [member][stream][point] (each member's
// block is the single-member layout), and the member is a grid axis
// (blockIdx.y, or blockIdx.z where y is taken), so a block computes exactly
// what it computes for one member, at the member's offsets. The reference
// gets the same from jax.vmap of its pallas_call, which adds a member axis
// to the grid. Members = 1 is the single call.
__device__ __forceinline__ long long member_y() { return (long long)blockIdx.y; }

// ------------------------------------------------- output layer (out = 1) --
// Y[r] = X[r, :] . w (+ b[0] for r < bias_rows), one warp per row;
// vec: X's rows and w allow float4 loads.
__global__ void __launch_bounds__(ROW_THREADS)
rowdot_kernel(const float* __restrict__ X, const float* __restrict__ w,
              const float* __restrict__ b, float* __restrict__ Y, int R, int K, int bias_rows,
              int vec) {
    const long long e = member_y();  // member e: its R rows, w and b
    X += e * R * K;
    w += e * K;
    if (b != nullptr) b += e;
    Y += e * R;
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
    const long long e = member_y();
    g += e * R;
    w += e * K;
    out += e * R * K;
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
// Streams of one point: index 0 the value, then D x-groups of KX (group g's
// order k, k = 1..KX, is stream 1 + g KX + k - 1), T = D KX + 1 the first
// t-derivative; NS = D KX + 2 streams in all (jet_mlp's stacking order).

// Calls f(Int<g>{}) for g = B..E-1 as straight-line code. The x-groups are
// walked this way and not by unrolled loops: the compiler then sees the
// one-dimensional kernel's statements in its order, fuses the same products
// into FMAs, and D = 1 keeps its bits.
template <int B, int E, typename F>
__device__ __forceinline__ void for_groups(F&& f) {
    if constexpr (B < E) {
        f(std::integral_constant<int, B>{});
        for_groups<B + 1, E>(f);
    }
}

// Per-group slots of the transport's arrays: D x-groups, at least one slot
// so that D = 0 (an ODE: [value; t1], no x-group) declares no empty array.
template <int D>
constexpr int kSlots = D > 0 ? D : 1;

template <int D, int KX>
struct Layout {
    static constexpr int T = D * KX + 1;
    static constexpr int NS = D * KX + 2;
    __host__ __device__ static constexpr int base(int g) { return 1 + g * KX; }  // group g's first
};

// The network input of one point of z (n, D+1): w = (x - lo) sc - 1, with
// x = (z_x - c t, t) in a co-moving frame of speed c (frame != 0).
template <int D>
__device__ __forceinline__ void affine_map(const float* __restrict__ zr, const float* __restrict__ lo,
                                           const float* __restrict__ sc, int frame, float c,
                                           float* w) {
    const float t = zr[D];
    for_groups<0, D>([&](auto a_) {
        constexpr int a = decltype(a_)::value;
        // The shift rounds its product and its difference as the plain
        // version does (no fused multiply-add).
        const float x = frame ? __fsub_rn(zr[a], __fmul_rn(c, t)) : zr[a];
        w[a] = (x - lo[a]) * sc[a] - 1.0f;
    });
    w[D] = (t - lo[D]) * sc[D] - 1.0f;
}

template <int D, int KX>
__global__ void embed_kernel(const float* __restrict__ z, const float* __restrict__ lo,
                             const float* __restrict__ sc, const float* __restrict__ B,
                             float* __restrict__ X, int n, int m, float s, int frame, float c,
                             long long sB) {
    using L = Layout<D, KX>;
    const long long e = member_y();  // sB = 0: a basis the members share
    z += e * n * (D + 1);
    B += e * sB;
    X += e * L::NS * n * 2 * m;
    const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= (long long)n * m) return;
    const int row = (int)(idx / m);
    const int j = (int)(idx % m);
    float w[D + 1];
    affine_map<D>(z + (long long)(D + 1) * row, lo, sc, frame, c, w);
    float acc = w[0] * B[j];
#pragma unroll
    for (int a = 1; a <= D; ++a) acc = acc + w[a] * B[(long long)a * m + j];
    const float p = s * acc;
    // d p / dt (constant over the batch); in the frame also -c sc_ax B_ax.
    float p1t = s * (sc[D] * B[(long long)D * m + j]);
    if (frame) {
        float v = (-c * sc[0]) * B[j];
        for_groups<1, D>([&](auto a_) {
            constexpr int a = decltype(a_)::value;
            v = v + (-c * sc[a]) * B[(long long)a * m + j];
        });
        p1t = s * (v + sc[D] * B[(long long)D * m + j]);
    }
    float sn, cs;
    sincosf(p, &sn, &cs);
    const long long w2 = 2LL * m;
    const long long stride = (long long)n * w2;
    float* r0 = X + (long long)row * w2;
    r0[j] = sn;
    r0[m + j] = cs;
    for_groups<0, D>([&](auto g_) {
        constexpr int g = decltype(g_)::value;
        const float p1x = s * (sc[g] * B[(long long)g * m + j]);  // d p / dx_g
        // d sin(p) = cos(p) p1 ; d cos(p) = -sin(p) p1, order by order.
        float sk = sn, ck = cs;
#pragma unroll
        for (int k = 1; k <= KX; ++k) {
            const float s_next = ck * p1x, c_next = -sk * p1x;
            sk = s_next;
            ck = c_next;
            float* rk = r0 + (L::base(g) + k - 1) * stride;
            rk[j] = sk;
            rk[m + j] = ck;
        }
    });
    float* rt = r0 + L::T * stride;
    rt[j] = cs * p1t;
    rt[m + j] = -sn * p1t;
}

// dL/dB of a trainable basis. Stream (g, k) of the embedding is
// p1^k [sin^(k)(p), cos^(k)(p)] with p = s w.B_j and p1 = s v_g.B_j, v_g the
// direction (sc_g e_g for an axis, the t-direction for t1), so with G its
// cotangent (Gs, Gc):
//   dL/dp   += p1^k (Gs cos^(k)(p) - Gc sin^(k)(p))
//   dL/dp1  += k p1^(k-1) (Gs sin^(k)(p) + Gc cos^(k)(p))
// and dL/dB_aj = s sum_points (w_a dL/dp + sum_g v_g[a] dL/dp1_g). One
// thread per (feature j, 8th row); a block sums COLSUM_ROWS points and
// writes the D+1 rows of its partial (chunk, (D+1) m) in a fixed order, so
// the result is identical from run to run. What bounds it: reading G,
// (2 + D K) N x 2m floats, once; the sincos per (point, feature) is the
// forward's again.
template <int D, int KX>
__global__ void embed_bwd_partial_kernel(const float* __restrict__ z,
                                         const float* __restrict__ lo,
                                         const float* __restrict__ sc,
                                         const float* __restrict__ B,
                                         const float* __restrict__ G, int n, int m, float s,
                                         int frame, float c, float* __restrict__ partial,
                                         long long sB) {
    using L = Layout<D, KX>;
    __shared__ float sm[D + 1][8][33];
    const long long e = blockIdx.z;  // the member
    z += e * n * (D + 1);
    B += e * sB;
    G += e * L::NS * n * 2 * m;
    partial += e * gridDim.y * (D + 1) * m;
    const int j = blockIdx.x * 32 + threadIdx.x;
    const int r0 = blockIdx.y * COLSUM_ROWS;
    const int r1 = min(n, r0 + COLSUM_ROWS);
    float acc[D + 1];
#pragma unroll
    for (int a = 0; a <= D; ++a) acc[a] = 0.0f;
    if (j < m) {
        float p1x[D];
        for_groups<0, D>([&](auto g_) {
            constexpr int g = decltype(g_)::value;
            p1x[g] = s * (sc[g] * B[(long long)g * m + j]);
        });
        // The t-direction in input space and its rate, as embed_kernel.
        float vt[D + 1];
        for_groups<0, D>([&](auto a_) {
            constexpr int a = decltype(a_)::value;
            vt[a] = frame ? -c * sc[a] : 0.0f;
        });
        vt[D] = sc[D];
        float p1t = s * (sc[D] * B[(long long)D * m + j]);
        if (frame) {
            float v = (-c * sc[0]) * B[j];
            for_groups<1, D>([&](auto a_) {
                constexpr int a = decltype(a_)::value;
                v = v + (-c * sc[a]) * B[(long long)a * m + j];
            });
            p1t = s * (v + sc[D] * B[(long long)D * m + j]);
        }
        const long long w2 = 2LL * m;
        const long long stride = (long long)n * w2;
        for (int row = r0 + threadIdx.y; row < r1; row += 8) {
            float w[D + 1];
            affine_map<D>(z + (long long)(D + 1) * row, lo, sc, frame, c, w);
            float pj = w[0] * B[j];
#pragma unroll
            for (int a = 1; a <= D; ++a) pj = pj + w[a] * B[(long long)a * m + j];
            float sn, cs;
            sincosf(s * pj, &sn, &cs);
            const float* g0 = G + (long long)row * w2;
            float dp = g0[j] * cs - g0[m + j] * sn;
            for_groups<0, D>([&](auto g_) {
                constexpr int g = decltype(g_)::value;
                float sk = sn, ck = cs, pk = 1.0f, dq = 0.0f;
#pragma unroll
                for (int k = 1; k <= KX; ++k) {
                    const float* gk = g0 + (L::base(g) + k - 1) * stride;
                    const float gs = gk[j], gc = gk[m + j];
                    const float s_next = ck, c_next = -sk;  // sin^(k)(p), cos^(k)(p)
                    sk = s_next;
                    ck = c_next;
                    dq += (float)k * pk * (gs * sk + gc * ck);  // pk = p1^(k-1)
                    pk *= p1x[g];
                    dp += pk * (gs * ck - gc * sk);
                }
                acc[g] += sc[g] * dq;
            });
            const float* gt = g0 + L::T * stride;
            const float gs = gt[j], gc = gt[m + j];
            dp += p1t * (-gs * sn - gc * cs);
            const float dqt = gs * cs - gc * sn;
#pragma unroll
            for (int a = 0; a <= D; ++a) acc[a] += w[a] * dp + vt[a] * dqt;
        }
    }
#pragma unroll
    for (int a = 0; a <= D; ++a) sm[a][threadIdx.y][threadIdx.x] = acc[a];
    __syncthreads();
    if (threadIdx.y == 0 && j < m) {
#pragma unroll
        for (int a = 0; a <= D; ++a) {
            float t = 0.0f;
#pragma unroll
            for (int k = 0; k < 8; ++k) t += sm[a][k][threadIdx.x];
            partial[(long long)blockIdx.y * (D + 1) * m + (long long)a * m + j] = t;
        }
    }
}

// Feedforward trunk: the stacked ((2 + dim kx) n, dim+1) input of the first
// Dense layer, [w; per axis: sc_ax e_ax, 0 x (kx - 1); the t-direction sc_t
// e_t, with -c sc_ax on the spatial columns in a frame] (the input map is
// affine, so each direction is a constant row). One thread per point.
template <int D>
__global__ void affine_input_kernel(const float* __restrict__ z, const float* __restrict__ lo,
                                    const float* __restrict__ sc, float* __restrict__ X, int n,
                                    int kx, int frame, float c) {
    constexpr int C = D + 1;  // columns
    const long long e = member_y();
    z += e * n * C;
    X += e * (2 + D * kx) * n * C;
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const long long stride = (long long)C * n;
    float* r = X + (long long)C * i;
    affine_map<D>(z + (long long)C * i, lo, sc, frame, c, r);
    for_groups<0, D>([&](auto g_) {
        constexpr int g = decltype(g_)::value;
        if (kx == 0) return;  // an ODE: no x-group
        float* rg = r + (1 + (long long)g * kx) * stride;
#pragma unroll
        for (int a = 0; a < C; ++a) rg[a] = a == g ? sc[a] : 0.0f;
        for (int k = 2; k <= kx; ++k)
#pragma unroll
            for (int a = 0; a < C; ++a) rg[(k - 1) * stride + a] = 0.0f;
    });
    float* rt = r + (1 + (long long)D * kx) * stride;
    for_groups<0, D>([&](auto a_) {
        constexpr int a = decltype(a_)::value;
        rt[a] = frame ? -c * sc[a] : 0.0f;
    });
    rt[D] = sc[D];
}

// ------------------------------------------------------------ transport --
// h points at the value row of one point; stream s is h[s * stride].

// Row statistics of the LayerNorm streams for one point (two-pass, as the
// plain transport computes them): shared r and St, one S1..S3 per x-group.
template <int D, int KX>
struct RowStats {
    float mu[D * KX + 2];
    float r;      // 1 / sqrt(var0 + eps)
    float S1[kSlots<D>];  // mean(c0 c1) r
    float V2[kSlots<D>];  // mean(c1^2 + c0 c2)            (KX >= 2)
    float S2[kSlots<D>];  // (V2 - S1^2) r                 (KX >= 2)
    float V3[kSlots<D>];  // mean(3 c1 c2 + c0 c3)        (KX = 3)
    float S3[kSlots<D>];  // (V3 - 3 S1 S2) r              (KX = 3)
    float St;     // s1 of the t-group = mean(c0 ct) r
};

template <int D, int KX>
__device__ RowStats<D, KX> row_stats(const float* h, long long stride, int W, int lane) {
    using L = Layout<D, KX>;
    constexpr int T = L::T;
    RowStats<D, KX> st;
    float a[L::NS];
#pragma unroll
    for (int s = 0; s <= T; ++s) a[s] = 0.f;
    for (int j = lane; j < W; j += 32) {
#pragma unroll
        for (int s = 0; s <= T; ++s) a[s] += h[s * stride + j];
    }
    const float fw = (float)W;
#pragma unroll
    for (int s = 0; s <= T; ++s) st.mu[s] = warp_sum(a[s]) / fw;
    // Statements in the one-dimensional kernel's order (the compiler's choice
    // of which product to fuse into an FMA follows it), so D = 1 keeps its bits.
    float v0 = 0.f, v0t = 0.f, v01[kSlots<D>], v2[kSlots<D>], v3[kSlots<D>];
    for_groups<0, D>([&](auto g_) {
        constexpr int g = decltype(g_)::value;
        v01[g] = v2[g] = v3[g] = 0.f;
    });
    for (int j = lane; j < W; j += 32) {
        float c1[kSlots<D>];
        const float c0 = h[j] - st.mu[0];
        for_groups<0, D>([&](auto g_) {
            constexpr int g = decltype(g_)::value;
            c1[g] = h[L::base(g) * stride + j] - st.mu[L::base(g)];
        });
        const float ct = h[T * stride + j] - st.mu[T];
        v0 += c0 * c0;
        for_groups<0, D>([&](auto g_) {
            constexpr int g = decltype(g_)::value;
            v01[g] += c0 * c1[g];
        });
        v0t += c0 * ct;
        for_groups<0, D>([&](auto g_) {
            constexpr int g = decltype(g_)::value;
            const int b = L::base(g);
            if constexpr (KX >= 2) {
                const float c2 = h[(b + 1) * stride + j] - st.mu[b + 1];
                v2[g] += c1[g] * c1[g] + c0 * c2;
                if constexpr (KX >= 3) {
                    const float c3 = h[(b + 2) * stride + j] - st.mu[b + 2];
                    v3[g] += 3.0f * c1[g] * c2 + c0 * c3;
                }
            }
        });
    }
    const float var0 = warp_sum(v0) / fw;
    st.r = 1.0f / sqrtf(var0 + LN_EPS);
    for_groups<0, D>([&](auto g_) {
        constexpr int g = decltype(g_)::value;
        st.S1[g] = (warp_sum(v01[g]) / fw) * st.r;
        st.V2[g] = 0.f;
        st.S2[g] = 0.f;
        if constexpr (KX >= 2) {
            st.V2[g] = warp_sum(v2[g]) / fw;
            st.S2[g] = (st.V2[g] - st.S1[g] * st.S1[g]) * st.r;
        }
    });
    st.St = (warp_sum(v0t) / fw) * st.r;
    for_groups<0, D>([&](auto g_) {
        constexpr int g = decltype(g_)::value;
        st.V3[g] = 0.f;
        st.S3[g] = 0.f;
        if constexpr (KX >= 3) {
            st.V3[g] = warp_sum(v3[g]) / fw;
            st.S3[g] = (st.V3[g] - 3.0f * st.S1[g] * st.S2[g]) * st.r;
        }
    });
    return st;
}

// The activations (ops/kernels/fused_step.py: _ACT_CODES). Every thread of a
// launch takes the same case, so the switch does not diverge.
enum : int { ACT_TANH = 0, ACT_GELU = 1, ACT_SIGMOID = 2, ACT_SILU = 3, ACT_SIN = 4 };
constexpr float GELU_C = 0.7978845608028654f;  // sqrt(2 / pi)
constexpr float GELU_A = 0.044715f;

// d[k] = tanh^(k)(y), k < N (N <= 5).
template <int N>
__device__ __forceinline__ void tanh_derivs(float y, float* d) {
    const float a = tanhf(y);
    d[0] = a;
    d[1] = 1.0f - a * a;
    if constexpr (N > 2) d[2] = -2.0f * a * d[1];
    if constexpr (N > 3) d[3] = -2.0f * d[1] * (1.0f - 3.0f * a * a);
    if constexpr (N > 4) d[4] = 8.0f * a * d[1] * (2.0f - 3.0f * a * a);
}

// d[k] = sigmoid^(k)(y), k < N (N <= 5).
template <int N>
__device__ __forceinline__ void sigmoid_derivs(float y, float* d) {
    const float s = 1.0f / (1.0f + expf(-y));
    d[0] = s;
    d[1] = s * (1.0f - s);
    if constexpr (N > 2) d[2] = d[1] * (1.0f - 2.0f * s);
    if constexpr (N > 3) d[3] = d[1] * (1.0f - 6.0f * s + 6.0f * s * s);
    if constexpr (N > 4) d[4] = d[1] * (1.0f - 2.0f * s) * (1.0f - 12.0f * s + 12.0f * s * s);
}

// d[k] = f^(k)(y), k < N (N <= 5), of the activation act: the closed forms of
// ops/jet_mlp.py's ACTIVATION_DERIVATIVES.
template <int N>
__device__ __forceinline__ void act_derivs(int act, float y, float* d) {
    switch (act) {
        case ACT_GELU: {
            // 0.5 (y + y h), h = tanh(u), u = c (y + a y^3); h's derivatives
            // by Faa di Bruno from tanh's at u (u'''' = 0), then
            // f^(k) = 0.5 (delta_k1 + y h^(k) + k h^(k-1)).
            float t[N], h[N];
            tanh_derivs<N>(GELU_C * (y + GELU_A * (y * y * y)), t);
            const float u1 = GELU_C * (1.0f + 3.0f * GELU_A * y * y);
            [[maybe_unused]] const float u2 = 6.0f * GELU_A * GELU_C * y;
            [[maybe_unused]] const float u3 = 6.0f * GELU_A * GELU_C;
            h[0] = t[0];
            h[1] = t[1] * u1;
            if constexpr (N > 2) h[2] = t[1] * u2 + t[2] * u1 * u1;
            if constexpr (N > 3) h[3] = t[1] * u3 + 3.0f * t[2] * u1 * u2 + t[3] * u1 * u1 * u1;
            if constexpr (N > 4)
                h[4] = t[2] * (4.0f * u1 * u3 + 3.0f * u2 * u2) + 6.0f * t[3] * u1 * u1 * u2
                     + t[4] * u1 * u1 * u1 * u1;
            d[0] = y * (0.5f * (1.0f + h[0]));
            d[1] = 0.5f * (1.0f + h[0] + y * h[1]);
#pragma unroll
            for (int k = 2; k < N; ++k) d[k] = 0.5f * (y * h[k] + (float)k * h[k - 1]);
            break;
        }
        case ACT_SIGMOID:
            sigmoid_derivs<N>(y, d);
            break;
        case ACT_SILU: {  // y s: f^(k) = y s^(k) + k s^(k-1)
            float s[N];
            sigmoid_derivs<N>(y, s);
            d[0] = y * s[0];
#pragma unroll
            for (int k = 1; k < N; ++k) d[k] = y * s[k] + (float)k * s[k - 1];
            break;
        }
        case ACT_SIN: {  // sin(y + k pi/2)
            float sn, cs;
            sincosf(y, &sn, &cs);
            const float cyc[4] = {sn, cs, -sn, -cs};
#pragma unroll
            for (int k = 0; k < N; ++k) d[k] = cyc[k & 3];
            break;
        }
        default:
            tanh_derivs<N>(y, d);
    }
}

// Forward quantities of one element: the streams and d_k = f^(k)(y0) for
// k = 0..KX+1 (the forward reads d0..dKX, its reverse d1..dKX+1).
template <int D, int KX>
struct Elem {
    float c[D * KX + 2], q[D * KX + 2], y[D * KX + 2];
    float d[KX + 2];
};

template <int D, int KX>
__device__ __forceinline__ void activate(Elem<D, KX>& e, int act) {
    act_derivs<KX + 2>(act, e.y[0], e.d);
}

template <int D, int KX>
__device__ __forceinline__ Elem<D, KX> elem_ln(const RowStats<D, KX>& st, const float* hv, float g,
                                               float b, int act) {
    using L = Layout<D, KX>;
    constexpr int T = L::T;
    Elem<D, KX> e;
#pragma unroll
    for (int s = 0; s <= T; ++s) e.c[s] = hv[s] - st.mu[s];
    e.q[0] = e.c[0] * st.r;
    for_groups<0, D>([&](auto gr_) {
        constexpr int gr = decltype(gr_)::value;
        const int k = L::base(gr);
        [[maybe_unused]] const float S1 = st.S1[gr], S2 = st.S2[gr];
        e.q[k] = (e.c[k] - e.q[0] * S1) * st.r;
        if constexpr (KX >= 2) e.q[k + 1] = (e.c[k + 1] - 2.0f * e.q[k] * S1 - e.q[0] * S2) * st.r;
        if constexpr (KX >= 3)
            e.q[k + 2] = (e.c[k + 2] - 3.0f * e.q[k + 1] * S1 - 3.0f * e.q[k] * S2
                          - e.q[0] * st.S3[gr]) * st.r;
    });
    e.q[T] = (e.c[T] - e.q[0] * st.St) * st.r;
    e.y[0] = e.q[0] * g + b;
#pragma unroll
    for (int s = 1; s <= T; ++s) e.y[s] = e.q[s] * g;
    activate(e, act);
    return e;
}

template <int D, int KX>
__device__ __forceinline__ Elem<D, KX> elem_plain(const float* hv, int act) {
    Elem<D, KX> e;
#pragma unroll
    for (int s = 0; s <= D * KX + 1; ++s) e.y[s] = hv[s];
    activate(e, act);
    return e;
}

template <int D, int KX>
__device__ __forceinline__ void load_streams(const float* p, long long stride, int j, float* v) {
#pragma unroll
    for (int s = 0; s <= D * KX + 1; ++s) v[s] = p[s * stride + j];
}

// H: stacked ((2 + D KX) n, W) pre-activations [value; D x-groups of KX; t1]
// (bias included). A: the stacked outputs [f(y0); per group o1..oKX; ot].
template <int D, int KX>
__global__ void transport_fwd_kernel(const float* __restrict__ H, const float* __restrict__ gamma,
                                     const float* __restrict__ beta, float* __restrict__ A,
                                     int n, int W, int use_ln, int act) {
    using L = Layout<D, KX>;
    constexpr int T = L::T;
    const long long e = member_y();  // member e: its streams, its LayerNorm scale and bias
    H += e * L::NS * n * W;
    A += e * L::NS * n * W;
    if (use_ln) {
        gamma += e * W;
        beta += e * W;
    }
    const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (warp >= n) return;
    const long long stride = (long long)n * W;
    const float* h = H + (long long)warp * W;
    float* o = A + (long long)warp * W;
    RowStats<D, KX> st;
    if (use_ln) st = row_stats<D, KX>(h, stride, W, lane);
    for (int j = lane; j < W; j += 32) {
        float hv[L::NS];
        load_streams<D, KX>(h, stride, j, hv);
        const Elem<D, KX> e = use_ln ? elem_ln<D, KX>(st, hv, gamma[j], beta[j], act)
                                     : elem_plain<D, KX>(hv, act);
        o[j] = e.d[0];
        for_groups<0, D>([&](auto g_) {
            constexpr int g = decltype(g_)::value;
            const int k = L::base(g);
            o[k * stride + j] = e.d[1] * e.y[k];
            if constexpr (KX >= 2)
                o[(k + 1) * stride + j] = e.d[1] * e.y[k + 1] + e.d[2] * e.y[k] * e.y[k];
            if constexpr (KX >= 3)
                o[(k + 2) * stride + j] = e.d[1] * e.y[k + 2] + 3.0f * e.d[2] * e.y[k] * e.y[k + 1]
                                        + e.d[3] * e.y[k] * e.y[k] * e.y[k];
        });
        o[T * stride + j] = e.d[1] * e.y[T];
    }
}

// Cotangents of one element before the row reductions (see the derivation
// in ops/kernels/fused_step.py: _transport_bwd_plain). Group 0's terms come
// first and the others are added after them, so D = 1 evaluates the
// one-group expressions unchanged.
template <int D, int KX>
struct ElemGrad {
    float Gy[D * KX + 2];  // cotangents of the y streams
    float Gq[D * KX + 2];  // complete cotangents of the q streams (LayerNorm on)
};

template <int D, int KX>
__device__ __forceinline__ ElemGrad<D, KX> elem_grad(const Elem<D, KX>& e,
                                                     const RowStats<D, KX>& st, float g,
                                                     const float* Go, int use_ln) {
    using L = Layout<D, KX>;
    constexpr int T = L::T;
    ElemGrad<D, KX> r;
    // The outputs are linear in d1..d3: Gd1..Gd3 are their cotangents, and
    // G_y0 = d1 G_o0 + d2 G_d1 + d3 G_d2 + d4 G_d3 because d_k' = d_(k+1).
    float Gy0;
    if constexpr (KX >= 2) {
        float Gd1 = Go[1] * e.y[1] + Go[2] * e.y[2];
        for_groups<1, D>([&](auto gr_) {
            constexpr int gr = decltype(gr_)::value;
            const int k = L::base(gr);
            Gd1 = Gd1 + (Go[k] * e.y[k] + Go[k + 1] * e.y[k + 1]);
        });
        Gd1 = Gd1 + Go[T] * e.y[T];
        float Gd2 = Go[2] * e.y[1] * e.y[1];
        for_groups<1, D>([&](auto gr_) {
            constexpr int gr = decltype(gr_)::value;
            const int k = L::base(gr);
            Gd2 = Gd2 + Go[k + 1] * e.y[k] * e.y[k];
        });
        for_groups<0, D>([&](auto gr_) {
            constexpr int gr = decltype(gr_)::value;
            const int k = L::base(gr);
            r.Gy[k] = Go[k] * e.d[1] + 2.0f * Go[k + 1] * e.d[2] * e.y[k];
            r.Gy[k + 1] = Go[k + 1] * e.d[1];
        });
        if constexpr (KX >= 3) {
            float Gd3 = 0.f;
            for_groups<0, D>([&](auto gr_) {
                constexpr int gr = decltype(gr_)::value;
                const int k = L::base(gr);
                const float Go3 = Go[k + 2];
                const float y1 = e.y[k], y2 = e.y[k + 1];
                Gd1 = Gd1 + Go3 * e.y[k + 2];
                Gd2 = Gd2 + 3.0f * Go3 * y1 * y2;
                Gd3 = Gd3 + Go3 * y1 * y1 * y1;
                r.Gy[k] = r.Gy[k] + Go3 * (3.0f * e.d[2] * y2 + 3.0f * e.d[3] * y1 * y1);
                r.Gy[k + 1] = r.Gy[k + 1] + 3.0f * Go3 * e.d[2] * y1;
                r.Gy[k + 2] = Go3 * e.d[1];
            });
            Gy0 = Go[0] * e.d[1] + e.d[2] * Gd1 + e.d[3] * Gd2 + e.d[4] * Gd3;
        } else {
            Gy0 = Go[0] * e.d[1] + e.d[2] * Gd1 + e.d[3] * Gd2;
        }
    } else {
        // Group 0's term first (D = 0 has none: index 1 is then the t-stream).
        float Gd1 = 0.f;
        if constexpr (D >= 1) Gd1 = Go[1] * e.y[1];
        for_groups<1, D>([&](auto gr_) {
            constexpr int gr = decltype(gr_)::value;
            Gd1 = Gd1 + Go[1 + gr] * e.y[1 + gr];
        });
        Gd1 = Gd1 + Go[T] * e.y[T];
        for_groups<0, D>([&](auto gr_) {
            constexpr int gr = decltype(gr_)::value;
            r.Gy[1 + gr] = Go[1 + gr] * e.d[1];
        });
        Gy0 = Go[0] * e.d[1] + e.d[2] * Gd1;
    }
    r.Gy[T] = Go[T] * e.d[1];
    r.Gy[0] = Gy0;
    if (use_ln) {
        r.Gq[T] = r.Gy[T] * g;
        for_groups<0, D>([&](auto gr_) {
            constexpr int gr = decltype(gr_)::value;
            const int k = L::base(gr);
            if constexpr (KX >= 3) {
                r.Gq[k + 2] = r.Gy[k + 2] * g;
                r.Gq[k + 1] = r.Gy[k + 1] * g - 3.0f * r.Gq[k + 2] * st.S1[gr] * st.r;
                r.Gq[k] = r.Gy[k] * g - 2.0f * r.Gq[k + 1] * st.S1[gr] * st.r
                        - 3.0f * r.Gq[k + 2] * st.S2[gr] * st.r;
            } else if constexpr (KX == 2) {
                r.Gq[k + 1] = r.Gy[k + 1] * g;
                r.Gq[k] = r.Gy[k] * g - 2.0f * r.Gq[k + 1] * st.S1[gr] * st.r;
            } else {
                r.Gq[k] = r.Gy[k] * g;
            }
        });
        float acc = r.Gq[T] * st.St;  // G_qt St + sum over groups of G_qk S_k
        for_groups<0, D>([&](auto gr_) {
            constexpr int gr = decltype(gr_)::value;
            const int k = L::base(gr);
            if constexpr (KX >= 3) acc = acc + r.Gq[k + 2] * st.S3[gr];
            if constexpr (KX >= 2) acc = acc + r.Gq[k + 1] * st.S2[gr];
            acc = acc + r.Gq[k] * st.S1[gr];
        });
        r.Gq[0] = r.Gy[0] * g - acc * st.r;
    }
    return r;
}

template <int D>
struct RowScalars {
    float GSt, Gvar0;
    float GS1[kSlots<D>], GS2[kSlots<D>], GS3[kSlots<D>], GV2[kSlots<D>], GV3[kSlots<D>];
};

// Cotangents of the centred streams c of one element.
template <int D, int KX>
__device__ __forceinline__ void centred_grads(const Elem<D, KX>& e, const ElemGrad<D, KX>& gr,
                                              const RowStats<D, KX>& st, const RowScalars<D>& sc,
                                              float inv_w, float* Gc) {
    using L = Layout<D, KX>;
    constexpr int T = L::T;
    const float r = st.r;
    Gc[T] = gr.Gq[T] * r + sc.GSt * r * e.c[0] * inv_w;
    for_groups<0, D>([&](auto g_) {
        constexpr int g = decltype(g_)::value;
        const int k = L::base(g);
        if constexpr (KX >= 2) {
            Gc[k] = gr.Gq[k] * r + (2.0f * sc.GV2[g] * e.c[k] + sc.GS1[g] * r * e.c[0]) * inv_w;
            Gc[k + 1] = gr.Gq[k + 1] * r + sc.GV2[g] * e.c[0] * inv_w;
        } else {
            Gc[k] = gr.Gq[k] * r + sc.GS1[g] * r * e.c[0] * inv_w;
        }
    });
    // G_St r ct + sum over groups of (G_V2 c2 + G_S1 r c1) + 2 G_var0 c0
    float acc = sc.GSt * r * e.c[T];
    for_groups<0, D>([&](auto g_) {
        constexpr int g = decltype(g_)::value;
        const int k = L::base(g);
        if constexpr (KX >= 2) acc = acc + sc.GV2[g] * e.c[k + 1];
        acc = acc + sc.GS1[g] * r * e.c[k];
    });
    Gc[0] = gr.Gq[0] * r + (acc + 2.0f * sc.Gvar0 * e.c[0]) * inv_w;
    if constexpr (KX >= 3) {
        for_groups<0, D>([&](auto g_) {
            constexpr int g = decltype(g_)::value;
            const int k = L::base(g);
            Gc[0] = Gc[0] + sc.GV3[g] * e.c[k + 2] * inv_w;
            Gc[k] = Gc[k] + 3.0f * sc.GV3[g] * e.c[k + 1] * inv_w;
            Gc[k + 1] = Gc[k + 1] + 3.0f * sc.GV3[g] * e.c[k] * inv_w;
            Gc[k + 2] = gr.Gq[k + 2] * r + sc.GV3[g] * e.c[0] * inv_w;
        });
    }
}

// GA: stacked ((2 + D KX)n, W) cotangents of the transport outputs. Writes GH
// (cotangents of H) and, with LayerNorm, per-point rows of the scale and
// bias gradients (summed over points by colsum afterwards).
template <int D, int KX>
__global__ void transport_bwd_kernel(const float* __restrict__ H, const float* __restrict__ gamma,
                                     const float* __restrict__ beta, const float* __restrict__ GA,
                                     float* __restrict__ GH, float* __restrict__ Ggamma,
                                     float* __restrict__ Gbeta, int n, int W, int use_ln, int act) {
    using L = Layout<D, KX>;
    constexpr int T = L::T;
    constexpr int NS = L::NS;
    const long long e = member_y();
    H += e * NS * n * W;
    GA += e * NS * n * W;
    GH += e * NS * n * W;
    if (use_ln) {
        gamma += e * W;
        beta += e * W;
        Ggamma += e * n * W;
        Gbeta += e * n * W;
    }
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
            float hv[NS], Go[NS];
            load_streams<D, KX>(h, stride, j, hv);
            load_streams<D, KX>(ga, stride, j, Go);
            const Elem<D, KX> e = elem_plain<D, KX>(hv, act);
            const ElemGrad<D, KX> gr = elem_grad<D, KX>(e, RowStats<D, KX>{}, 1.0f, Go, 0);
#pragma unroll
            for (int s = 0; s <= T; ++s) o[s * stride + j] = gr.Gy[s];
        }
        return;
    }

    const RowStats<D, KX> st = row_stats<D, KX>(h, stride, W, lane);
    // Pass A: row sums R_kj of the q-stream cotangents against the q streams,
    // per group (k, j = 0..3 within the group; j = 0 is the shared q0).
    float R00 = 0.f, Rt0 = 0.f, Rtt = 0.f;
    constexpr int G = kSlots<D>;
    float R10[G], R11[G], R20[G], R21[G], R22[G], R30[G], R31[G], R32[G], R33[G];
    for_groups<0, D>([&](auto g_) {
        constexpr int g = decltype(g_)::value;
        R10[g] = R11[g] = R20[g] = R21[g] = R22[g] = R30[g] = R31[g] = R32[g] = R33[g] = 0.f;
    });
    for (int j = lane; j < W; j += 32) {
        const float g = gamma[j];
        float hv[NS], Go[NS];
        load_streams<D, KX>(h, stride, j, hv);
        load_streams<D, KX>(ga, stride, j, Go);
        const Elem<D, KX> e = elem_ln<D, KX>(st, hv, g, beta[j], act);
        const ElemGrad<D, KX> gr = elem_grad<D, KX>(e, st, g, Go, 1);
        Rt0 += gr.Gq[T] * e.q[0]; Rtt += gr.Gq[T] * e.q[T];
        for_groups<0, D>([&](auto x_) {
            constexpr int x = decltype(x_)::value;
            const int k = L::base(x);
            if constexpr (KX >= 2) {
                R21[x] += gr.Gq[k + 1] * e.q[k]; R20[x] += gr.Gq[k + 1] * e.q[0];
                R22[x] += gr.Gq[k + 1] * e.q[k + 1];
            }
            R10[x] += gr.Gq[k] * e.q[0]; R11[x] += gr.Gq[k] * e.q[k];
        });
        R00 += gr.Gq[0] * e.q[0];
        for_groups<0, D>([&](auto x_) {
            constexpr int x = decltype(x_)::value;
            const int k = L::base(x);
            if constexpr (KX >= 3) {
                R30[x] += gr.Gq[k + 2] * e.q[0]; R31[x] += gr.Gq[k + 2] * e.q[k];
                R32[x] += gr.Gq[k + 2] * e.q[k + 1]; R33[x] += gr.Gq[k + 2] * e.q[k + 2];
            }
        });
        float gg = 0.f;
#pragma unroll
        for (int s = 0; s <= T; ++s) gg += gr.Gy[s] * e.q[s];
        Ggamma[base + j] = gg;
        Gbeta[base + j] = gr.Gy[0];
    }
    Rt0 = warp_sum(Rt0); Rtt = warp_sum(Rtt);
    for_groups<0, D>([&](auto x_) {
        constexpr int x = decltype(x_)::value;
        R10[x] = warp_sum(R10[x]); R11[x] = warp_sum(R11[x]);
    });
    R00 = warp_sum(R00);
    RowScalars<D> sc;
    const float r = st.r;
    sc.GSt = -Rt0 * r;
    for_groups<0, D>([&](auto x_) {
        constexpr int x = decltype(x_)::value;
        sc.GS2[x] = 0.f;
        sc.GS1[x] = -R10[x] * r;
        if constexpr (KX >= 2) {
            R21[x] = warp_sum(R21[x]); R20[x] = warp_sum(R20[x]); R22[x] = warp_sum(R22[x]);
            sc.GS2[x] = -R20[x] * r;
            sc.GS1[x] = -2.0f * R21[x] * r - R10[x] * r;
        }
    });
    // Rdiag = Rtt + sum over groups of (R22 + R11) + R00, then each group's
    // R33 + G_S3 S3; Gr's numerator adds G_St St and each group's G_S2 S2 + G_S1 S1.
    float Rdiag = Rtt;
    for_groups<0, D>([&](auto x_) {
        constexpr int x = decltype(x_)::value;
        if constexpr (KX >= 2) Rdiag = Rdiag + R22[x];
        Rdiag = Rdiag + R11[x];
    });
    Rdiag = Rdiag + R00;
    for_groups<0, D>([&](auto x_) {
        constexpr int x = decltype(x_)::value;
        sc.GS3[x] = 0.f;
        sc.GV3[x] = 0.f;
    });
    for_groups<0, D>([&](auto x_) {
        constexpr int x = decltype(x_)::value;
        if constexpr (KX >= 3) {
            R30[x] = warp_sum(R30[x]); R31[x] = warp_sum(R31[x]);
            R32[x] = warp_sum(R32[x]); R33[x] = warp_sum(R33[x]);
            sc.GS3[x] = -R30[x] * r;
            sc.GS2[x] = sc.GS2[x] - 3.0f * R31[x] * r - 3.0f * st.S1[x] * r * sc.GS3[x];
            sc.GS1[x] = sc.GS1[x] - 3.0f * R32[x] * r - 3.0f * st.S2[x] * r * sc.GS3[x];
            sc.GV3[x] = sc.GS3[x] * r;
            Rdiag = Rdiag + R33[x] + sc.GS3[x] * st.S3[x];
        }
        sc.GV2[x] = sc.GS2[x] * r;
    });
    if constexpr (KX >= 2)
        for_groups<0, D>([&](auto x_) {
            constexpr int x = decltype(x_)::value;
            sc.GS1[x] = sc.GS1[x] - 2.0f * st.S1[x] * r * sc.GS2[x];
        });
    float num = Rdiag + sc.GSt * st.St;
    for_groups<0, D>([&](auto x_) {
        constexpr int x = decltype(x_)::value;
        if constexpr (KX >= 2) num = num + sc.GS2[x] * st.S2[x];
        num = num + sc.GS1[x] * st.S1[x];
    });
    const float Gr = num / r;
    sc.Gvar0 = -0.5f * r * r * r * Gr;
    const float inv_w = 1.0f / (float)W;

    // Pass B: means of the centred-stream cotangents.
    float m[NS];
#pragma unroll
    for (int s = 0; s <= T; ++s) m[s] = 0.f;
    for (int j = lane; j < W; j += 32) {
        const float g = gamma[j];
        float hv[NS], Go[NS], Gc[NS];
        load_streams<D, KX>(h, stride, j, hv);
        load_streams<D, KX>(ga, stride, j, Go);
        const Elem<D, KX> e = elem_ln<D, KX>(st, hv, g, beta[j], act);
        const ElemGrad<D, KX> gr = elem_grad<D, KX>(e, st, g, Go, 1);
        centred_grads<D, KX>(e, gr, st, sc, inv_w, Gc);
#pragma unroll
        for (int s = 0; s <= T; ++s) m[s] += Gc[s];
    }
#pragma unroll
    for (int s = 0; s <= T; ++s) m[s] = warp_sum(m[s]) * inv_w;

    // Pass C: centring is self-adjoint: G_h = G_c - mean(G_c).
    for (int j = lane; j < W; j += 32) {
        const float g = gamma[j];
        float hv[NS], Go[NS], Gc[NS];
        load_streams<D, KX>(h, stride, j, hv);
        load_streams<D, KX>(ga, stride, j, Go);
        const Elem<D, KX> e = elem_ln<D, KX>(st, hv, g, beta[j], act);
        const ElemGrad<D, KX> gr = elem_grad<D, KX>(e, st, g, Go, 1);
        centred_grads<D, KX>(e, gr, st, sc, inv_w, Gc);
#pragma unroll
        for (int s = 0; s <= T; ++s) o[s * stride + j] = Gc[s] - m[s];
    }
}

// ------------------------------------------------------------ residuals --
// U: the stacked network outputs (bias included) [u; per axis u_x..; u_t]:
// Burgers, heat, Allen-Cahn and Black-Scholes [u; D x (u_x, u_xx); u_t], KdV
// [u; D x (u_x, u_xx, u_xxx); u_t], convection [u; D x u_x; u_t]. The sums over
// the axes start from axis 0, so D = 1 evaluates the one-axis expressions.
// Plain: out = r^2, dU = 2r/N dr/dU. Causal: out = r, dU = dr/dU (scaled
// later by causal_scale_kernel).

template <int D>
__global__ void burgers_kernel(const float* __restrict__ U, float* __restrict__ dU,
                               float* __restrict__ out, int n, float nu, float two_over_n,
                               int causal) {
    const long long mo = member_y() * (2 * D + 2) * n;  // member: its streams
    U += mo;
    dU += mo;
    out += member_y() * n;
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float u = U[i], ut = U[(2 * D + 1) * n + i];
    float ux = U[n + i], uxx = U[2 * n + i];
    for_groups<1, D>([&](auto g_) {
        constexpr int g = decltype(g_)::value;
        ux = ux + U[(1 + 2 * g) * n + i];
        uxx = uxx + U[(2 + 2 * g) * n + i];
    });
    const float r = (ut + u * ux) - nu * uxx;
    const float c = causal ? 1.0f : two_over_n * r;
    out[i] = causal ? r : r * r;
    dU[i] = causal ? ux : c * ux;
    for_groups<0, D>([&](auto g_) {
        constexpr int g = decltype(g_)::value;
        dU[(1 + 2 * g) * n + i] = causal ? u : c * u;
        dU[(2 + 2 * g) * n + i] = causal ? -nu : -c * nu;
    });
    dU[(2 * D + 1) * n + i] = c;
}

// Heat: r = u_t - alpha sum u_xx, linear (dr/du_t = 1, dr/du_xx = -alpha).
template <int D>
__global__ void heat_kernel(const float* __restrict__ U, float* __restrict__ dU,
                            float* __restrict__ out, int n, float alpha, float two_over_n,
                            int causal) {
    const long long mo = member_y() * (2 * D + 2) * n;  // member: its streams
    U += mo;
    dU += mo;
    out += member_y() * n;
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    float uxx = U[2 * n + i];
    for_groups<1, D>([&](auto g_) {
        constexpr int g = decltype(g_)::value;
        uxx = uxx + U[(2 + 2 * g) * n + i];
    });
    const float ut = U[(2 * D + 1) * n + i];
    const float r = ut - alpha * uxx;
    out[i] = causal ? r : r * r;
    const float c = causal ? 1.0f : two_over_n * r;
    dU[i] = 0.0f;
    for_groups<0, D>([&](auto g_) {
        constexpr int g = decltype(g_)::value;
        dU[(1 + 2 * g) * n + i] = 0.0f;
        dU[(2 + 2 * g) * n + i] = -c * alpha;
    });
    dU[(2 * D + 1) * n + i] = c;
}

// KdV: r = u_t + 6 u sum u_x + sum u_xxx.
template <int D>
__global__ void kdv_kernel(const float* __restrict__ U, float* __restrict__ dU,
                           float* __restrict__ out, int n, float two_over_n, int causal) {
    const long long mo = member_y() * (3 * D + 2) * n;  // member: its streams
    U += mo;
    dU += mo;
    out += member_y() * n;
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float u = U[i], ut = U[(3 * D + 1) * n + i];
    float ux = U[n + i], uxxx = U[3 * n + i];
    for_groups<1, D>([&](auto g_) {
        constexpr int g = decltype(g_)::value;
        ux = ux + U[(1 + 3 * g) * n + i];
        uxxx = uxxx + U[(3 + 3 * g) * n + i];
    });
    const float r = ut + 6.0f * u * ux + uxxx;
    out[i] = causal ? r : r * r;
    const float c = causal ? 1.0f : two_over_n * r;
    dU[i] = c * (6.0f * ux);
    for_groups<0, D>([&](auto g_) {
        constexpr int g = decltype(g_)::value;
        dU[(1 + 3 * g) * n + i] = c * (6.0f * u);
        dU[(2 + 3 * g) * n + i] = 0.0f;
        dU[(3 + 3 * g) * n + i] = c;
    });
    dU[(3 * D + 1) * n + i] = c;
}

// Convection: r = u_t + sum v_ax u_x over U = [u; D x u_x; u_t]
// (dr/dU = [0, v_0, .., v_{D-1}, 1]); v: the D velocities in device memory.
template <int D>
__global__ void convection_kernel(const float* __restrict__ U, float* __restrict__ dU,
                                  float* __restrict__ out, int n, const float* __restrict__ v,
                                  float two_over_n, int causal) {
    const long long mo = member_y() * (D + 2) * n;  // member: its streams
    U += mo;
    dU += mo;
    out += member_y() * n;
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    float vx = v[0] * U[n + i];
    for_groups<1, D>([&](auto g_) {
        constexpr int g = decltype(g_)::value;
        vx = vx + v[g] * U[(1 + g) * n + i];
    });
    const float ut = U[(D + 1) * n + i];
    const float r = ut + vx;
    out[i] = causal ? r : r * r;
    const float c = causal ? 1.0f : two_over_n * r;
    dU[i] = 0.0f;
    for_groups<0, D>([&](auto g_) {
        constexpr int g = decltype(g_)::value;
        dU[(1 + g) * n + i] = c * v[g];
    });
    dU[(D + 1) * n + i] = c;
}

// Allen-Cahn: r = u_t - eps^2 sum u_xx - u + u^3 (dr/du = 3u^2 - 1, dr/du_xx = -eps^2).
template <int D>
__global__ void allen_cahn_kernel(const float* __restrict__ U, float* __restrict__ dU,
                                  float* __restrict__ out, int n, float eps2, float two_over_n,
                                  int causal) {
    const long long mo = member_y() * (2 * D + 2) * n;  // member: its streams
    U += mo;
    dU += mo;
    out += member_y() * n;
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float u = U[i], ut = U[(2 * D + 1) * n + i];
    float uxx = U[2 * n + i];
    for_groups<1, D>([&](auto g_) {
        constexpr int g = decltype(g_)::value;
        uxx = uxx + U[(2 + 2 * g) * n + i];
    });
    const float r = ((ut - eps2 * uxx) - u) + u * u * u;
    out[i] = causal ? r : r * r;
    const float c = causal ? 1.0f : two_over_n * r;
    dU[i] = c * (3.0f * u * u - 1.0f);
    for_groups<0, D>([&](auto g_) {
        constexpr int g = decltype(g_)::value;
        dU[(1 + 2 * g) * n + i] = 0.0f;
        dU[(2 + 2 * g) * n + i] = -c * eps2;
    });
    dU[(2 * D + 1) * n + i] = c;
}

// Black-Scholes with time sign s (+1 calendar, -1 to maturity) and S = z[i, ax]
// along each axis: r = V_t - s rate V + s sum (h S^2 V_SS + rate S V_S),
// h = sigma^2 / 2 (dr/dU = [-s rate; per axis s rate S, s h S^2; 1]). The one
// residual that reads z (n, D+1).
template <int D>
__global__ void black_scholes_kernel(const float* __restrict__ U, const float* __restrict__ z,
                                     float* __restrict__ dU, float* __restrict__ out, int n,
                                     float sign, float half_sigma2, float rate, float two_over_n,
                                     int causal) {
    const long long mo = member_y() * (2 * D + 2) * n;  // member: its streams and points
    U += mo;
    dU += mo;
    out += member_y() * n;
    z += member_y() * n * (D + 1);
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    float VS[D], VSS[D], cSS[D], cS[D];
    const float V = U[i];
    for_groups<0, D>([&](auto g_) {
        constexpr int g = decltype(g_)::value;
        VS[g] = U[(1 + 2 * g) * n + i];
        VSS[g] = U[(2 + 2 * g) * n + i];
    });
    const float Vt = U[(2 * D + 1) * n + i];
    for_groups<0, D>([&](auto g_) {
        constexpr int g = decltype(g_)::value;
        const float S = z[(long long)(D + 1) * i + g];
        cSS[g] = half_sigma2 * (S * S);
        cS[g] = rate * S;
    });
    float sum = cSS[0] * VSS[0] + cS[0] * VS[0];
    for_groups<1, D>([&](auto g_) {
        constexpr int g = decltype(g_)::value;
        sum = sum + (cSS[g] * VSS[g] + cS[g] * VS[g]);
    });
    const float r = (Vt - (sign * rate) * V) + sign * sum;
    out[i] = causal ? r : r * r;
    const float c = causal ? 1.0f : two_over_n * r;
    dU[i] = -c * (sign * rate);
    for_groups<0, D>([&](auto g_) {
        constexpr int g = decltype(g_)::value;
        dU[(1 + 2 * g) * n + i] = c * (sign * cS[g]);
        dU[(2 + 2 * g) * n + i] = c * (sign * cSS[g]);
    });
    dU[(2 * D + 1) * n + i] = c;
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
    r += member_y() * n;  // one scan per member
    sums += member_y() * gridDim.x;
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
    sums += member_y() * nb;
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
    r += member_y() * n;
    offsets += member_y() * gridDim.x;
    WR += member_y() * 2 * n;
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
    const long long e = member_y();
    dU += e * S * n;
    r += e * n;
    WR += e * 2 * n;
    sums += e * 2;
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
                                      float* __restrict__ partial, long long member_stride) {
    __shared__ float sm[8][33];
    const long long e = blockIdx.z;  // the member: A at e member_stride, g at e rows
    A += e * member_stride;
    if constexpr (WEIGHTED) g += e * rows;
    partial += e * gridDim.y * cols;
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
    partial += member_y() * chunks * cols;
    out += member_y() * cols;
    const int col = blockIdx.x * blockDim.x + threadIdx.x;
    if (col >= cols) return;
    float s = 0.0f;
    for (int c = 0; c < chunks; ++c) s += partial[(long long)c * cols + col];
    out[col] = s * scale;
}

// ---------------------------------------------------------------- d >= 4 --
// Kernel 1 in d >= 4 space dimensions, d a run-time argument: no
// instantiation per d and no upper limit on it. The transport kernels keep
// their registers bounded by walking the x-groups one at a time. A group's
// LayerNorm statistics (its means and S1..S3) and its output streams depend
// only on its own KX streams and on what every group shares: the value
// stream's mean and r, the t-stream's mean and St, and the activation
// derivatives d_k at y0. So each group is evaluated with the one-group
// element code (RowStats<1,KX>, elem_ln<1,KX>, elem_grad<1,KX>,
// centred_grads<1,KX>) on the streams [value; group g; t1]; the registers
// are those of D = 1 whatever d. The price: the value row is read again and
// its derivatives recomputed once per group (the row stays in L1/L2: it is
// W floats per warp). The reverse is linear in the output cotangents, so the
// value stream's cotangent, its LayerNorm row terms and the scale/bias rows
// are sums over the groups of each group's share, computed with G_o0 and
// G_ot given to group 0 only; the shares are accumulated in the output rows
// that the point's warp owns (each lane reads back only what it wrote), and
// the term that needs every group (G_var0) is added in a last pass.

// The statistics every x-group shares: the value stream's mean and
// r = 1/sqrt(var0 + eps), the t-stream's mean and St = mean(c0 ct) r.
struct SharedStats {
    float mu0, muT, r, St;
};

__device__ SharedStats shared_stats(const float* h0, const float* ht, int W, int lane) {
    float a0 = 0.f, at = 0.f;
    for (int j = lane; j < W; j += 32) {
        a0 += h0[j];
        at += ht[j];
    }
    const float fw = (float)W;
    SharedStats sh;
    sh.mu0 = warp_sum(a0) / fw;
    sh.muT = warp_sum(at) / fw;
    float v0 = 0.f, v0t = 0.f;
    for (int j = lane; j < W; j += 32) {
        const float c0 = h0[j] - sh.mu0, ct = ht[j] - sh.muT;
        v0 += c0 * c0;
        v0t += c0 * ct;
    }
    sh.r = 1.0f / sqrtf(warp_sum(v0) / fw + LN_EPS);
    sh.St = (warp_sum(v0t) / fw) * sh.r;
    return sh;
}

// RowStats<1, KX> of the streams [value; the group at hg (KX streams, stride
// apart); t1]: the shared statistics and the group's own means and S1..S3,
// as row_stats computes them.
template <int KX>
__device__ RowStats<1, KX> group_stats(const SharedStats& sh, const float* h0, const float* hg,
                                       long long stride, int W, int lane) {
    constexpr int T = KX + 1;
    RowStats<1, KX> st;
    float a[KX];
#pragma unroll
    for (int k = 0; k < KX; ++k) a[k] = 0.f;
    for (int j = lane; j < W; j += 32) {
#pragma unroll
        for (int k = 0; k < KX; ++k) a[k] += hg[k * stride + j];
    }
    const float fw = (float)W;
    st.mu[0] = sh.mu0;
#pragma unroll
    for (int k = 0; k < KX; ++k) st.mu[1 + k] = warp_sum(a[k]) / fw;
    st.mu[T] = sh.muT;
    float v01 = 0.f, v2 = 0.f, v3 = 0.f;
    for (int j = lane; j < W; j += 32) {
        const float c0 = h0[j] - st.mu[0];
        const float c1 = hg[j] - st.mu[1];
        v01 += c0 * c1;
        if constexpr (KX >= 2) {
            const float c2 = hg[stride + j] - st.mu[2];
            v2 += c1 * c1 + c0 * c2;
            if constexpr (KX >= 3) {
                const float c3 = hg[2 * stride + j] - st.mu[3];
                v3 += 3.0f * c1 * c2 + c0 * c3;
            }
        }
    }
    st.r = sh.r;
    st.St = sh.St;
    st.S1[0] = (warp_sum(v01) / fw) * st.r;
    st.V2[0] = st.S2[0] = st.V3[0] = st.S3[0] = 0.f;
    if constexpr (KX >= 2) {
        st.V2[0] = warp_sum(v2) / fw;
        st.S2[0] = (st.V2[0] - st.S1[0] * st.S1[0]) * st.r;
    }
    if constexpr (KX >= 3) {
        st.V3[0] = warp_sum(v3) / fw;
        st.S3[0] = (st.V3[0] - 3.0f * st.S1[0] * st.S2[0]) * st.r;
    }
    return st;
}

// v = [p[j]; the group's KX streams at p + gof; p[tof + j]] (first) or with
// the value and t entries 0 (the other groups' share of a cotangent).
template <int KX>
__device__ __forceinline__ void load_group(const float* p, long long gof, long long tof,
                                           long long stride, int j, bool ends, float* v) {
    v[0] = ends ? p[j] : 0.f;
#pragma unroll
    for (int k = 0; k < KX; ++k) v[1 + k] = p[gof + k * stride + j];
    v[KX + 1] = ends ? p[tof + j] : 0.f;
}

// H: stacked ((2 + dim KX) n, W) pre-activations; A as transport_fwd_kernel.
template <int KX>
__global__ void transport_fwd_nd_kernel(const float* __restrict__ H,
                                        const float* __restrict__ gamma,
                                        const float* __restrict__ beta, float* __restrict__ A,
                                        int n, int W, int dim, int use_ln, int act) {
    constexpr int T = KX + 1;
    const long long e = member_y(), ns = 2 + (long long)dim * KX;
    H += e * ns * n * W;
    A += e * ns * n * W;
    if (use_ln) {
        gamma += e * W;
        beta += e * W;
    }
    const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (warp >= n) return;
    const long long stride = (long long)n * W;
    const long long tof = (1LL + (long long)dim * KX) * stride;
    const float* h = H + (long long)warp * W;
    float* o = A + (long long)warp * W;
    SharedStats sh{};
    if (use_ln) sh = shared_stats(h, h + tof, W, lane);
#pragma unroll 1
    for (int g = 0; g < dim; ++g) {
        const long long gof = (1LL + (long long)g * KX) * stride;
        RowStats<1, KX> st;
        if (use_ln) st = group_stats<KX>(sh, h, h + gof, stride, W, lane);
        for (int j = lane; j < W; j += 32) {
            float hv[KX + 2];
            load_group<KX>(h, gof, tof, stride, j, true, hv);
            const Elem<1, KX> e = use_ln ? elem_ln<1, KX>(st, hv, gamma[j], beta[j], act)
                                         : elem_plain<1, KX>(hv, act);
            float* og = o + gof;
            og[j] = e.d[1] * e.y[1];
            if constexpr (KX >= 2)
                og[stride + j] = e.d[1] * e.y[2] + e.d[2] * e.y[1] * e.y[1];
            if constexpr (KX >= 3)
                og[2 * stride + j] = e.d[1] * e.y[3] + 3.0f * e.d[2] * e.y[1] * e.y[2]
                                   + e.d[3] * e.y[1] * e.y[1] * e.y[1];
            if (g == 0) {
                o[j] = e.d[0];
                o[tof + j] = e.d[1] * e.y[T];
            }
        }
    }
}

// The reverse of transport_fwd_nd_kernel; arguments as transport_bwd_kernel.
template <int KX>
__global__ void transport_bwd_nd_kernel(const float* __restrict__ H,
                                        const float* __restrict__ gamma,
                                        const float* __restrict__ beta,
                                        const float* __restrict__ GA, float* __restrict__ GH,
                                        float* __restrict__ Ggamma, float* __restrict__ Gbeta,
                                        int n, int W, int dim, int use_ln, int act) {
    constexpr int T = KX + 1;
    constexpr int NS = KX + 2;
    const long long e = member_y(), ns = 2 + (long long)dim * KX;
    H += e * ns * n * W;
    GA += e * ns * n * W;
    GH += e * ns * n * W;
    if (use_ln) {
        gamma += e * W;
        beta += e * W;
        Ggamma += e * n * W;
        Gbeta += e * n * W;
    }
    const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (warp >= n) return;
    const long long stride = (long long)n * W;
    const long long tof = (1LL + (long long)dim * KX) * stride;
    const long long base = (long long)warp * W;
    const float* h = H + base;
    const float* ga = GA + base;
    float* o = GH + base;

    if (!use_ln) {
#pragma unroll 1
        for (int g = 0; g < dim; ++g) {
            const long long gof = (1LL + (long long)g * KX) * stride;
            for (int j = lane; j < W; j += 32) {
                float hv[NS], Go[NS];
                load_group<KX>(h, gof, tof, stride, j, true, hv);
                load_group<KX>(ga, gof, tof, stride, j, g == 0, Go);
                const Elem<1, KX> e = elem_plain<1, KX>(hv, act);
                const ElemGrad<1, KX> gr = elem_grad<1, KX>(e, RowStats<1, KX>{}, 1.0f, Go, 0);
#pragma unroll
                for (int k = 0; k < KX; ++k) o[gof + k * stride + j] = gr.Gy[1 + k];
                if (g == 0) {
                    o[j] = gr.Gy[0];
                    o[tof + j] = gr.Gy[T];
                } else {
                    o[j] += gr.Gy[0];
                }
            }
        }
        return;
    }

    const SharedStats sh = shared_stats(h, h + tof, W, lane);
    const float r = sh.r;
    const float inv_w = 1.0f / (float)W;
    float GSt = 0.f;
    // G_r's numerator: Rtt + G_St St + R00 + per group sum_k R_kk + G_Sk S_k.
    float num = 0.f;
#pragma unroll 1
    for (int g = 0; g < dim; ++g) {
        const bool first = g == 0;
        const long long gof = (1LL + (long long)g * KX) * stride;
        const RowStats<1, KX> st = group_stats<KX>(sh, h, h + gof, stride, W, lane);
        // Pass A: the group's row sums R_kj (as transport_bwd_kernel's, one
        // group), its share of R00, and (group 0) Rt0 and Rtt; the scale and
        // bias rows take the group's share.
        float R00 = 0.f, Rt0 = 0.f, Rtt = 0.f;
        float R10 = 0.f, R11 = 0.f, R20 = 0.f, R21 = 0.f, R22 = 0.f;
        float R30 = 0.f, R31 = 0.f, R32 = 0.f, R33 = 0.f;
        for (int j = lane; j < W; j += 32) {
            const float gm = gamma[j];
            float hv[NS], Go[NS];
            load_group<KX>(h, gof, tof, stride, j, true, hv);
            load_group<KX>(ga, gof, tof, stride, j, first, Go);
            const Elem<1, KX> e = elem_ln<1, KX>(st, hv, gm, beta[j], act);
            const ElemGrad<1, KX> gr = elem_grad<1, KX>(e, st, gm, Go, 1);
            Rt0 += gr.Gq[T] * e.q[0];
            Rtt += gr.Gq[T] * e.q[T];
            R10 += gr.Gq[1] * e.q[0];
            R11 += gr.Gq[1] * e.q[1];
            if constexpr (KX >= 2) {
                R20 += gr.Gq[2] * e.q[0];
                R21 += gr.Gq[2] * e.q[1];
                R22 += gr.Gq[2] * e.q[2];
            }
            if constexpr (KX >= 3) {
                R30 += gr.Gq[3] * e.q[0];
                R31 += gr.Gq[3] * e.q[1];
                R32 += gr.Gq[3] * e.q[2];
                R33 += gr.Gq[3] * e.q[3];
            }
            R00 += gr.Gq[0] * e.q[0];
            float gg = 0.f;
#pragma unroll
            for (int s = 0; s <= T; ++s) gg += gr.Gy[s] * e.q[s];
            if (first) {
                Ggamma[base + j] = gg;
                Gbeta[base + j] = gr.Gy[0];
            } else {
                Ggamma[base + j] += gg;
                Gbeta[base + j] += gr.Gy[0];
            }
        }
        // The group's row scalars (transport_bwd_kernel's formulas for one
        // group); G_var0 is left to the last pass.
        RowScalars<1> sc;
        if (first) {
            GSt = -warp_sum(Rt0) * r;
            num = warp_sum(Rtt) + GSt * st.St;
        }
        sc.GSt = first ? GSt : 0.f;
        sc.Gvar0 = 0.f;
        R10 = warp_sum(R10);
        float rdiag = warp_sum(R11);
        sc.GS1[0] = -R10 * r;
        sc.GS2[0] = sc.GS3[0] = sc.GV3[0] = 0.f;
        if constexpr (KX >= 2) {
            R21 = warp_sum(R21);
            sc.GS2[0] = -warp_sum(R20) * r;
            sc.GS1[0] = -2.0f * R21 * r - R10 * r;
            rdiag += warp_sum(R22);
        }
        if constexpr (KX >= 3) {
            sc.GS3[0] = -warp_sum(R30) * r;
            sc.GS2[0] = sc.GS2[0] - 3.0f * warp_sum(R31) * r - 3.0f * st.S1[0] * r * sc.GS3[0];
            sc.GS1[0] = sc.GS1[0] - 3.0f * warp_sum(R32) * r - 3.0f * st.S2[0] * r * sc.GS3[0];
            sc.GV3[0] = sc.GS3[0] * r;
            rdiag += warp_sum(R33) + sc.GS3[0] * st.S3[0];
        }
        sc.GV2[0] = sc.GS2[0] * r;
        if constexpr (KX >= 2) sc.GS1[0] = sc.GS1[0] - 2.0f * st.S1[0] * r * sc.GS2[0];
        num += rdiag + sc.GS2[0] * st.S2[0] + sc.GS1[0] * st.S1[0] + warp_sum(R00);

        // Pass B: means of the group's (and, group 0, the t-stream's) centred
        // cotangents.
        float m[NS];
#pragma unroll
        for (int s = 0; s < NS; ++s) m[s] = 0.f;
        for (int j = lane; j < W; j += 32) {
            const float gm = gamma[j];
            float hv[NS], Go[NS], Gc[NS];
            load_group<KX>(h, gof, tof, stride, j, true, hv);
            load_group<KX>(ga, gof, tof, stride, j, first, Go);
            const Elem<1, KX> e = elem_ln<1, KX>(st, hv, gm, beta[j], act);
            const ElemGrad<1, KX> gr = elem_grad<1, KX>(e, st, gm, Go, 1);
            centred_grads<1, KX>(e, gr, st, sc, inv_w, Gc);
#pragma unroll
            for (int s = 1; s < NS; ++s) m[s] += Gc[s];
        }
#pragma unroll
        for (int s = 1; s < NS; ++s) m[s] = warp_sum(m[s]) * inv_w;

        // Pass C: G_h = G_c - mean(G_c) for the group's streams (and the
        // t-stream); the value stream's share of G_c0 is summed in its row.
        for (int j = lane; j < W; j += 32) {
            const float gm = gamma[j];
            float hv[NS], Go[NS], Gc[NS];
            load_group<KX>(h, gof, tof, stride, j, true, hv);
            load_group<KX>(ga, gof, tof, stride, j, first, Go);
            const Elem<1, KX> e = elem_ln<1, KX>(st, hv, gm, beta[j], act);
            const ElemGrad<1, KX> gr = elem_grad<1, KX>(e, st, gm, Go, 1);
            centred_grads<1, KX>(e, gr, st, sc, inv_w, Gc);
#pragma unroll
            for (int k = 0; k < KX; ++k) o[gof + k * stride + j] = Gc[1 + k] - m[1 + k];
            if (first) {
                o[tof + j] = Gc[T] - m[T];
                o[j] = Gc[0];
            } else {
                o[j] += Gc[0];
            }
        }
    }
    // The value stream: G_c0 += 2 G_var0 c0 / W, then centring.
    const float Gvar0 = -0.5f * r * r * r * (num / r);
    float m0 = 0.f;
    for (int j = lane; j < W; j += 32) m0 += o[j] + 2.0f * Gvar0 * (h[j] - sh.mu0) * inv_w;
    m0 = warp_sum(m0) * inv_w;
    for (int j = lane; j < W; j += 32) o[j] = o[j] + 2.0f * Gvar0 * (h[j] - sh.mu0) * inv_w - m0;
}

// The affine map of axis a (a < dim) or of t (a = dim) for the point at zr,
// as affine_map.
__device__ __forceinline__ float affine_nd(const float* __restrict__ zr,
                                           const float* __restrict__ lo,
                                           const float* __restrict__ sc, int dim, int a,
                                           int frame, float c) {
    const float t = zr[dim];
    const float x = a == dim ? t : frame ? __fsub_rn(zr[a], __fmul_rn(c, t)) : zr[a];
    return (x - lo[a]) * sc[a] - 1.0f;
}

// d p / dt of feature j (constant over the batch), as embed_kernel: s sc_t
// B_tj, in a frame also -c s sum_ax sc_ax B_axj.
__device__ __forceinline__ float t_rate_nd(const float* __restrict__ sc,
                                           const float* __restrict__ B, int m, int j, int dim,
                                           float s, int frame, float c) {
    float v = 0.f;
    if (frame)
        for (int a = 0; a < dim; ++a) v = v + (-c * sc[a]) * B[(long long)a * m + j];
    return s * (v + sc[dim] * B[(long long)dim * m + j]);
}

template <int KX>
__global__ void embed_nd_kernel(const float* __restrict__ z, const float* __restrict__ lo,
                                const float* __restrict__ sc, const float* __restrict__ B,
                                float* __restrict__ X, int n, int m, int dim, float s, int frame,
                                float c, long long sB) {
    const long long e = member_y();
    z += e * n * (dim + 1);
    B += e * sB;
    X += e * (2 + (long long)dim * KX) * n * 2 * m;
    const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= (long long)n * m) return;
    const int row = (int)(idx / m);
    const int j = (int)(idx % m);
    const float* zr = z + (long long)(dim + 1) * row;
    float acc = 0.f;
    for (int a = 0; a <= dim; ++a)
        acc = acc + affine_nd(zr, lo, sc, dim, a, frame, c) * B[(long long)a * m + j];
    const float p1t = t_rate_nd(sc, B, m, j, dim, s, frame, c);
    float sn, cs;
    sincosf(s * acc, &sn, &cs);
    const long long w2 = 2LL * m;
    const long long stride = (long long)n * w2;
    float* r0 = X + (long long)row * w2;
    r0[j] = sn;
    r0[m + j] = cs;
    for (int g = 0; g < dim; ++g) {
        const float p1x = s * (sc[g] * B[(long long)g * m + j]);
        float sk = sn, ck = cs;
#pragma unroll
        for (int k = 1; k <= KX; ++k) {
            const float s_next = ck * p1x, c_next = -sk * p1x;
            sk = s_next;
            ck = c_next;
            float* rk = r0 + (1LL + (long long)g * KX + k - 1) * stride;
            rk[j] = sk;
            rk[m + j] = ck;
        }
    }
    float* rt = r0 + (1LL + (long long)dim * KX) * stride;
    rt[j] = cs * p1t;
    rt[m + j] = -sn * p1t;
}

// Axis rows of dL/dB per block of embed_bwd_nd_partial_kernel: blocks along
// z take the (d + 1) rows in tiles of this many, so the dynamic shared
// memory stays at most 32 x 8 x 33 floats (33.8 KB) for any d.
constexpr int EMBED_BWD_AXES = 32;

// dL/dB of a trainable basis in d >= 4 dimensions: embed_bwd_partial_kernel's
// terms, accumulated per thread in its slots of shared memory (one per axis
// row of the block's tile) instead of registers. A block along z recomputes
// the per-point terms and keeps only its tile's rows.
template <int KX>
__global__ void embed_bwd_nd_partial_kernel(const float* __restrict__ z,
                                            const float* __restrict__ lo,
                                            const float* __restrict__ sc,
                                            const float* __restrict__ B,
                                            const float* __restrict__ G, int n, int m, int dim,
                                            float s, int frame, float c,
                                            float* __restrict__ partial, long long sB) {
    extern __shared__ float sm[];  // [axis row of the tile][8][33]
    constexpr int SLOT = 8 * 33;
    const int tiles = (dim + EMBED_BWD_AXES) / EMBED_BWD_AXES;  // blockIdx.z = member * tiles + tile
    const long long e = blockIdx.z / tiles;
    z += e * n * (dim + 1);
    B += e * sB;
    G += e * (2 + (long long)dim * KX) * n * 2 * m;
    partial += e * gridDim.y * (dim + 1) * m;
    const int j = blockIdx.x * 32 + threadIdx.x;
    const int r0 = blockIdx.y * COLSUM_ROWS;
    const int r1 = min(n, r0 + COLSUM_ROWS);
    const int a0 = (blockIdx.z % tiles) * EMBED_BWD_AXES;
    const int a1 = min(dim + 1, a0 + EMBED_BWD_AXES);
    float* mine = sm + threadIdx.y * 33 + threadIdx.x;
    for (int a = a0; a < a1; ++a) mine[(a - a0) * SLOT] = 0.0f;
    if (j < m) {
        const float p1t = t_rate_nd(sc, B, m, j, dim, s, frame, c);
        const long long w2 = 2LL * m;
        const long long stride = (long long)n * w2;
        for (int row = r0 + threadIdx.y; row < r1; row += 8) {
            const float* zr = z + (long long)(dim + 1) * row;
            float pj = 0.f;
            for (int a = 0; a <= dim; ++a)
                pj = pj + affine_nd(zr, lo, sc, dim, a, frame, c) * B[(long long)a * m + j];
            float sn, cs;
            sincosf(s * pj, &sn, &cs);
            const float* g0 = G + (long long)row * w2;
            float dp = g0[j] * cs - g0[m + j] * sn;
            for (int g = 0; g < dim; ++g) {
                const float p1x = s * (sc[g] * B[(long long)g * m + j]);
                float sk = sn, ck = cs, pk = 1.0f, dq = 0.0f;
#pragma unroll
                for (int k = 1; k <= KX; ++k) {
                    const float* gk = g0 + (1LL + (long long)g * KX + k - 1) * stride;
                    const float gs = gk[j], gc = gk[m + j];
                    const float s_next = ck, c_next = -sk;  // sin^(k)(p), cos^(k)(p)
                    sk = s_next;
                    ck = c_next;
                    dq += (float)k * pk * (gs * sk + gc * ck);  // pk = p1^(k-1)
                    pk *= p1x;
                    dp += pk * (gs * ck - gc * sk);
                }
                if (g >= a0 && g < a1) mine[(g - a0) * SLOT] += sc[g] * dq;
            }
            const float* gt = g0 + (1LL + (long long)dim * KX) * stride;
            const float gs = gt[j], gc = gt[m + j];
            dp += p1t * (-gs * sn - gc * cs);
            const float dqt = gs * cs - gc * sn;
            for (int a = a0; a < a1; ++a) {
                // The t-direction in input space: -c sc_ax in a frame, sc_t.
                const float vt = a == dim ? sc[dim] : frame ? -c * sc[a] : 0.0f;
                mine[(a - a0) * SLOT] +=
                    affine_nd(zr, lo, sc, dim, a, frame, c) * dp + vt * dqt;
            }
        }
    }
    __syncthreads();
    if (threadIdx.y == 0 && j < m) {
        for (int a = a0; a < a1; ++a) {
            float t = 0.0f;
#pragma unroll
            for (int k = 0; k < 8; ++k) t += sm[(a - a0) * SLOT + k * 33 + threadIdx.x];
            partial[(long long)blockIdx.y * (dim + 1) * m + (long long)a * m + j] = t;
        }
    }
}

// The feedforward trunk's stacked ((2 + dim kx) n, dim+1) input, as
// affine_input_kernel. One thread per point.
__global__ void affine_input_nd_kernel(const float* __restrict__ z, const float* __restrict__ lo,
                                       const float* __restrict__ sc, float* __restrict__ X, int n,
                                       int kx, int dim, int frame, float c) {
    const int C = dim + 1;  // columns
    const long long e = member_y();
    z += e * n * C;
    X += e * (2 + (long long)dim * kx) * n * C;
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const long long stride = (long long)C * n;
    const float* zr = z + (long long)C * i;
    float* r = X + (long long)C * i;
    for (int a = 0; a < C; ++a) r[a] = affine_nd(zr, lo, sc, dim, a, frame, c);
    for (int g = 0; g < (kx ? dim : 0); ++g) {
        float* rg = r + (1 + (long long)g * kx) * stride;
        for (int a = 0; a < C; ++a) rg[a] = a == g ? sc[a] : 0.0f;
        for (int k = 2; k <= kx; ++k)
            for (int a = 0; a < C; ++a) rg[(k - 1) * stride + a] = 0.0f;
    }
    float* rt = r + (1 + (long long)dim * kx) * stride;
    for (int a = 0; a < dim; ++a) rt[a] = frame ? -c * sc[a] : 0.0f;
    rt[dim] = sc[dim];
}

// The residuals with d a loop bound (U, dU and out as the templated
// kernels'); the sums over the axes start from 0 and run in axis order.
__device__ __forceinline__ long long row_of(int stream, int n) { return (long long)stream * n; }

__global__ void burgers_nd_kernel(const float* __restrict__ U, float* __restrict__ dU,
                                  float* __restrict__ out, int n, int dim, float nu,
                                  float two_over_n, int causal) {
    const long long mo = member_y() * (2 * dim + 2) * n;  // member: its streams
    U += mo;
    dU += mo;
    out += member_y() * n;
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float u = U[i], ut = U[row_of(2 * dim + 1, n) + i];
    float ux = 0.f, uxx = 0.f;
    for (int g = 0; g < dim; ++g) {
        ux = ux + U[row_of(1 + 2 * g, n) + i];
        uxx = uxx + U[row_of(2 + 2 * g, n) + i];
    }
    const float r = (ut + u * ux) - nu * uxx;
    const float c = causal ? 1.0f : two_over_n * r;
    out[i] = causal ? r : r * r;
    dU[i] = causal ? ux : c * ux;
    for (int g = 0; g < dim; ++g) {
        dU[row_of(1 + 2 * g, n) + i] = causal ? u : c * u;
        dU[row_of(2 + 2 * g, n) + i] = causal ? -nu : -c * nu;
    }
    dU[row_of(2 * dim + 1, n) + i] = c;
}

__global__ void heat_nd_kernel(const float* __restrict__ U, float* __restrict__ dU,
                               float* __restrict__ out, int n, int dim, float alpha,
                               float two_over_n, int causal) {
    const long long mo = member_y() * (2 * dim + 2) * n;  // member: its streams
    U += mo;
    dU += mo;
    out += member_y() * n;
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    float uxx = 0.f;
    for (int g = 0; g < dim; ++g) uxx = uxx + U[row_of(2 + 2 * g, n) + i];
    const float r = U[row_of(2 * dim + 1, n) + i] - alpha * uxx;
    out[i] = causal ? r : r * r;
    const float c = causal ? 1.0f : two_over_n * r;
    dU[i] = 0.0f;
    for (int g = 0; g < dim; ++g) {
        dU[row_of(1 + 2 * g, n) + i] = 0.0f;
        dU[row_of(2 + 2 * g, n) + i] = -c * alpha;
    }
    dU[row_of(2 * dim + 1, n) + i] = c;
}

__global__ void kdv_nd_kernel(const float* __restrict__ U, float* __restrict__ dU,
                              float* __restrict__ out, int n, int dim, float two_over_n,
                              int causal) {
    const long long mo = member_y() * (3 * dim + 2) * n;  // member: its streams
    U += mo;
    dU += mo;
    out += member_y() * n;
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float u = U[i], ut = U[row_of(3 * dim + 1, n) + i];
    float ux = 0.f, uxxx = 0.f;
    for (int g = 0; g < dim; ++g) {
        ux = ux + U[row_of(1 + 3 * g, n) + i];
        uxxx = uxxx + U[row_of(3 + 3 * g, n) + i];
    }
    const float r = ut + 6.0f * u * ux + uxxx;
    out[i] = causal ? r : r * r;
    const float c = causal ? 1.0f : two_over_n * r;
    dU[i] = c * (6.0f * ux);
    for (int g = 0; g < dim; ++g) {
        dU[row_of(1 + 3 * g, n) + i] = c * (6.0f * u);
        dU[row_of(2 + 3 * g, n) + i] = 0.0f;
        dU[row_of(3 + 3 * g, n) + i] = c;
    }
    dU[row_of(3 * dim + 1, n) + i] = c;
}

// v: the d velocities in device memory.
__global__ void convection_nd_kernel(const float* __restrict__ U, float* __restrict__ dU,
                                     float* __restrict__ out, int n, int dim,
                                     const float* __restrict__ v, float two_over_n, int causal) {
    const long long mo = member_y() * (dim + 2) * n;  // member: its streams
    U += mo;
    dU += mo;
    out += member_y() * n;
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    float vx = 0.f;
    for (int g = 0; g < dim; ++g) vx = vx + v[g] * U[row_of(1 + g, n) + i];
    const float r = U[row_of(dim + 1, n) + i] + vx;
    out[i] = causal ? r : r * r;
    const float c = causal ? 1.0f : two_over_n * r;
    dU[i] = 0.0f;
    for (int g = 0; g < dim; ++g) dU[row_of(1 + g, n) + i] = c * v[g];
    dU[row_of(dim + 1, n) + i] = c;
}

__global__ void allen_cahn_nd_kernel(const float* __restrict__ U, float* __restrict__ dU,
                                     float* __restrict__ out, int n, int dim, float eps2,
                                     float two_over_n, int causal) {
    const long long mo = member_y() * (2 * dim + 2) * n;  // member: its streams
    U += mo;
    dU += mo;
    out += member_y() * n;
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float u = U[i], ut = U[row_of(2 * dim + 1, n) + i];
    float uxx = 0.f;
    for (int g = 0; g < dim; ++g) uxx = uxx + U[row_of(2 + 2 * g, n) + i];
    const float r = ((ut - eps2 * uxx) - u) + u * u * u;
    out[i] = causal ? r : r * r;
    const float c = causal ? 1.0f : two_over_n * r;
    dU[i] = c * (3.0f * u * u - 1.0f);
    for (int g = 0; g < dim; ++g) {
        dU[row_of(1 + 2 * g, n) + i] = 0.0f;
        dU[row_of(2 + 2 * g, n) + i] = -c * eps2;
    }
    dU[row_of(2 * dim + 1, n) + i] = c;
}

// S = z[i, ax] along each axis ax.
__global__ void black_scholes_nd_kernel(const float* __restrict__ U, const float* __restrict__ z,
                                        float* __restrict__ dU, float* __restrict__ out, int n,
                                        int dim, float sign, float half_sigma2, float rate,
                                        float two_over_n, int causal) {
    const long long mo = member_y() * (2 * dim + 2) * n;  // member: its streams and points
    U += mo;
    dU += mo;
    out += member_y() * n;
    z += member_y() * n * (dim + 1);
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float* zr = z + (long long)(dim + 1) * i;
    const float V = U[i], Vt = U[row_of(2 * dim + 1, n) + i];
    float sum = 0.f;
    for (int g = 0; g < dim; ++g) {
        const float S = zr[g];
        sum = sum + (half_sigma2 * (S * S) * U[row_of(2 + 2 * g, n) + i]
                     + rate * S * U[row_of(1 + 2 * g, n) + i]);
    }
    const float r = (Vt - (sign * rate) * V) + sign * sum;
    out[i] = causal ? r : r * r;
    const float c = causal ? 1.0f : two_over_n * r;
    dU[i] = -c * (sign * rate);
    for (int g = 0; g < dim; ++g) {
        const float S = zr[g];
        dU[row_of(1 + 2 * g, n) + i] = c * (sign * (rate * S));
        dU[row_of(2 + 2 * g, n) + i] = c * (sign * (half_sigma2 * (S * S)));
    }
    dU[row_of(2 * dim + 1, n) + i] = c;
}

inline unsigned cdiv(long long a, long long b) { return (unsigned)((a + b - 1) / b); }

}  // namespace

// ------------------------------------------------------- C entry points --
// Each launches on the given stream and returns cudaGetLastError() (or
// cudaErrorInvalidValue for an x-order other than 1, 2 or 3 (the input
// kernels also take 0: an ODE, no x-group), a number of space dimensions
// below 1 (the transport also takes 0: no x-group), or an unknown activation
// code). dim = 1, 2 or 3 runs the kernels templated on D; dim >= 4 the *_nd
// kernels; the transport's dim = 0 its kernels at D = 0. `members` (>= 1)
// stacked members run in the one launch of each kernel: every tensor holds
// the members' single-member layouts one after another, and a shared
// operand (a fixed basis) has a member stride of 0.

inline bool kx_ok(int kx) { return kx >= 1 && kx <= 3; }
inline bool kx0_ok(int kx) { return kx >= 0 && kx <= 3; }  // the inputs: 0 for an ODE
inline bool dim_ok(int dim) { return dim >= 1; }
inline bool use_nd(int dim) { return dim > 3; }
inline bool act_ok(int act) { return act >= ACT_TANH && act <= ACT_SIN; }
inline bool members_ok(int members) { return members >= 1 && members <= 65535; }

template <int V>
using Int = std::integral_constant<int, V>;

// fn(Int<D>{}) for the runtime dim (checked by dim_ok).
template <typename Fn>
inline void with_dim(int dim, Fn&& fn) {
    if (dim == 3)
        fn(Int<3>{});
    else if (dim == 2)
        fn(Int<2>{});
    else
        fn(Int<1>{});
}

// fn(Int<KX>{}) for the runtime kx (checked by kx_ok).
template <typename Fn>
inline void with_kx(int kx, Fn&& fn) {
    if (kx == 3)
        fn(Int<3>{});
    else if (kx == 2)
        fn(Int<2>{});
    else
        fn(Int<1>{});
}

// fn(Int<KX>{}) for the runtime kx, 0 included (checked by kx0_ok).
template <typename Fn>
inline void with_kx0(int kx, Fn&& fn) {
    if (kx == 0)
        fn(Int<0>{});
    else
        with_kx(kx, fn);
}

// fn(Int<D>{}, Int<KX>{}) for the runtime dim and kx (checked by dim_ok, kx_ok).
template <typename Fn>
inline void with_dim_kx(int dim, int kx, Fn&& fn) {
    with_dim(dim, [&](auto d) { with_kx(kx, [&](auto k) { fn(d, k); }); });
}

// X ((2 + dim kx) n, 2m): the Fourier trunk's stacked input of z (n, dim+1);
// frame != 0: a co-moving frame of speed c.
extern "C" int fr_embed(const float* z, const float* lo, const float* sc, const float* B,
                        float* X, int n, int m, int two_pi, int kx, int dim, int frame, float c,
                        int members, long long sB, void* stream) {
    const float s = two_pi ? 6.283185307179586f : 1.0f;
    const long long total = (long long)n * m;
    if (!kx0_ok(kx) || !dim_ok(dim) || !members_ok(members)) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)cdiv(total, 256), (unsigned)members);
    if (total > 0 && use_nd(dim))
        with_kx0(kx, [&](auto k) {
            embed_nd_kernel<decltype(k)::value><<<grid, 256, 0, (cudaStream_t)stream>>>(
                z, lo, sc, B, X, n, m, dim, s, frame, c, sB);
        });
    else if (total > 0)
        with_dim(dim, [&](auto d) {
            with_kx0(kx, [&](auto k) {
                embed_kernel<decltype(d)::value, decltype(k)::value>
                    <<<grid, 256, 0, (cudaStream_t)stream>>>(z, lo, sc, B, X, n, m, s, frame, c,
                                                             sB);
            });
        });
    return (int)cudaGetLastError();
}

// dB ((dim+1), m) of a trainable basis from G ((2 + dim kx) n, 2m), the
// cotangent of fr_embed's X; partial: ceil(n / COLSUM_ROWS) x (dim+1) m;
// each per member.
extern "C" int fr_embed_bwd(const float* z, const float* lo, const float* sc, const float* B,
                            const float* G, int n, int m, int two_pi, int kx, int dim, int frame,
                            float c, float* partial, float* dB, int members, long long sB,
                            void* stream) {
    const float s = two_pi ? 6.283185307179586f : 1.0f;
    if (!kx0_ok(kx) || !dim_ok(dim) || !members_ok(members)) return (int)cudaErrorInvalidValue;
    const int chunks = (int)cdiv(n, COLSUM_ROWS);
    const int cols = (dim + 1) * m;
    if (n > 0 && m > 0) {
        if (use_nd(dim)) {
            const int tiles = (int)cdiv(dim + 1, EMBED_BWD_AXES);
            const int rows = dim + 1 < EMBED_BWD_AXES ? dim + 1 : EMBED_BWD_AXES;
            const size_t smem = sizeof(float) * 8 * 33 * (size_t)rows;
            with_kx0(kx, [&](auto k) {
                embed_bwd_nd_partial_kernel<decltype(k)::value>
                    <<<dim3(cdiv(m, 32), (unsigned)chunks, (unsigned)(tiles * members)),
                       dim3(32, 8), smem, (cudaStream_t)stream>>>(z, lo, sc, B, G, n, m, dim, s,
                                                                  frame, c, partial, sB);
            });
        } else {
            with_dim(dim, [&](auto d) {
                with_kx0(kx, [&](auto k) {
                    embed_bwd_partial_kernel<decltype(d)::value, decltype(k)::value>
                        <<<dim3(cdiv(m, 32), (unsigned)chunks, (unsigned)members), dim3(32, 8), 0,
                           (cudaStream_t)stream>>>(z, lo, sc, B, G, n, m, s, frame, c, partial,
                                                   sB);
                });
            });
        }
        colsum_final_kernel<<<dim3(cdiv(cols, 256), (unsigned)members), 256, 0,
                              (cudaStream_t)stream>>>(partial, chunks, cols, s, dB);
    }
    return (int)cudaGetLastError();
}
// X ((2 + dim kx) n, dim+1): the feedforward trunk's stacked input.
extern "C" int fr_affine_input(const float* z, const float* lo, const float* sc, float* X, int n,
                               int kx, int dim, int frame, float c, int members, void* stream) {
    if (!kx0_ok(kx) || !dim_ok(dim) || !members_ok(members)) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)cdiv(n, 256), (unsigned)members);
    if (n > 0 && use_nd(dim))
        affine_input_nd_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(z, lo, sc, X, n, kx, dim,
                                                                       frame, c);
    else if (n > 0)
        with_dim(dim, [&](auto d) {
            affine_input_kernel<decltype(d)::value>
                <<<grid, 256, 0, (cudaStream_t)stream>>>(z, lo, sc, X, n, kx, frame, c);
        });
    return (int)cudaGetLastError();
}

// The layouts pick the kernel (sm90_gemm): kernel 1's forward (A and B
// k-contiguous), dX (A k-contiguous, B n-contiguous) and dW (A m-contiguous,
// B n-contiguous). Member e's product: A + e sae, B + e sbe, C + e sce, bias
// + e s_bias.
extern "C" int fr_gemm(int M, int N, int K, const float* A, long long sam, long long sak,
                       const float* B, long long sbk, long long sbn, float* C, long long ldc,
                       const float* bias, int bias_rows, int splits, int k_chunk,
                       long long split_stride, int members, long long sae, long long sbe,
                       long long sce, long long s_bias, void* stream) {
    if (members == 1) {
        sm90_gemm<true>(M, N, K, A, sam, sak, B, sbk, sbn, C, ldc, bias, bias_rows, splits,
                        k_chunk, split_stride, (cudaStream_t)stream);
        return (int)cudaGetLastError();
    }
    if (!members_ok(members) || (long long)splits * members > 65535 ||
        !sm90_gemm_members_ok(M, N, sam, sbn, sae, sbe, members))
        return (int)cudaErrorInvalidValue;
    sm90_gemm_members<true>(M, N, K, A, sam, sak, B, sbk, sbn, C, ldc, bias, bias_rows, splits,
                            k_chunk, split_stride, members, sae, sbe, sce, s_bias,
                            (cudaStream_t)stream);
    return (int)cudaGetLastError();
}

// Y (R, 1) = X (R, K) w^T (+ b on the first bias_rows rows), per member.
extern "C" int fr_rowdot(const float* X, const float* w, const float* b, float* Y, int R, int K,
                         int bias_rows, int members, void* stream) {
    if (!members_ok(members)) return (int)cudaErrorInvalidValue;
    const int vec = K % 4 == 0 && (reinterpret_cast<uintptr_t>(X) & 15) == 0 &&
                    (reinterpret_cast<uintptr_t>(w) & 15) == 0;
    if (R > 0)
        rowdot_kernel<<<dim3(cdiv(R, ROW_THREADS / 32), (unsigned)members), ROW_THREADS, 0,
                        (cudaStream_t)stream>>>(X, w, b, Y, R, K, bias_rows, vec);
    return (int)cudaGetLastError();
}

// out (R, K) = g (R, 1) w (1, K), per member.
extern "C" int fr_outer(const float* g, const float* w, float* out, int R, int K, int members,
                        void* stream) {
    if (!members_ok(members)) return (int)cudaErrorInvalidValue;
    const int vec = K % 4 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0 &&
                    (reinterpret_cast<uintptr_t>(out) & 15) == 0;
    const long long total = (long long)R * (vec ? K / 4 : K);
    if (total > 0)
        outer_kernel<<<dim3(cdiv(total, 256), (unsigned)members), 256, 0, (cudaStream_t)stream>>>(
            g, w, out, R, K, vec);
    return (int)cudaGetLastError();
}

// act: one of ACT_* (ops/kernels/fused_step.py: _ACT_CODES).
extern "C" int fr_transport_fwd(const float* H, const float* gamma, const float* beta, float* A,
                                int n, int W, int use_ln, int kx, int dim, int act, int members,
                                void* stream) {
    if (!kx_ok(kx) || dim < 0 || !act_ok(act) || !members_ok(members))
        return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)cdiv(n, 8), (unsigned)members);
    if (n > 0 && dim == 0)  // no x-group: [value; t1], d0..d2 as at order 1
        transport_fwd_kernel<0, 1><<<grid, 256, 0, (cudaStream_t)stream>>>(
            H, gamma, beta, A, n, W, use_ln, act);
    else if (n > 0 && use_nd(dim))
        with_kx(kx, [&](auto k) {
            transport_fwd_nd_kernel<decltype(k)::value>
                <<<grid, 256, 0, (cudaStream_t)stream>>>(H, gamma, beta, A, n, W, dim,
                                                               use_ln, act);
        });
    else if (n > 0)
        with_dim_kx(dim, kx, [&](auto d, auto k) {
            transport_fwd_kernel<decltype(d)::value, decltype(k)::value>
                <<<grid, 256, 0, (cudaStream_t)stream>>>(H, gamma, beta, A, n, W, use_ln,
                                                               act);
        });
    return (int)cudaGetLastError();
}

extern "C" int fr_transport_bwd(const float* H, const float* gamma, const float* beta,
                                const float* GA, float* GH, float* Ggamma, float* Gbeta, int n,
                                int W, int use_ln, int kx, int dim, int act, int members,
                                void* stream) {
    if (!kx_ok(kx) || dim < 0 || !act_ok(act) || !members_ok(members))
        return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)cdiv(n, 8), (unsigned)members);
    if (n > 0 && dim == 0)
        transport_bwd_kernel<0, 1><<<grid, 256, 0, (cudaStream_t)stream>>>(
            H, gamma, beta, GA, GH, Ggamma, Gbeta, n, W, use_ln, act);
    else if (n > 0 && use_nd(dim))
        with_kx(kx, [&](auto k) {
            transport_bwd_nd_kernel<decltype(k)::value>
                <<<grid, 256, 0, (cudaStream_t)stream>>>(H, gamma, beta, GA, GH, Ggamma,
                                                               Gbeta, n, W, dim, use_ln, act);
        });
    else if (n > 0)
        with_dim_kx(dim, kx, [&](auto d, auto k) {
            transport_bwd_kernel<decltype(d)::value, decltype(k)::value>
                <<<grid, 256, 0, (cudaStream_t)stream>>>(H, gamma, beta, GA, GH, Ggamma,
                                                               Gbeta, n, W, use_ln, act);
        });
    return (int)cudaGetLastError();
}

// The residuals over U ((2 + dim K) n, 1); out (n, 1) and dU as U; each per member.
extern "C" int fr_burgers(const float* U, float* dU, float* out, int n, int dim, float nu,
                          int causal, int members, void* stream) {
    if (!dim_ok(dim) || !members_ok(members)) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)cdiv(n, 256), (unsigned)members);
    if (n > 0 && use_nd(dim))
        burgers_nd_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
            U, dU, out, n, dim, nu, 2.0f / (float)n, causal);
    else if (n > 0)
        with_dim(dim, [&](auto d) {
            burgers_kernel<decltype(d)::value><<<grid, 256, 0, (cudaStream_t)stream>>>(
                U, dU, out, n, nu, 2.0f / (float)n, causal);
        });
    return (int)cudaGetLastError();
}

extern "C" int fr_heat(const float* U, float* dU, float* out, int n, int dim, float alpha,
                       int causal, int members, void* stream) {
    if (!dim_ok(dim) || !members_ok(members)) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)cdiv(n, 256), (unsigned)members);
    if (n > 0 && use_nd(dim))
        heat_nd_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
            U, dU, out, n, dim, alpha, 2.0f / (float)n, causal);
    else if (n > 0)
        with_dim(dim, [&](auto d) {
            heat_kernel<decltype(d)::value><<<grid, 256, 0, (cudaStream_t)stream>>>(
                U, dU, out, n, alpha, 2.0f / (float)n, causal);
        });
    return (int)cudaGetLastError();
}

extern "C" int fr_kdv(const float* U, float* dU, float* out, int n, int dim, int causal,
                      int members, void* stream) {
    if (!dim_ok(dim) || !members_ok(members)) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)cdiv(n, 256), (unsigned)members);
    if (n > 0 && use_nd(dim))
        kdv_nd_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(U, dU, out, n, dim,
                                                                      2.0f / (float)n, causal);
    else if (n > 0)
        with_dim(dim, [&](auto d) {
            kdv_kernel<decltype(d)::value><<<grid, 256, 0, (cudaStream_t)stream>>>(
                U, dU, out, n, 2.0f / (float)n, causal);
        });
    return (int)cudaGetLastError();
}

// v: the velocity along each axis, dim floats in device memory.
extern "C" int fr_convection(const float* U, float* dU, float* out, int n, int dim,
                             const float* v, int causal, int members, void* stream) {
    if (!dim_ok(dim) || !members_ok(members)) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)cdiv(n, 256), (unsigned)members);
    if (n > 0 && use_nd(dim))
        convection_nd_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
            U, dU, out, n, dim, v, 2.0f / (float)n, causal);
    else if (n > 0)
        with_dim(dim, [&](auto d) {
            convection_kernel<decltype(d)::value><<<grid, 256, 0, (cudaStream_t)stream>>>(
                U, dU, out, n, v, 2.0f / (float)n, causal);
        });
    return (int)cudaGetLastError();
}

extern "C" int fr_allen_cahn(const float* U, float* dU, float* out, int n, int dim, float eps2,
                             int causal, int members, void* stream) {
    if (!dim_ok(dim) || !members_ok(members)) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)cdiv(n, 256), (unsigned)members);
    if (n > 0 && use_nd(dim))
        allen_cahn_nd_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
            U, dU, out, n, dim, eps2, 2.0f / (float)n, causal);
    else if (n > 0)
        with_dim(dim, [&](auto d) {
            allen_cahn_kernel<decltype(d)::value><<<grid, 256, 0, (cudaStream_t)stream>>>(
                U, dU, out, n, eps2, 2.0f / (float)n, causal);
        });
    return (int)cudaGetLastError();
}

// z: the (n, dim+1) points, S = z[i, ax] along axis ax.
extern "C" int fr_black_scholes(const float* U, const float* z, float* dU, float* out, int n,
                                int dim, float sign, float half_sigma2, float rate, int causal,
                                int members, void* stream) {
    if (!dim_ok(dim) || !members_ok(members)) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)cdiv(n, 256), (unsigned)members);
    if (n > 0 && use_nd(dim))
        black_scholes_nd_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
            U, z, dU, out, n, dim, sign, half_sigma2, rate, 2.0f / (float)n, causal);
    else if (n > 0)
        with_dim(dim, [&](auto d) {
            black_scholes_kernel<decltype(d)::value>
                <<<grid, 256, 0, (cudaStream_t)stream>>>(
                    U, z, dU, out, n, sign, half_sigma2, rate, 2.0f / (float)n, causal);
        });
    return (int)cudaGetLastError();
}

// block_sums: scratch of ceil(n / SCAN_BLOCK) floats; WR: (n, 2) output;
// each per member, one scan per member.
extern "C" int fr_causal_weights(const float* r, int n, float eps, float* block_sums, float* WR,
                                 int members, void* stream) {
    if (!members_ok(members)) return (int)cudaErrorInvalidValue;
    if (n > 0) {
        const int nb = (int)cdiv(n, SCAN_BLOCK);
        cudaStream_t st = (cudaStream_t)stream;
        const dim3 grid((unsigned)nb, (unsigned)members);
        scan_block_sums_kernel<<<grid, SCAN_BLOCK, 0, st>>>(r, n, block_sums);
        scan_offsets_kernel<<<dim3(1, (unsigned)members), SCAN_BLOCK, 0, st>>>(block_sums, nb);
        causal_weights_kernel<<<grid, SCAN_BLOCK, 0, st>>>(r, n, eps, block_sums, WR);
    }
    return (int)cudaGetLastError();
}

// sums: [sum w, sum w r^2] per member.
extern "C" int fr_causal_scale(float* dU, const float* r, const float* WR, const float* sums,
                               int n, int S, int members, void* stream) {
    if (!members_ok(members)) return (int)cudaErrorInvalidValue;
    const long long total = (long long)S * n;
    if (total > 0)
        causal_scale_kernel<<<dim3(cdiv(total, 256), (unsigned)members), 256, 0,
                              (cudaStream_t)stream>>>(dU, r, WR, sums, n, S);
    return (int)cudaGetLastError();
}

// out (members, cols): member e sums the rows of A + e member_stride;
// partial: members x ceil(rows / COLSUM_ROWS) x cols scratch.
extern "C" int fr_colsum(const float* A, int rows, int cols, long long ld, float scale,
                         float* partial, float* out, int members, long long member_stride,
                         void* stream) {
    if (!members_ok(members)) return (int)cudaErrorInvalidValue;
    const int chunks = (int)cdiv(rows, COLSUM_ROWS);
    if (cols > 0 && rows > 0) {
        dim3 grid(cdiv(cols, 32), (unsigned)chunks, (unsigned)members);
        colsum_partial_kernel<false><<<grid, dim3(32, 8), 0, (cudaStream_t)stream>>>(
            A, nullptr, rows, cols, ld, partial, member_stride);
        colsum_final_kernel<<<dim3(cdiv(cols, 256), (unsigned)members), 256, 0,
                              (cudaStream_t)stream>>>(partial, chunks, cols, scale, out);
    }
    return (int)cudaGetLastError();
}

// out (cols) = sum_r g[r] A[r, :], the fixed-order two passes of fr_colsum;
// partial: ceil(rows / COLSUM_ROWS) x cols scratch; each per member (g at e
// rows, A at e rows ld).
extern "C" int fr_wcolsum(const float* g, const float* A, int rows, int cols, long long ld,
                          float* partial, float* out, int members, void* stream) {
    if (!members_ok(members)) return (int)cudaErrorInvalidValue;
    const int chunks = (int)cdiv(rows, COLSUM_ROWS);
    if (cols > 0 && rows > 0) {
        dim3 grid(cdiv(cols, 32), (unsigned)chunks, (unsigned)members);
        colsum_partial_kernel<true><<<grid, dim3(32, 8), 0, (cudaStream_t)stream>>>(
            A, g, rows, cols, ld, partial, (long long)rows * ld);
        colsum_final_kernel<<<dim3(cdiv(cols, 256), (unsigned)members), 256, 0,
                              (cudaStream_t)stream>>>(partial, chunks, cols, 1.0f, out);
    }
    return (int)cudaGetLastError();
}

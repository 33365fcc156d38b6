// FP32 GEMM core for Hopper (sm_90a), the port's one GEMM: fused_residual.cu
// (kernel 1's products), siren.cu (kernel 3) and mlp_score.cu (kernel 4's
// hidden product). Each is built into its own library, so the unnamed
// namespace gives each its own copy.
//
// What bounds it on an H100: the products are FP32 on the CUDA cores (the
// port's precision rule excludes TF32), so the ceiling is 67 TFLOP/s of FFMA.
// An SM issues at most one shared-memory load per four FFMAs it can retire;
// the FFMA pipes stay fed only if each shared load brings several operands
// and global loads overlap the arithmetic. A 64x64x16 tile with 4x4 per
// thread (8 scalar shared loads per 16 FFMAs, scalar global loads, one
// buffer), which the port used first, is bound by shared-memory issue and
// by the stalls between slices.
//
// Design:
//   - Block tile BM x BN, QM x QN quadrants of 4x4 accumulators per thread
//     (TileLarge: 128x128, 256 threads, 8x8 = 2x2 quadrants; TileSmall:
//     32x32, 64 threads, one 4x4 quadrant). A thread's quadrants lie BM/QM
//     rows and BN/QN columns apart, so every shared read is a float4 that
//     neighbouring threads take from neighbouring addresses (no bank
//     conflicts): per k, QM + QN float4 loads feed 16 QM QN FFMAs (4 per 64
//     for TileLarge).
//   - Both operands sit k-major in shared memory (As[k][m], Bs[k][n]), rows
//     padded by 4 floats, in a ring of STAGES slices of BK = 8.
//   - An operand whose contiguous dimension is m (A) or n (B) matches that
//     layout: 16-byte cp.async copies it straight into the ring, two slices
//     ahead of the one being computed. A k-contiguous operand must be
//     transposed on the way in, which cp.async cannot do: each thread loads
//     its float4 of the slice two ahead into registers before computing,
//     and stores it transposed after. The padding makes that store
//     conflict-free (the two k-quads of a warp land 16 banks apart).
//   - VEC = false takes any strides and any ragged edge (K = 2 in SIREN's
//     first layer, a leading dimension or base not 16-byte aligned): guarded
//     scalar loads through the same registers and the same ring.
//   - One __syncthreads per slice; the epilogue is the caller's functor, fed
//     four neighbouring columns of one row at a time.
//   - gemm_sm90_kernel (launched by sm90_gemm) is the large tile with a
//     linear layer's epilogue: a bias on the first rows, or one K split's
//     partial. Kernels 1 and 4 launch it; kernel 3 has a tile of its own.
// FMA only: no TF32, no tensor cores, no library call.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int SM90_BK = 8;      // k per slice
constexpr int SM90_STAGES = 3;  // slices in the shared-memory ring
constexpr int SM90_PAD = 4;     // floats of padding per shared row

template <int BM_, int BN_, int QM_, int QN_>
struct TileCfg {
    static constexpr int BM = BM_, BN = BN_, QM = QM_, QN = QN_;
    static constexpr int TY = BM / (4 * QM);  // threads along m
    static constexpr int TX = BN / (4 * QN);  // threads along n
    static constexpr int THREADS = TX * TY;
    static constexpr int LDA = BM + SM90_PAD;
    static constexpr int LDB = BN + SM90_PAD;
};

using TileLarge = TileCfg<128, 128, 2, 2>;
using TileSmall = TileCfg<32, 32, 1, 1>;

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, int src_bytes) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
                 "r"(src_bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One operand P of the product, rows r (m for A, n for B) and depth k:
// element (r, k) at P[r * sr + k * sk]; R rows. Its shared slice is
// S[k][r], k in [0, BK), r in [0, ROWS), row length LD.
// KFAST: k is the contiguous dimension (sk == 1 when VEC).
// VEC: the float4 paths (checked by the host: the contiguous stride is 1, the
// other a multiple of 4, the contiguous extent a multiple of 4, the base
// 16-byte aligned); otherwise guarded scalar loads with any strides.
template <int ROWS, int LD, int THREADS, bool KFAST, bool VEC>
struct Operand {
    static constexpr bool ASYNC = VEC && !KFAST;
    static constexpr int NV = ROWS * SM90_BK / 4 / THREADS;  // float4 per thread per slice
    static constexpr int NS = ROWS * SM90_BK / THREADS;      // scalars per thread per slice
    static_assert(NV >= 1 && NV * 4 * THREADS == ROWS * SM90_BK, "tile and threads do not divide");
    static constexpr int NREG = ASYNC ? 1 : (VEC ? 4 * NV : NS);

    const float* P;
    long long sr, sk;
    int R, r0;
    float reg[NREG];

    // cp.async part of slice k0 into S (ASYNC only).
    __device__ __forceinline__ void issue(float* S, int k0, int kend, int tid) {
        if constexpr (ASYNC) {
#pragma unroll
            for (int v = 0; v < NV; ++v) {
                const int c = tid + v * THREADS;
                const int kk = c / (ROWS / 4);
                const int rq = (c % (ROWS / 4)) * 4;
                const int gk = k0 + kk, gr = r0 + rq;
                const bool ok = gk < kend && gr < R;
                const float* src = ok ? P + (long long)gk * sk + gr : P;
                cp_async16(S + kk * LD + rq, src, ok ? 16 : 0);
            }
        }
    }

    // Global -> registers for slice k0 (register paths only).
    __device__ __forceinline__ void fetch(int k0, int kend, int tid) {
        if constexpr (!ASYNC && VEC) {
#pragma unroll
            for (int v = 0; v < NV; ++v) {
                const int c = tid + v * THREADS;
                const int r = c / (SM90_BK / 4);
                const int kq = (c % (SM90_BK / 4)) * 4;
                const int gr = r0 + r, gk = k0 + kq;
                float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
                if (gr < R && gk < kend)
                    x = __ldg(reinterpret_cast<const float4*>(P + (long long)gr * sr + gk));
                reg[4 * v] = x.x;
                reg[4 * v + 1] = x.y;
                reg[4 * v + 2] = x.z;
                reg[4 * v + 3] = x.w;
            }
        } else if constexpr (!VEC) {
#pragma unroll
            for (int e = 0; e < NS; ++e) {
                const int i = tid + e * THREADS;
                int r, kk;
                if (KFAST) { kk = i % SM90_BK; r = i / SM90_BK; } else { r = i % ROWS; kk = i / ROWS; }
                const int gr = r0 + r, gk = k0 + kk;
                reg[e] = (gr < R && gk < kend) ? P[(long long)gr * sr + (long long)gk * sk] : 0.f;
            }
        }
    }

    // Registers -> S (register paths only); the float4 path transposes.
    __device__ __forceinline__ void store(float* S, int tid) const {
        if constexpr (!ASYNC && VEC) {
#pragma unroll
            for (int v = 0; v < NV; ++v) {
                const int c = tid + v * THREADS;
                const int r = c / (SM90_BK / 4);
                const int kq = (c % (SM90_BK / 4)) * 4;
#pragma unroll
                for (int j = 0; j < 4; ++j) S[(kq + j) * LD + r] = reg[4 * v + j];
            }
        } else if constexpr (!VEC) {
#pragma unroll
            for (int e = 0; e < NS; ++e) {
                const int i = tid + e * THREADS;
                int r, kk;
                if (KFAST) { kk = i % SM90_BK; r = i / SM90_BK; } else { r = i % ROWS; kk = i / ROWS; }
                S[kk * LD + r] = reg[e];
            }
        }
    }

    __device__ __forceinline__ void load_now(float* S, int k0, int kend, int tid) {
        issue(S, k0, kend, tid);
        fetch(k0, kend, tid);
        store(S, tid);
    }
};

// acc += the (BM x BN) tile at rows m0.., columns n0.. of
// sum_{k in [kbeg, kend)} A[m*sam + k*sak] * B[k*sbk + n*sbn]. Thread tid
// (tx = tid % TX, ty = tid / TX) holds acc[4 qm + i][4 qn + j] for row
// m0 + qm BM/QM + 4 ty + i and column n0 + qn BN/QN + 4 tx + j. Out-of-range
// rows, columns and k read 0. B_KFAST: B's contiguous dimension is k.
template <class Cfg, bool A_KFAST, bool B_KFAST, bool VEC>
__device__ __forceinline__ void gemm_sm90_tile(int M, int N, const float* __restrict__ A,
                                               long long sam, long long sak,
                                               const float* __restrict__ B, long long sbk,
                                               long long sbn, int m0, int n0, int kbeg, int kend,
                                               float (&acc)[4 * Cfg::QM][4 * Cfg::QN]) {
    constexpr int BK = SM90_BK, S = SM90_STAGES;
    constexpr int QM = Cfg::QM, QN = Cfg::QN, LDA = Cfg::LDA, LDB = Cfg::LDB;
    __shared__ __align__(16) float As[S][BK * LDA];
    __shared__ __align__(16) float Bs[S][BK * LDB];
    const int tid = threadIdx.x;
    const int tx = tid % Cfg::TX, ty = tid / Cfg::TX;

    Operand<Cfg::BM, LDA, Cfg::THREADS, A_KFAST, VEC> a{A, sam, sak, M, m0};
    Operand<Cfg::BN, LDB, Cfg::THREADS, B_KFAST, VEC> b{B, sbn, sbk, N, n0};

    const int nk = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;
#pragma unroll
    for (int s = 0; s < S - 1; ++s) {
        if (s < nk) {
            a.load_now(As[s], kbeg + s * BK, kend, tid);
            b.load_now(Bs[s], kbeg + s * BK, kend, tid);
        }
        cp_async_commit();
    }
    int rd = 0, wr = S - 1;
    for (int kt = 0; kt < nk; ++kt) {
        cp_async_wait<S - 2>();  // slice kt's copies have landed
        __syncthreads();         // ... for every thread; slice kt-1 is free
        const bool pre = kt + S - 1 < nk;
        const int k_pre = kbeg + (kt + S - 1) * BK;
        if (pre) {
            a.issue(As[wr], k_pre, kend, tid);
            b.issue(Bs[wr], k_pre, kend, tid);
            a.fetch(k_pre, kend, tid);
            b.fetch(k_pre, kend, tid);
        }
        cp_async_commit();
        const float* as = As[rd];
        const float* bs = Bs[rd];
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            float av[4 * QM], bv[4 * QN];
#pragma unroll
            for (int q = 0; q < QM; ++q) {
                const float4 v =
                    *reinterpret_cast<const float4*>(as + kk * LDA + q * (Cfg::BM / QM) + 4 * ty);
                av[4 * q] = v.x; av[4 * q + 1] = v.y; av[4 * q + 2] = v.z; av[4 * q + 3] = v.w;
            }
#pragma unroll
            for (int q = 0; q < QN; ++q) {
                const float4 v =
                    *reinterpret_cast<const float4*>(bs + kk * LDB + q * (Cfg::BN / QN) + 4 * tx);
                bv[4 * q] = v.x; bv[4 * q + 1] = v.y; bv[4 * q + 2] = v.z; bv[4 * q + 3] = v.w;
            }
#pragma unroll
            for (int i = 0; i < 4 * QM; ++i)
#pragma unroll
                for (int j = 0; j < 4 * QN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        if (pre) {  // slice kt-1's buffer: every thread left it before the barrier above
            a.store(As[wr], tid);
            b.store(Bs[wr], tid);
        }
        rd = rd == S - 1 ? 0 : rd + 1;
        wr = wr == S - 1 ? 0 : wr + 1;
    }
    cp_async_wait<0>();
}

// Hands the epilogue each run of four neighbouring columns of one row:
// epi(gm, gn, v) with v[j] the sum at (gm, gn + j); columns gn + j >= N are
// the epilogue's to skip.
template <class Cfg, class Epi>
__device__ __forceinline__ void gemm_sm90_store(const float (&acc)[4 * Cfg::QM][4 * Cfg::QN],
                                                int M, int N, int m0, int n0, const Epi& epi) {
    const int tx = threadIdx.x % Cfg::TX, ty = threadIdx.x / Cfg::TX;
#pragma unroll
    for (int qm = 0; qm < Cfg::QM; ++qm)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int gm = m0 + qm * (Cfg::BM / Cfg::QM) + 4 * ty + i;
            if (gm >= M) continue;
#pragma unroll
            for (int qn = 0; qn < Cfg::QN; ++qn) {
                const int gn = n0 + qn * (Cfg::BN / Cfg::QN) + 4 * tx;
                if (gn >= N) continue;
                float v[4];
#pragma unroll
                for (int j = 0; j < 4; ++j) v[j] = acc[4 * qm + i][4 * qn + j];
                epi(gm, gn, v);
            }
        }
}

// ------------------------------------------------- the linear-layer GEMM --
// C[m, n] = sum_{k in split} A[m*sam + k*sak] * B[k*sbk + n*sbn] (+ bias[n]
// for m < bias_rows) on the large tile: kernel 1's products and kernel 4's
// hidden product. blockIdx.z is the K split; split z writes to
// C + z * split_stride. vec_store: C, ldc and split_stride allow float4 stores.
// ROW_BIAS = false drops the row test (the bias, if any, goes on every row):
// kernel 4's product compiled with the row test ran 4% slower alone and its
// whole call 15% slower on an H100, at the same registers (PERF.md §6).

template <bool ROW_BIAS>
struct LinearEpi {
    float* C;
    long long ldc;
    const float* bias;
    int bias_rows, N;
    bool vec;
    __device__ __forceinline__ void operator()(int gm, int gn, const float* v) const {
        float o[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            o[j] = v[j];
            if (bias != nullptr && (!ROW_BIAS || gm < bias_rows) && gn + j < N)
                o[j] += bias[gn + j];
        }
        float* c = C + (long long)gm * ldc + gn;
        if (vec && gn + 3 < N) {
            *reinterpret_cast<float4*>(c) = make_float4(o[0], o[1], o[2], o[3]);
        } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
                if (gn + j < N) c[j] = o[j];
        }
    }
};

template <bool A_KFAST, bool B_KFAST, bool VEC, bool ROW_BIAS>
__global__ void __launch_bounds__(TileLarge::THREADS, 2)
gemm_sm90_kernel(int M, int N, int K, const float* __restrict__ A, long long sam, long long sak,
                 const float* __restrict__ B, long long sbk, long long sbn, float* __restrict__ C,
                 long long ldc, const float* __restrict__ bias, int bias_rows, int k_chunk,
                 long long split_stride, int vec_store) {
    const int m0 = blockIdx.y * TileLarge::BM, n0 = blockIdx.x * TileLarge::BN;
    const int kbeg = blockIdx.z * k_chunk;
    const int kend = min(K, kbeg + k_chunk);
    float acc[4 * TileLarge::QM][4 * TileLarge::QN];
#pragma unroll
    for (int i = 0; i < 4 * TileLarge::QM; ++i)
#pragma unroll
        for (int j = 0; j < 4 * TileLarge::QN; ++j) acc[i][j] = 0.0f;
    gemm_sm90_tile<TileLarge, A_KFAST, B_KFAST, VEC>(M, N, A, sam, sak, B, sbk, sbn, m0, n0, kbeg,
                                                     kend, acc);
    const LinearEpi<ROW_BIAS> epi{C + (long long)blockIdx.z * split_stride, ldc, bias, bias_rows,
                                  N, vec_store != 0};
    gemm_sm90_store<TileLarge>(acc, M, N, m0, n0, epi);
}

// The same products for `members` stacked members in one launch (kernel 1
// batched over a deep ensemble's members, as the reference's vmapped
// pallas_call adds a member axis to its grid): blockIdx.z = member * splits
// + split, and member e's product is the single product of A + e sae, B + e
// sbe, C + e sce and bias + e s_bias (a stride of 0: an operand the members
// share), cut into the same K splits, so the member axis changes which
// block does the work and not the order of any sum. A member's A and B are
// reached by shifting the operands' rows (a_rows = sae / sam rows of A,
// b_rows = sbe / sbn of B per member), C and bias only after the main loop.
// A kernel of its own: the single product's dX instantiation sits at the
// 128-register cap of two blocks per SM, and the member's state spilled
// it. Here the float4 paths keep two blocks per SM without spilling; the
// guarded scalar paths, the fallback for odd shapes, take one.
template <bool A_KFAST, bool B_KFAST, bool VEC, bool ROW_BIAS>
__global__ void __launch_bounds__(TileLarge::THREADS, VEC ? 2 : 1)
gemm_sm90_kernel_members(int M, int N, int K, const float* __restrict__ A, long long sam,
                         long long sak, const float* __restrict__ B, long long sbk, long long sbn,
                         float* __restrict__ C, long long ldc, const float* __restrict__ bias,
                         int bias_rows, int k_chunk, long long split_stride, int vec_store,
                         int splits, int a_rows, int b_rows, long long sce, long long s_bias) {
    const int m0 = blockIdx.y * TileLarge::BM, n0 = blockIdx.x * TileLarge::BN;
    int member = (int)blockIdx.z / splits;
    const int kbeg = ((int)blockIdx.z - member * splits) * k_chunk;
    const int kend = min(K, kbeg + k_chunk);
    const int ma = member * a_rows, nb = member * b_rows;
    float acc[4 * TileLarge::QM][4 * TileLarge::QN];
#pragma unroll
    for (int i = 0; i < 4 * TileLarge::QM; ++i)
#pragma unroll
        for (int j = 0; j < 4 * TileLarge::QN; ++j) acc[i][j] = 0.0f;
    gemm_sm90_tile<TileLarge, A_KFAST, B_KFAST, VEC>(M + ma, N + nb, A, sam, sak, B, sbk, sbn,
                                                     m0 + ma, n0 + nb, kbeg, kend, acc);
    // The output's member and split, formed again from blockIdx.z read anew.
    unsigned z;
    asm volatile("mov.u32 %0, %%ctaid.z;" : "=r"(z));
    member = (int)z / splits;
    const LinearEpi<ROW_BIAS> epi{
        C + member * sce + (long long)((int)z - member * splits) * split_stride, ldc,
        bias == nullptr ? bias : bias + member * s_bias, bias_rows, N, vec_store != 0};
    gemm_sm90_store<TileLarge>(acc, M, N, m0, n0, epi);
}

// Host side: may the float4 paths take this operand? The contiguous stride
// is 1, the other stride and the contiguous extent are multiples of 4, and
// the base is 16-byte aligned.
inline bool sm90_vec_ok(const float* p, long long s_contig, long long s_other, long long extent) {
    return s_contig == 1 && s_other % 4 == 0 && extent % 4 == 0 &&
           (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Host side: the grid gemm_sm90_kernel runs for `members` (M, N) products
// split in `splits` over K.
inline dim3 sm90_grid(int M, int N, int splits, int members = 1) {
    return dim3((unsigned)((N + TileLarge::BN - 1) / TileLarge::BN),
                (unsigned)((M + TileLarge::BM - 1) / TileLarge::BM),
                (unsigned)splits * (unsigned)members);
}

// Host side: calls launch(A_KFAST, B_KFAST, VEC) for the layouts. A and B
// k-contiguous (X W^T), A k-contiguous and B n-contiguous (G W), A
// m-contiguous and B n-contiguous (G^T X); any other strides take the last
// one's guarded scalar path. The float4 / cp.async paths run where both
// operands allow them and k_chunk keeps splits on float4 boundaries
// (`vec_extra`: what the caller adds to that), the guarded scalar path
// otherwise.
template <class Launch>
inline void sm90_dispatch(const Launch& launch, int M, int N, int K, const float* A,
                          long long sam, long long sak, const float* B, long long sbk,
                          long long sbn, int k_chunk, bool vec_extra) {
    using T = std::true_type;
    using F = std::false_type;
    const bool a_kfast = sak == 1;
    const bool b_kfast = sbn != 1 && sbk == 1;
    const bool vec = vec_extra && k_chunk % 4 == 0 &&
                     (a_kfast ? sm90_vec_ok(A, sak, sam, K) : sm90_vec_ok(A, sam, sak, M)) &&
                     (b_kfast ? sm90_vec_ok(B, sbk, sbn, K) : sm90_vec_ok(B, sbn, sbk, N));
    if (a_kfast && b_kfast) {
        if (vec) launch(T{}, T{}, T{}); else launch(T{}, T{}, F{});
    } else if (a_kfast) {
        if (vec) launch(T{}, F{}, T{}); else launch(T{}, F{}, F{});
    } else {
        if (vec && !b_kfast) launch(F{}, F{}, T{}); else launch(F{}, F{}, F{});
    }
}

// Host side: launches gemm_sm90_kernel on `stream` (the layouts pick the
// instantiation, ``sm90_dispatch``). Each library that calls it
// instantiates six kernels, for its own ROW_BIAS.
template <bool ROW_BIAS>
inline void sm90_gemm(int M, int N, int K, const float* A, long long sam, long long sak,
                      const float* B, long long sbk, long long sbn, float* C, long long ldc,
                      const float* bias, int bias_rows, int splits, int k_chunk,
                      long long split_stride, cudaStream_t stream) {
    if (M <= 0 || N <= 0) return;
    const int vec_store =
        (reinterpret_cast<uintptr_t>(C) & 15) == 0 && ldc % 4 == 0 && split_stride % 4 == 0;
    const dim3 grid = sm90_grid(M, N, splits);
    const auto launch = [&](auto a, auto b, auto v) {
        gemm_sm90_kernel<decltype(a)::value, decltype(b)::value, decltype(v)::value, ROW_BIAS>
            <<<grid, TileLarge::THREADS, 0, stream>>>(M, N, K, A, sam, sak, B, sbk, sbn, C, ldc,
                                                      bias, bias_rows, k_chunk, split_stride,
                                                      vec_store);
    };
    sm90_dispatch(launch, M, N, K, A, sam, sak, B, sbk, sbn, k_chunk, true);
}

// Host side: may gemm_sm90_kernel_members take `members` products at member
// strides sae and sbe? Each must be a whole number of its operand's rows
// (sam, sbn), and the last member's shifted rows must fit an int.
inline bool sm90_gemm_members_ok(int M, int N, long long sam, long long sbn, long long sae,
                                 long long sbe, int members) {
    if (sam <= 0 || sbn <= 0 || sae < 0 || sbe < 0 || sae % sam || sbe % sbn) return false;
    const long long last = members - 1;
    return M + last * (sae / sam) < (1LL << 31) && N + last * (sbe / sbn) < (1LL << 31);
}

// Host side: `members` products at member strides sae, sbe, sce and s_bias
// in one launch of gemm_sm90_kernel_members (checked first by
// sm90_gemm_members_ok); the float4 paths then also need every member's
// operands and output on 16-byte boundaries.
template <bool ROW_BIAS>
inline void sm90_gemm_members(int M, int N, int K, const float* A, long long sam, long long sak,
                              const float* B, long long sbk, long long sbn, float* C,
                              long long ldc, const float* bias, int bias_rows, int splits,
                              int k_chunk, long long split_stride, int members, long long sae,
                              long long sbe, long long sce, long long s_bias,
                              cudaStream_t stream) {
    if (M <= 0 || N <= 0) return;
    const int vec_store = (reinterpret_cast<uintptr_t>(C) & 15) == 0 && ldc % 4 == 0 &&
                          split_stride % 4 == 0 && sce % 4 == 0;
    const dim3 grid = sm90_grid(M, N, splits, members);
    const int a_rows = (int)(sae / sam), b_rows = (int)(sbe / sbn);
    const auto launch = [&](auto a, auto b, auto v) {
        gemm_sm90_kernel_members<decltype(a)::value, decltype(b)::value, decltype(v)::value,
                                 ROW_BIAS><<<grid, TileLarge::THREADS, 0, stream>>>(
            M, N, K, A, sam, sak, B, sbk, sbn, C, ldc, bias, bias_rows, k_chunk, split_stride,
            vec_store, splits, a_rows, b_rows, sce, s_bias);
    };
    sm90_dispatch(launch, M, N, K, A, sam, sak, B, sbk, sbn, k_chunk,
                  sae % 4 == 0 && sbe % 4 == 0);
}

}  // namespace

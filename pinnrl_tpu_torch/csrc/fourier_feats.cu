// Fourier-feature embedding: out = [sin(s * x @ B), cos(s * x @ B)], s = 2 pi or 1.
//
// Replaces the Pallas kernel pinnrl_tpu/ops/kernels/fourier_feats.py:36
// (_ff_kernel / _pallas_ff, behind fourier_features).
//
// What bounds it on an H100: bytes. Per output pair it writes 8 bytes and
// does d FMAs and one sincosf; at (4096, 2) x (2, 128) the 4.2 MB written
// take 1.26 us at 3.35 TB/s. The first design (one thread per (row,
// feature) pair, 64-bit division for the pair's indices, scalar loads of x
// and B and two scalar stores per pair) was bound by instruction issue
// instead: ~150-200 instructions per pair, 4.1 us. This one takes 2.8 us
// there on an H100 (700 W), against 1.2 us for an empty kernel on the same
// grid and 2.5 us for the same kernel with its trig left out: what is left
// above the bytes is the launch (tools/ab_fourier_feats.py).
//
// Design (ops/kernels/fourier_feats.py: launch_plan picks path and grid):
//   - 2-D mapping: threadIdx.x runs over feature quads (4 consecutive
//     features j..j+3), threadIdx.y over rows, and each block strides over
//     rows with step gridDim.y * ROWS. 32-bit row and column arithmetic,
//     pointers advanced by a fixed stride: no division anywhere.
//   - Vector path (template D = d in 1..3, m % 4 == 0, B 16-byte aligned):
//     a thread loads its 4 d entries of B once, as d float4, and keeps them
//     in registers for every row it visits; it reads its row of x once (all
//     32 lanes of a warp read the same d floats: one broadcast load) and
//     writes the sin and cos halves as one float4 each, so a warp writes 512
//     contiguous bytes per half. x needs no alignment (scalar loads).
//   - Edge path (D = 0): any d, m or alignment; one feature per thread, B and
//     x read through the read-only cache, scalar stores. The same kernel on
//     ragged shapes, not a fallback.
//   - Grid: gridDim.y is a small multiple of the SM count (the host sizes
//     it), so each block reuses its B registers over several rows.
//   - Members: blockIdx.z is a deep ensemble's member, with its own x (or a
//     shared one, stride 0), its own B and its own output; each member's
//     blocks do what a single call's do (the reference's vmap of this
//     kernel under a trainable basis, one pallas_call with a member axis).
// Precision: the phase is formed as the plain version forms it, the product
// x @ B by fmaf over k from 0, then times s, then full-range sincosf. Never
// __sinf/__cosf and never --use_fast_math: with s = 2 pi and scale 2 the
// phases reach ~100 rad, where the fast intrinsics lose digits.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int QUADS = 32;  // threadIdx.x: feature quads (vector path) or features (edge path)
constexpr int ROWS = 8;    // threadIdx.y: rows per block and step
constexpr int MAX_VEC_D = 3;
constexpr float TWO_PI = 6.283185307179586f;

template <int D>
__global__ void __launch_bounds__(QUADS * ROWS)
fourier_features_kernel(const float* __restrict__ x, const float* __restrict__ B,
                        float* __restrict__ out, int n, int d, int m, float s, long long sx,
                        long long sB) {
    x += blockIdx.z * sx;
    B += blockIdx.z * sB;
    out += blockIdx.z * (2LL * m) * n;
    const int col = blockIdx.x * QUADS + threadIdx.x;
    const int row0 = blockIdx.y * ROWS + threadIdx.y;
    const int row_step = gridDim.y * ROWS;
    const long long out_step = (long long)row_step * (2 * m);
    if constexpr (D > 0) {
        if (col >= (m >> 2)) return;
        float4 b[D];
#pragma unroll
        for (int k = 0; k < D; ++k) b[k] = __ldg(reinterpret_cast<const float4*>(B + (long long)k * m) + col);
        const float* xr = x + (long long)row0 * D;
        float* o = out + (long long)row0 * (2 * m) + 4 * col;
        for (int row = row0; row < n; row += row_step, xr += (long long)row_step * D, o += out_step) {
            float xv[D];
#pragma unroll
            for (int k = 0; k < D; ++k) xv[k] = __ldg(xr + k);
            float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f, p3 = 0.0f;
#pragma unroll
            for (int k = 0; k < D; ++k) {
                p0 = fmaf(xv[k], b[k].x, p0);
                p1 = fmaf(xv[k], b[k].y, p1);
                p2 = fmaf(xv[k], b[k].z, p2);
                p3 = fmaf(xv[k], b[k].w, p3);
            }
            float4 sn, cs;
            sincosf(s * p0, &sn.x, &cs.x);
            sincosf(s * p1, &sn.y, &cs.y);
            sincosf(s * p2, &sn.z, &cs.z);
            sincosf(s * p3, &sn.w, &cs.w);
            *reinterpret_cast<float4*>(o) = sn;
            *reinterpret_cast<float4*>(o + m) = cs;
        }
    } else {
        if (col >= m) return;
        float* o = out + (long long)row0 * (2 * m) + col;
        for (int row = row0; row < n; row += row_step, o += out_step) {
            const float* xr = x + (long long)row * d;
            float p = 0.0f;
            for (int k = 0; k < d; ++k) p = fmaf(__ldg(xr + k), __ldg(B + (long long)k * m + col), p);
            float sn, cs;
            sincosf(s * p, &sn, &cs);
            o[0] = sn;
            o[m] = cs;
        }
    }
}

__global__ void empty_kernel() {}

// Blocks across the features: quads on the vector path, features on the edge path.
int grid_cols(int m, int path) { return ((path > 0 ? m / 4 : m) + QUADS - 1) / QUADS; }

}  // namespace

// path: d (1..3) for the vector path, 0 for the edge path; grid_rows: blocks
// along the rows (the host's launch_plan). A path the inputs do not admit is
// refused (cudaErrorInvalidValue), never run on the wrong layout. members:
// x, B and out hold that many members at strides sx, sB (0: shared) and
// n 2m; every member has the single call's grid.
extern "C" int ff_forward(const float* x, const float* B, float* out, int n, int d, int m,
                          int path, int grid_rows, int two_pi, int members, long long sx,
                          long long sB, void* stream) {
    if (n < 0 || d < 0 || m < 0 || grid_rows < 1 || grid_rows > 65535 || members < 1 ||
        members > 65535)
        return (int)cudaErrorInvalidValue;
    if (path != 0 && (path != d || d > MAX_VEC_D || m % 4 != 0 || (reinterpret_cast<uintptr_t>(B) & 15)
                      || (reinterpret_cast<uintptr_t>(out) & 15) || sB % 4 != 0))
        return (int)cudaErrorInvalidValue;
    if (n == 0 || m == 0) return 0;
    const float s = two_pi ? TWO_PI : 1.0f;
    const dim3 grid(grid_cols(m, path), grid_rows, members), block(QUADS, ROWS);
    cudaStream_t st = (cudaStream_t)stream;
    switch (path) {
        case 1: fourier_features_kernel<1><<<grid, block, 0, st>>>(x, B, out, n, d, m, s, sx, sB); break;
        case 2: fourier_features_kernel<2><<<grid, block, 0, st>>>(x, B, out, n, d, m, s, sx, sB); break;
        case 3: fourier_features_kernel<3><<<grid, block, 0, st>>>(x, B, out, n, d, m, s, sx, sB); break;
        default: fourier_features_kernel<0><<<grid, block, 0, st>>>(x, B, out, n, d, m, s, sx, sB); break;
    }
    return (int)cudaGetLastError();
}

// The launch floor: an empty kernel on the grid ff_forward would launch for
// (m, path, grid_rows). A yardstick for timing only; nothing calls it on the
// training path.
extern "C" int ff_empty(int m, int path, int grid_rows, void* stream) {
    if (m < 1 || grid_rows < 1 || grid_rows > 65535) return (int)cudaErrorInvalidValue;
    empty_kernel<<<dim3(grid_cols(m, path), grid_rows), dim3(QUADS, ROWS), 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}

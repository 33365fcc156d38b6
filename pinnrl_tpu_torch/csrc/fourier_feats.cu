// Fourier-feature embedding: out = [sin(s * x @ B), cos(s * x @ B)].
//
// Replaces the Pallas kernel pinnrl_tpu/ops/kernels/fourier_feats.py
// (_ff_kernel / _pallas_ff, behind fourier_features).
//
// What bounds it on an H100: memory. Per output pair it reads d (1-3) inputs
// and d basis entries (both cached) and writes 8 bytes, for 2d FMAs and one
// sincosf; at (N, 2) x (2, 128) it moves ~8 N*128 bytes and is far below the
// FLOP roofline. Design: one thread per (row, feature) pair, so neighbouring
// threads write neighbouring addresses of both halves of the output row
// (coalesced stores); the d-term contraction is a register FMA chain.
// Precision: full-range sincosf, never __sinf/__cosf and never
// --use_fast_math — with s = 2*pi and scale 2 the phases reach tens of
// radians, where the fast intrinsics lose digits.

#include <cuda_runtime.h>

namespace {

__global__ void fourier_features_kernel(const float* __restrict__ x,
                                        const float* __restrict__ B,
                                        float* __restrict__ out,
                                        int n, int d, int m, float s) {
    const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= (long long)n * m) return;
    const int row = (int)(idx / m);
    const int j = (int)(idx % m);
    float p = 0.0f;
    for (int k = 0; k < d; ++k) p = fmaf(x[(long long)row * d + k], B[(long long)k * m + j], p);
    p = s * p;
    float sn, cs;
    sincosf(p, &sn, &cs);
    float* o = out + (long long)row * 2 * m;
    o[j] = sn;
    o[m + j] = cs;
}

}  // namespace

extern "C" int fourier_features_launch(const float* x, const float* B, float* out,
                                       int n, int d, int m, int two_pi, void* stream) {
    const float s = two_pi ? 6.283185307179586f : 1.0f;
    const long long total = (long long)n * m;
    if (total == 0) return 0;
    const int threads = 256;
    const unsigned blocks = (unsigned)((total + threads - 1) / threads);
    fourier_features_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(x, B, out, n, d, m, s);
    return (int)cudaGetLastError();
}

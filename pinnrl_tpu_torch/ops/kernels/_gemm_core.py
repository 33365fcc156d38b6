"""Host side of the FP32 GEMM core ``csrc/sgemm_sm90.cuh``, shared by the
launchers of kernel 1 (``fused_step``) and kernel 4 (``mlp``): the large
tile's geometry, the blocks the H100 holds at once, K cut into split
chunks, the ctypes argument list of the linear-layer GEMM's C entry points
(``fr_gemm``, ``ms_gemm``) and the plain twin of those entry points."""

from __future__ import annotations

import ctypes
from typing import Tuple

TILE = 128  # the large tile's output rows and columns (TileLarge)
BK = 8  # its k per shared-memory slice (SM90_BK)
# One wave on the H100: two 128x128 blocks (__launch_bounds__(256, 2)) on
# each of its 132 SMs.
TARGET_BLOCKS = 264

# (M, N, K, A, sam, sak, B, sbk, sbn, C, ldc, bias, bias_rows, splits,
#  k_chunk, split_stride, stream)
GEMM_ARGTYPES = ([ctypes.c_int] * 3
                 + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong] * 2
                 + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
                 + [ctypes.c_int] * 3 + [ctypes.c_longlong, ctypes.c_void_p])
# The same with a member axis before the stream: (..., split_stride, members,
# sae, sbe, sce, s_bias, stream) (kernel 1's ``fr_gemm``).
MEMBER_GEMM_ARGTYPES = GEMM_ARGTYPES[:-1] + [ctypes.c_int] + [ctypes.c_longlong] * 4 + [ctypes.c_void_p]


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_chunks(K: int, splits: int) -> Tuple[int, int]:
    """(splits, k_chunk): K in about ``splits`` chunks of whole BK slices."""
    k_chunk = cdiv(cdiv(K, splits), BK) * BK
    return cdiv(K, k_chunk), k_chunk


def gemm_plain(M, N, K, A, sam, sak, B, sbk, sbn, C, ldc, bias, bias_rows, splits, k_chunk,
               members=1, sae=0, sbe=0, sce=0, s_bias=0):
    """The C entry point's contract: split s of K writes
    A[:, chunk s] @ B[chunk s] (+ bias on the first ``bias_rows`` rows) to
    C + s M N, rows ``ldc`` apart; member e's product is that of A + e sae,
    B + e sbe, C + e sce and bias + e s_bias (a stride of 0: an operand the
    members share)."""
    for e in range(members):
        Av = A.as_strided((M, K), (sam, sak), A.storage_offset() + e * sae)
        Bv = B.as_strided((K, N), (sbk, sbn), B.storage_offset() + e * sbe)
        be = None if bias is None else bias.as_strided((N,), (1,), bias.storage_offset() + e * s_bias)
        for s in range(splits):
            k0, k1 = s * k_chunk, min(K, (s + 1) * k_chunk)
            out = Av[:, k0:k1] @ Bv[k0:k1]
            if be is not None:
                out[:bias_rows] += be
            C.as_strided((M, N), (ldc, 1), C.storage_offset() + e * sce + s * M * N).copy_(out)

#!/usr/bin/env python3
"""Kernel 2 (the Fourier-feature embedding) against an earlier version of
itself, and the A/Bs of its design, on one CUDA card.

    python3 tools/ab_fourier_feats.py --old DIR [--out chiprun_out/ab_fourier_feats.json]

DIR holds an earlier checkout of the repository (for example a
``git archive`` of the parent commit unpacked under the gitignored
``build/``) whose ``fourier_feats.cu`` exports
``fourier_features_launch(x, B, out, n, d, m, two_pi, stream)``. Its source
is built with this checkout's nvcc flags, and its launch path (that
checkout's ``fourier_features``, copied into ``old_fourier_features`` below)
runs on it. At the main path's shapes it prints, old and new in turns (old,
new, new, old):

  * device ms per call by CUDA-graph replay, the plain version's, the bound,
    and an empty kernel on the new call's grid (the launch floor);
  * whether the two give the same bits;
  * the new kernel's design A/Bs, each by graph replay in turns: the edge
    path and the vector path with one row per thread (grid rows n / 8:
    the old kernel's flat mapping without its 64-bit division), the vector
    path with grid rows k x SMs for k in 1, 2, 4, 8, 16, and the source
    variants of ``VARIANTS`` (sincospif, other block shapes, streaming
    stores), each with its error against the plain version, beside the
    kernel with its trig left out (launch plus data movement);
  * eager calls: ms per call by CUDA events, host us per call by
    perf_counter over 1000 calls, and each call's host cost split by piece.

The numbers also go to ``--out`` as JSON. Imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (the timing harness: graph_ms, cuda_ms, host_us, ff_host_split)

SHAPES = {"(4096,2)x(2,128)": (4096, 2, 128, 2.0), "(4096,2)x(2,256)": (4096, 2, 256, 0.75),
          "(20000,2)x(2,128)": (20000, 2, 128, 2.0)}  # n, d, m, scale of B
MULTIPLES = (1, 2, 4, 8, 16)


def build(text: str, name: str) -> ctypes.CDLL:
    """Build CUDA source ``text`` with this checkout's nvcc flags into
    ``build/ab_fourier_feats/lib<name>.so`` and load it."""
    from pinnrl_tpu_torch.ops.kernels import _build

    out_dir = REPO / "build" / "ab_fourier_feats"
    out_dir.mkdir(parents=True, exist_ok=True)
    source, target = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
    source.write_text(text)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(target), str(source)], check=True,
                   capture_output=True)
    return ctypes.CDLL(str(target))


# Variants of this checkout's kernel, each built from its source with the
# edits listed (pattern, replacement, expected count), for the design A/Bs:
# (block rows, edits). "sincospif" is right for s = 2 pi only (two_pi = 1):
# sincospif(2 p) never rounds the phase 2 pi p to f32.
VARIANTS = {
    "sincospif(2p)": (8, [(r"sincosf\(s \* (p\d?),", r"sincospif(2.0f * \1,", 5)]),
    "block 32x4": (4, [(r"constexpr int ROWS = 8;", "constexpr int ROWS = 4;", 1)]),
    "block 32x16": (16, [(r"constexpr int ROWS = 8;", "constexpr int ROWS = 16;", 1)]),
    "streaming stores": (8, [(r"\*reinterpret_cast<float4\*>\((o(?: \+ m)?)\) = (sn|cs);",
                              r"__stcs(reinterpret_cast<float4*>(\1), \2);", 2)]),
    # A yardstick, not a kernel: the same loads, FMAs and stores with the
    # trig left out (it writes s p and p), so launch plus data movement.
    "no trig": (8, [(r"sincosf\(s \* (p\d?), &sn(\.\w)?, &cs(\.\w)?\);", r"sn\2 = s * \1; cs\3 = \1;", 5)]),
}


def build_variant(name: str) -> ctypes.CDLL:
    from pinnrl_tpu_torch.ops.kernels import fourier_feats

    text = (REPO / "pinnrl_tpu_torch" / "csrc" / "fourier_feats.cu").read_text()
    for pattern, repl, want in VARIANTS[name][1]:
        text, count = re.subn(pattern, repl, text)
        assert count == want, (name, pattern, count)
    lib = build(text, "fourier_feats_" + re.sub(r"\W+", "_", name))
    lib.ff_forward.argtypes = fourier_feats._ARGTYPES["ff_forward"]
    lib.ff_forward.restype = ctypes.c_int
    return lib


def old_path(lib: ctypes.CDLL):
    """The earlier checkout's launch path, as it was, on its own kernel."""
    import torch

    from pinnrl_tpu_torch.ops.kernels import _build, fourier_feats

    loaded = {"fourier_feats": lib}

    def _lib():
        lib_ = loaded["fourier_feats"]
        fn = lib_.fourier_features_launch
        if fn.restype is not ctypes.c_int or fn.argtypes is None:
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        return lib_

    def checks(x, B):
        if x.ndim != 2 or B.ndim != 2 or x.shape[1] != B.shape[0]:
            raise ValueError("shapes do not chain")
        _build.require_cuda_f32("fourier_features x", x)
        _build.require_cuda_f32("fourier_features B", B)
        if x.device != B.device:
            raise ValueError("devices differ")

    def old_cuda(x, B, two_pi=True):
        checks(x, B)
        n, d = x.shape
        m = B.shape[1]
        out = torch.empty((n, 2 * m), dtype=torch.float32, device=x.device)
        status = _lib().fourier_features_launch(
            x.data_ptr(), B.data_ptr(), out.data_ptr(), n, d, m, int(bool(two_pi)),
            torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(status, "fourier_features_kernel")
        return out

    def old_fourier_features(x, B, two_pi=True):
        if x.device.type == "cpu" and B.device.type == "cpu":
            return fourier_feats.fourier_features_plain(x, B, two_pi)
        if x.device.type == "cuda":
            return fourier_feats._FourierFeaturesFn.apply(x, B, bool(two_pi), old_cuda)
        raise ValueError("unsupported devices")

    def host_split(x, B, calls=1000):
        n, d = x.shape
        m = B.shape[1]
        out = torch.empty((n, 2 * m), device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        fn = _lib().fourier_features_launch
        pieces = {
            "dispatch": lambda: (x.device.type == "cpu" and B.device.type == "cpu") or x.device.type == "cuda",
            "function": lambda: fourier_feats._FourierFeaturesFn.apply(x, B, True, lambda *a: out),
            "check": lambda: checks(x, B),
            "library": _lib,
            "stream": lambda: torch.cuda.current_stream(x.device).cuda_stream,
            "alloc": lambda: torch.empty((n, 2 * m), dtype=torch.float32, device=x.device),
            "launch": lambda: _build.check(fn(x.data_ptr(), B.data_ptr(), out.data_ptr(), n, d, m, 1,
                                              stream), "fourier_features_kernel"),
        }
        split = {"call": chip_smoke.host_us(lambda: old_fourier_features(x, B, True), calls)}
        split.update({k: chip_smoke.host_us(f, calls) for k, f in pieces.items()})
        split["rest"] = split["call"] - sum(split[k] for k in pieces)
        return split

    return old_fourier_features, host_split


def in_turns(fns: dict, timer) -> dict:
    """Each callable timed twice, in order then in reverse; the mean."""
    out = {k: 0.0 for k in fns}
    for k in list(fns) + list(reversed(fns)):
        out[k] += timer(fns[k]) / 2.0
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=Path, required=True, help="earlier checkout of the repository")
    ap.add_argument("--out", type=Path, default=REPO / "chiprun_out" / "ab_fourier_feats.json")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("ab_fourier_feats: no CUDA card", file=sys.stderr)
        return 2
    from pinnrl_tpu_torch.ops.kernels import _build, fourier_feats as ff

    card = chip_smoke.nvidia_smi_line()
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    old_source = args.old / "pinnrl_tpu_torch" / "csrc" / "fourier_feats.cu"
    old_ff, old_split = old_path(build(old_source.read_text(), "fourier_feats_old"))
    variant_libs = {k: build_variant(k) for k in VARIANTS}
    new_ff = ff.fourier_features
    lib = ff._lib()
    gen = torch.Generator(device=dev).manual_seed(0)
    report = {"card": card, "shapes": {}}
    for tag, (n, d, m, scale) in SHAPES.items():
        x = 2.0 * torch.rand((n, d), generator=gen, device=dev) - 1.0
        B = scale * torch.randn((d, m), generator=gen, device=dev)
        same = torch.equal(old_ff(x, B, True), new_ff(x, B, True))
        dev_ms = in_turns({"old": lambda: old_ff(x, B, True), "new": lambda: new_ff(x, B, True)},
                          chip_smoke.graph_ms)
        plain_ms = chip_smoke.graph_ms(lambda: ff.fourier_features_plain(x, B, True))
        floor_ms = chip_smoke.graph_ms(chip_smoke.ff_empty_launch(x, B))
        bound_ms = chip_smoke.bound(2.0 * n * d * m + 3.0 * n * m, 4.0 * (n * d + d * m + 2 * n * m))[0]
        out = torch.empty((n, 2 * m), device=dev)

        def direct(path, rows, lib_=lib):
            return lambda: _build.check(lib_.ff_forward(x.data_ptr(), B.data_ptr(), out.data_ptr(), n, d,
                                                        m, path, rows, 1, 1, 0, 0,
                                                        _build.stream_handle(dev)),
                                        "ff_forward")

        cols = m // 4 // ff.QUADS
        full = -(-n // ff.ROWS)
        variants = {"edge, rows n/8": direct(0, full), "vector, rows n/8": direct(d, full)}
        variants.update({f"vector, rows {k}x{sms}/{cols}": direct(d, min(full, k * sms // cols))
                         for k in MULTIPLES})
        plan_rows = ff.launch_plan(n, d, m, True, sms)[2]
        for name, (block_rows, _) in VARIANTS.items():  # as many threads per row as the plan
            variants[name] = direct(d, min(-(-n // block_rows), plan_rows * ff.ROWS // block_rows),
                                    variant_libs[name])
        ab_ms = in_turns(variants, chip_smoke.graph_ms)
        ref = ff.fourier_features_plain(x, B, True)
        new_out = new_ff(x, B, True)
        variant_rel, variant_same = {}, {}
        for name in VARIANTS:
            variants[name]()
            torch.cuda.synchronize()
            variant_rel[name] = float((out - ref).abs().max()) / float(ref.abs().max())
            variant_same[name] = torch.equal(out, new_out)
        variant_rel.pop("no trig")
        max_phase = float((x @ B).abs().max()) * ff._TWO_PI
        eager_ms = in_turns({"old": lambda: old_ff(x, B, True), "new": lambda: new_ff(x, B, True)},
                            lambda f: chip_smoke.cuda_ms(f, iters=200))
        host = in_turns({"old": lambda: old_ff(x, B, True), "new": lambda: new_ff(x, B, True)},
                        chip_smoke.host_us)
        split = {"old": old_split(x, B), "new": chip_smoke.ff_host_split(x, B)}
        report["shapes"][tag] = {"device_ms": dev_ms, "plain_ms": plain_ms, "floor_ms": floor_ms,
                                 "bound_ms": bound_ms, "bit_identical": same, "design_ab_ms": ab_ms,
                                 "variant_rel": variant_rel, "variant_same_bits": variant_same,
                                 "max_phase_rad": max_phase,
                                 "plan": ff.launch_plan(n, d, m, True, sms), "eager_ms": eager_ms,
                                 "host_us": host, "host_split_us": split}
        print(f"[ab] {tag}: device ms per call (CUDA graph, in turns) old {dev_ms['old']:.5f}, new "
              f"{dev_ms['new']:.5f}; plain {plain_ms:.5f}; bound {bound_ms:.5f}; empty kernel on the "
              f"new grid {floor_ms:.5f}; same bits {same} ({card})", flush=True)
        print(f"[ab] {tag}: design A/B (CUDA graph, in turns): "
              + ", ".join(f"{k} {v:.5f}" for k, v in ab_ms.items()) + f" ({card})", flush=True)
        print(f"[ab] {tag}: variants rel to max against plain (phases up to {max_phase:.1f} rad), and "
              "same bits as the new kernel: " + ", ".join(f"{k} {variant_rel[k]:.3e} {variant_same[k]}"
                                                           for k in variant_rel), flush=True)
        print(f"[ab] {tag}: eager ms per call (CUDA events) old {eager_ms['old']:.5f}, new "
              f"{eager_ms['new']:.5f}; host us per call old {host['old']:.2f}, new {host['new']:.2f}",
              flush=True)
        for side, sp in split.items():
            print(f"[ab] {tag}: host split {side}, us: " + ", ".join(f"{k} {v:.2f}" for k, v in sp.items()),
                  flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(report, indent=1))
    print(f"[ab] median new/old device time over the shapes: "
          f"{statistics.median(v['device_ms']['new'] / v['device_ms']['old'] for v in report['shapes'].values()):.3f}"
          f"; written to {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

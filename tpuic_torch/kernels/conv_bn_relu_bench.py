"""K3 (``csrc/conv_bn_relu.cu``) on the card: the conv launches of a
ResNet-50 forward, device timing, and design variants of the kernel timed
against it as it ships.

``chip_smoke.py`` takes :func:`resnet50_launches`, :func:`s2d_stem_launch`
and :func:`device_ms` from here.  Each variant is the shipped source with a few text substitutions, built
into its own library under ``tpuic_torch/_build/variants/`` and launched
through :func:`conv_bn_relu.fused_conv_bn_relu` with the same plan:

- ``shipped``: the source as it is.
- ``split_per_stage``: every landed float32 stage is split once into TF32
  hi/lo tiles in shared memory (hi in place, lo in a tile of its own),
  behind a second barrier, and the fragments are read already split;
  instead of splitting each fragment as it is read.
- ``no_products``: the MMAs taken out: the copies, barriers, split-K and
  epilogue alone.
- ``no_copies``: the copies taken out: the MMAs on whatever the tiles hold.

Usage (needs an NVIDIA GPU and ``nvcc``)::

    python -m tpuic_torch.kernels.conv_bn_relu_bench --out report.json

prints, per ResNet-50 conv shape at batch 8 in float32 and per variant,
the device milliseconds per call and, for the complete variants, the max
abs error against the plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
import time

SPLIT_FUNCS = r'''
// Splits the landed float32 stage once: hi in place, lo into the lo tiles.
template <int BM>
__device__ __forceinline__ void split_stage(uint32_t* slot, uint32_t* lo) {
  using L = TcTile<float, BM>;
  for (int i = threadIdx.x; i < BM * TBK / 4 + TBK * TBN / 4;
       i += L::THREADS) {
    const int j = i - BM * TBK / 4;
    const int off = j < 0 ? (i / (TBK / 4)) * RSA + 4 * (i % (TBK / 4))
                          : L::A_WORDS + (j / (TBN / 4)) * L::RSB +
                                4 * (j % (TBN / 4));
    uint4 v = *reinterpret_cast<uint4*>(slot + off), h, l;
    frag::split_tf32(__uint_as_float(v.x), h.x, l.x);
    frag::split_tf32(__uint_as_float(v.y), h.y, l.y);
    frag::split_tf32(__uint_as_float(v.z), h.z, l.z);
    frag::split_tf32(__uint_as_float(v.w), h.w, l.w);
    *reinterpret_cast<uint4*>(slot + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

// The warp's 32 x 32 tile += the stage's products, from split tiles.
template <int BM>
__device__ __forceinline__ void mma_stage_split(float (&acc)[2][4][4],
                                                const uint32_t* hi,
                                                const uint32_t* lo, int wm,
                                                int wn) {
  using L = TcTile<float, BM>;
  const int lane = threadIdx.x & 31, mi = lane >> 3, r = lane & 7;
  const int g = lane >> 2, t = lane & 3;
  const int a_off = (32 * wm + (mi & 1) * 8 + r) * RSA + (mi >> 1) * 4;
  const int b_off = L::A_WORDS + 32 * wn + g;
#pragma unroll
  for (int ks = 0; ks < TBK / 8; ++ks) {
    uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int o = a_off + 16 * mt * RSA + 8 * ks;
      frag::ldmatrix_x4(ah[mt], frag::smem_addr(hi + o));
      frag::ldmatrix_x4(al[mt], frag::smem_addr(lo + o));
    }
    const int r0 = 8 * ks + t, r1 = r0 + 4;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      bh[nt][0] = hi[b_off + r0 * L::RSB + 8 * nt];
      bh[nt][1] = hi[b_off + r1 * L::RSB + 8 * nt];
      bl[nt][0] = lo[b_off + r0 * L::RSB + 8 * nt];
      bl[nt][1] = lo[b_off + r1 * L::RSB + 8 * nt];
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        frag::mma_3xtf32(acc[mt][nt], ah[mt], al[mt], bh[nt], bl[nt]);
  }
}

'''

KERNEL = "template <typename TX, int BM>\n__global__ void __launch_bounds__"
MMA_CALL = "    mma_stage<TX, BM>(part, As, As + L::A_WORDS, wm, wn);\n"
LOADS = ("  load_a<TX, BM>(slot, ri, p, kbase);\n"
         "  load_b<L::THREADS, L::RSB>(slot + L::A_WORDS, p, kbase, n0);\n")

# name -> [(old, new), ...]: each old string occurs once in the source.
VARIANTS = {
    "shipped": [],
    "split_per_stage": [
        ("  static constexpr int WORDS = ROWINFO + RING * SLOT;",
         "  static constexpr int WORDS = ROWINFO + (RING + 1) * SLOT;"),
        (KERNEL, SPLIT_FUNCS + KERNEL),
        (MMA_CALL,
         "    if constexpr (L::F32) {\n"
         "      uint32_t* lo = ring + RING * L::SLOT;\n"
         "      split_stage<BM>(const_cast<uint32_t*>(As), lo);\n"
         "      __syncthreads();\n"
         "      mma_stage_split<BM>(part, As, lo, wm, wn);\n"
         "    } else {\n" + MMA_CALL + "    }\n"),
    ],
    "no_products": [(MMA_CALL, "")],
    "no_copies": [(LOADS, "  (void)slot; (void)ri; (void)p; (void)kbase;"
                          " (void)n0;\n")],
}
COMPLETE = ("shipped", "split_per_stage")


def variant_source(src: str, subs) -> str:
    """``src`` with every ``(old, new)`` of ``subs`` applied; raises if an
    ``old`` does not occur exactly once."""
    for old, new in subs:
        if src.count(old) != 1:
            raise ValueError(f"variant text occurs {src.count(old)} times in "
                             f"the kernel source: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def resnet50_launches(batch: int, size: int = 224):
    """``(x shape, w shape, strides, padding, relu)`` of every kernel launch
    of one fused ResNet-50 forward, in order: the stem, then per bottleneck
    conv1 (1x1), conv2 (3x3, the stride), conv3 (1x1) and the downsample
    conv of each stage's first block."""
    h = size
    out = [((batch, h, h, 3), (7, 7, 3, 64), 2, 3, True)]
    h = (h + 6 - 7) // 2 + 1          # stem conv
    h = (h + 2 - 3) // 2 + 1          # maxpool
    cin = 64
    for stage, n_blocks in enumerate((3, 4, 6, 3)):
        f = 64 * 2 ** stage
        for i in range(n_blocks):
            s = 2 if stage > 0 and i == 0 else 1
            ho = (h + 2 - 3) // s + 1
            out += [((batch, h, h, cin), (1, 1, cin, f), 1, 0, True),
                    ((batch, h, h, f), (3, 3, f, f), s, 1, True),
                    ((batch, ho, ho, f), (1, 1, f, 4 * f), 1, 0, False)]
            if s != 1 or cin != 4 * f:
                out.append(((batch, h, h, cin), (1, 1, cin, 4 * f), s, 0,
                            False))
            cin, h = 4 * f, ho
    return out


def s2d_stem_launch(batch: int, size: int = 224):
    """The space-to-depth stem's launch (models with ``s2d_stem``)."""
    return ((batch, size // 2, size // 2, 12), (4, 4, 12, 64), 1,
            ((2, 1), (2, 1)), True)


def distinct_shapes(batch: int):
    """The distinct launches of :func:`resnet50_launches`, in order, then
    the space-to-depth stem: the 24 shapes K3 is timed at."""
    return (list(dict.fromkeys(resnet50_launches(batch)))
            + [s2d_stem_launch(batch)])


def build_variants(names):
    """One ``nvcc`` per variant, all started together; returns
    ``{name: (library, ptxas register lines)}``."""
    from tpuic_torch.kernels import _build
    from tpuic_torch.kernels import conv_bn_relu as C
    src = (_build.CSRC / "conv_bn_relu.cu").read_text()
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        cu = out_dir / f"conv_bn_relu_{name}.cu"
        cu.write_text(variant_source(src, VARIANTS[name]))
        so = out_dir / f"libconv_bn_relu_{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{text}")
        regs = [ln.strip() for ln in text.splitlines()
                if "registers" in ln or "spill" in ln]
        libs[name] = (C.bind(ctypes.CDLL(str(so))), regs)
    return libs


# ~20 ms on the card: longer than the host takes to enqueue 20 calls.
SLEEP_CYCLES = 40_000_000


def earlier_bf16_conv(x, w, scale, bias, strides=1, padding=0, relu=True):
    """K3 through its mma.sync build (``csrc/conv_bn_relu.cu``) for bf16 x
    at a shape the wrapper now runs on the wgmma build: the earlier bf16
    design, timed beside it.  Allocates its own split-K scratch."""
    import torch
    from tpuic_torch.kernels import conv_bn_relu as K
    strides, padding = K.norm_strides(strides), K.norm_padding(padding)
    pl_ = K.plan(tuple(x.shape), tuple(w.shape), strides, padding, x.dtype)
    b, h, wi, cin = x.shape
    kh, kw, _, cout = w.shape
    (sh, sw), ((pt, pb), (pl, pr)) = strides, padding
    ho, wo = (h + pt + pb - kh) // sh + 1, (wi + pl + pr - kw) // sw + 1
    dims = (ctypes.c_int * 17)(b, h, wi, cin, kh, kw, cout, ho, wo, sh, sw,
                               pt, pl, int(relu), K._DTYPE_CODE[x.dtype],
                               pl_.bm, pl_.splits)
    out = torch.empty((b, ho, wo, cout), dtype=x.dtype, device=x.device)
    tiles = K._cdiv(b * ho * wo, pl_.bm) * K._cdiv(cout, K.BN)
    ws = cnt = None
    if pl_.splits > 1:
        ws = torch.empty(tiles * pl_.splits * pl_.bm * K.BN,
                         device=x.device)
        cnt = torch.zeros(tiles, dtype=torch.int32, device=x.device)
    rc = K._lib().tpuic_conv_bn_relu(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        out.data_ptr(), None if ws is None else ws.data_ptr(),
        None if cnt is None else cnt.data_ptr(), ctypes.addressof(dims),
        int(pl_.gather == 16), int(pl_.wgather == 16),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"earlier bf16 K3 launch failed: CUDA error {rc}")
    return out


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call over ``iters`` back-to-back calls:
    the card sleeps while the host enqueues them all, so the two events
    time the kernels and not the host's launch cost (a back-to-back timing
    without the sleep keeps that in)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch
    from tpuic_torch.kernels import conv_bn_relu as C
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    t0 = time.perf_counter()
    libs = build_variants(VARIANTS)
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, (_, regs) in libs.items():
        print(name, regs, flush=True)
    gen = torch.Generator().manual_seed(args.seed)
    rows = []
    for xs, ws, stride, padding, relu in distinct_shapes(args.batch):
        k = ws[0] * ws[1] * ws[2]
        x = torch.randn(xs, generator=gen).cuda()
        w = (torch.randn(ws, generator=gen) / math.sqrt(k)).cuda()
        scale = (1.0 + 0.1 * torch.randn(ws[3], generator=gen)).cuda()
        bias = (0.1 * torch.randn(ws[3], generator=gen)).cuda()
        kw = dict(strides=stride, padding=padding, relu=relu)
        want = C.fused_conv_bn_relu_plain(x, w, scale, bias, stride, padding,
                                          relu)
        row = {"x": list(xs), "w": list(ws), "stride": stride,
               "plan": C.plan(xs, ws, stride, padding)._asdict(), "ms": {},
               "max_abs_err": {}}
        for name, (lib, _) in libs.items():
            C._lib.cdll = lib
            got = C.fused_conv_bn_relu(x, w, scale, bias, **kw)
            torch.cuda.synchronize()
            if name in COMPLETE:
                row["max_abs_err"][name] = float((got - want).abs().max())
            row["ms"][name] = device_ms(
                lambda: C.fused_conv_bn_relu(x, w, scale, bias, **kw))
        C._lib.cdll = None
        print(json.dumps(row), flush=True)
        rows.append(row)
    total = {name: sum(r["ms"][name] for r in rows) for name in VARIANTS}
    print("sum over the shapes, once each:", json.dumps(total), flush=True)
    print(smi, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": smi, "batch": args.batch, "rows": rows,
                       "sum_ms": total}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

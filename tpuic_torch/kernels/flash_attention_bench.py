"""K4's forward on the card: design variants timed against it as it
ships, float32 (``csrc/flash_attention.cu``'s ``flash_fwd_kernel``) and
bfloat16 at D = 64 (``csrc/flash_fwd_sm90.cu``).

Each variant is the shipped source with a few text substitutions, built
into its own library under ``tpuic_torch/_build/variants/`` and launched
through :func:`flash_attention.flash_attention_fwd`; nothing on the port's
paths imports this module.

float32 (``flash_attention.cu``):

- ``shipped``: the source as it is: in float32 the warp's Q fragments
  are read from shared memory and split in every stage; four blocks an
  SM up to D = 64.
- ``three_blocks``: the shipped forward held to three blocks an SM.
- ``q_in_registers``: in float32 at D <= 64 the warp's Q fragments split
  once per block and held in registers over the key loop (64 registers
  more at D = 64), two blocks an SM.
- ``q_in_registers_three_blocks``: the same held to three blocks an SM
  (168 registers a thread), where ptxas spills.

bfloat16 at D = 64 (``flash_fwd_sm90.cu``, TMA and wgmma):

- ``shipped``: the persistent kernel, two tile sets (the next item's
  copies in flight while the current one computes).
- ``one_tile_set``: one set, so an item's copies start once the previous
  item is done.
- ``mma_sync_earlier``: the earlier bf16 build, ``flash_attention.cu``'s
  mma.sync forward (:func:`earlier_bf16_fwd`), which the wrapper no longer
  takes at D = 64.

Usage (needs an NVIDIA GPU and ``nvcc``)::

    python -m tpuic_torch.kernels.flash_attention_bench [--batch 64]

prints the registers and spills of each variant's forward
instantiations, then per dtype at [batch, 197, 12, 64] each variant's max
abs error against the plain version and its device milliseconds per call
(:func:`device_ms`).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys

FWD_BOUNDS = ("__global__ void __launch_bounds__(THREADS, FwdTile<T, D>::"
              "MIN_BLOCKS)\n    flash_fwd_kernel")
QREG = "static constexpr bool QREG = sizeof(T) == 2;"
Q_IN_REGISTERS = (QREG, "static constexpr bool QREG = sizeof(T) == 2 || "
                        "D <= 64;")


def _blocks(n: int):
    return (FWD_BOUNDS, FWD_BOUNDS.replace("FwdTile<T, D>::MIN_BLOCKS",
                                           str(n)))


# name -> [(old, new), ...]: each old string occurs once in the source.
VARIANTS = {
    "shipped": [],
    "three_blocks": [_blocks(3)],
    "q_in_registers": [Q_IN_REGISTERS, _blocks(2)],
    "q_in_registers_three_blocks": [Q_IN_REGISTERS, _blocks(3)],
}


# name -> [(old, new), ...] of flash_fwd_sm90.cu.
SM90_VARIANTS = {
    "shipped": [],
    "one_tile_set": [("constexpr int SETS = 2;", "constexpr int SETS = 1;")],
}


def earlier_bf16_fwd(q, k, v):
    """``(o, lse)`` through K4f's earlier bf16 build (``flash_attention.cu``'s
    mma.sync forward) on bf16 [B, N, H, D] CUDA tensors, all keys valid."""
    import importlib
    import math

    import torch
    FA = importlib.import_module("tpuic_torch.kernels.flash_attention")
    b, n, h, d = q.shape
    o = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    FA._launch(FA._lib().tpuic_flash_fwd, "earlier_bf16_fwd", q,
               (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), FA._strides(q, k, v), None, n, b, n, h, d,
                FA._DTYPE_CODE[q.dtype], 1.0 / math.sqrt(d), 0.0))
    return o, lse


def build_variants(names, source="flash_attention.cu", table=None):
    """One ``nvcc`` per variant of ``source``, all started together;
    returns ``{name: (library, registers and spills of each forward
    instantiation)}``."""
    from tpuic_torch.kernels import _build
    from tpuic_torch.kernels.conv_bn_relu_bench import variant_source
    table = VARIANTS if table is None else table
    stem = source[:-len(".cu")]
    src = (_build.CSRC / source).read_text()
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        cu = out_dir / f"{stem}_{name}.cu"
        cu.write_text(variant_source(src, table[name]))
        so = out_dir / f"lib{stem}_{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{text}")
        libs[name] = (ctypes.CDLL(str(so)), forward_registers(text))
    return libs


def forward_registers(ptxas: str) -> dict:
    """``{"<dtype> D=<d>": "<registers> registers, <n> bytes spilled"}``
    for every forward instantiation in ``nvcc -Xptxas -v`` output."""
    out, key = {}, None
    for line in ptxas.splitlines():
        m = re.search(r"flash_fwd_kernelI(f|13__nv_bfloat16)Li(\d+)E", line)
        if m and "Compiling entry" in line:
            dtype = "float32" if m.group(1) == "f" else "bf16"
            key = f"{dtype} D={m.group(2)}"
        elif "flash_fwd_sm90_kernel" in line and "Compiling entry" in line:
            key = "bf16 D=64 (sm90)"
        elif key and "spill stores" in line:
            out[key] = line.split(",")[1].strip()
        elif key and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out[key] = f"{regs} registers, {out.get(key, '')}"
            key = None
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import importlib

    import torch
    from tpuic_torch.kernels import no_tf32
    from tpuic_torch.kernels.conv_bn_relu_bench import device_ms
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    # The module, not the function the package exports under its name.
    FA = importlib.import_module("tpuic_torch.kernels.flash_attention")
    libs = build_variants(VARIANTS)
    sm90 = build_variants(SM90_VARIANTS, "flash_fwd_sm90.cu", SM90_VARIANTS)
    for name, (_, ptxas) in list(libs.items()) + list(sm90.items()):
        print(name, json.dumps(ptxas), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        b, n, h, d = args.batch, 197, 12, 64
        qkv = torch.randn((b, n, 3 * h * d), generator=gen,
                          device="cuda").to(dtype)
        q, k, v = (t.view(b, n, h, d) for t in qkv.split(h * d, dim=-1))
        with no_tf32():
            want, _ = FA.flash_attention_fwd_plain(q, k, v)
        row = {"shape": [b, n, h, d], "dtype": str(dtype)[6:],
               "max_abs_err": {}, "device_ms": {}}
        # Each variant twice, in turns, so a drift of the card's clock
        # shows as a difference between a variant's two numbers.  bf16 at
        # D = 64 runs the sm90 build's variants and the earlier build.
        names = (list(libs) if dtype == torch.float32
                 else list(sm90) + ["mma_sync_earlier"])
        for name in names + names[::-1]:
            fwd = lambda: FA.flash_attention_fwd(q, k, v)  # noqa: E731
            if name == "mma_sync_earlier":
                fwd = lambda: earlier_bf16_fwd(q, k, v)  # noqa: E731
            elif dtype == torch.float32:
                FA._lib.cdll = FA.bind(libs[name][0])
            else:
                FA._lib_sm90.cdll = FA.bind_sm90(sm90[name][0])
            o, _ = fwd()
            torch.cuda.synchronize()
            row["max_abs_err"][name] = float((o.float() - want.float())
                                             .abs().max())
            row["device_ms"].setdefault(name, []).append(device_ms(
                fwd, iters=50))
        FA._lib.cdll = FA._lib_sm90.cdll = None
        print(json.dumps(row), flush=True)
        rows.append(row)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

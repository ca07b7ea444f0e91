"""K4's forward (``csrc/flash_attention.cu``) on the card: design variants
of ``flash_fwd_kernel`` timed against it as it ships.

Each variant is the shipped source with a few text substitutions, built
into its own library under ``tpuic_torch/_build/variants/`` and launched
through :func:`flash_attention.flash_attention_fwd`; nothing on the port's
paths imports this module.

- ``shipped``: the source as it is: in float32 the warp's Q fragments
  are read from shared memory and split in every stage; four blocks an
  SM up to D = 64.
- ``three_blocks``: the shipped forward held to three blocks an SM.
- ``q_in_registers``: in float32 at D <= 64 the warp's Q fragments split
  once per block and held in registers over the key loop (64 registers
  more at D = 64), two blocks an SM.
- ``q_in_registers_three_blocks``: the same held to three blocks an SM
  (168 registers a thread), where ptxas spills.

Usage (needs an NVIDIA GPU and ``nvcc``)::

    python -m tpuic_torch.kernels.flash_attention_bench [--batch 64]

prints the registers and spills of each variant's forward
instantiations, then per dtype at [batch, 197, 12, 64] each variant's max abs error against the
plain version and its device milliseconds per call (:func:`device_ms`).
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


def build_variants(names):
    """One ``nvcc`` per variant, all started together; returns ``{name:
    (library, registers and spills of each forward instantiation)}``."""
    from tpuic_torch.kernels import _build
    from tpuic_torch.kernels.conv_bn_relu_bench import variant_source
    src = (_build.CSRC / "flash_attention.cu").read_text()
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        cu = out_dir / f"flash_attention_{name}.cu"
        cu.write_text(variant_source(src, VARIANTS[name]))
        so = out_dir / f"libflash_attention_{name}.so"
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
    for name, (_, ptxas) in libs.items():
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
        # shows as a difference between a variant's two numbers.
        for name in [*libs, *reversed(libs)]:
            FA._lib.cdll = FA.bind(libs[name][0])
            o, _ = FA.flash_attention_fwd(q, k, v)
            torch.cuda.synchronize()
            row["max_abs_err"][name] = float((o.float() - want.float())
                                             .abs().max())
            row["device_ms"].setdefault(name, []).append(device_ms(
                lambda: FA.flash_attention_fwd(q, k, v), iters=50))
        FA._lib.cdll = None
        print(json.dumps(row), flush=True)
        rows.append(row)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

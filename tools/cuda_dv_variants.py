"""Time variants of the port's dv kernel (csrc/dv.cu, K5) on a CUDA card:
``python3 tools/cuda_dv_variants.py [--set ring|diagnose]``.

Each variant is a copy of ``neural_admixture_tpu_torch/csrc`` under
``build/dv_variants/NAME`` with text substitutions in dv.cu; all build in
parallel (nvcc, one process each) and run through the C entry point
``na_dv`` on full-width rows (m_pad = 1,001,472, D = 8) at B = 800 (with
and without code 3) and at B = 96. CUDA events, 20 calls after 3, in the
order of the variants and then reversed.

* ``ring``: the depth of the cp.async ring (4, 8, 12, 16 slots) and the
  blocks' tiles taken contiguously or interleaved. These change no
  arithmetic: each variant's dV must equal the checkout's bit for bit.
* ``diagnose``: what holds the kernel, by removing one part at a time: the
  copies (nocopy), the mma (nomma), the chunk fold (nofold), the per-k-step
  barrier (nobar). Their dV is wrong by design, so they are timed only.

Writes chiprun_out/dv_variants_SET.json. Imports nothing of JAX.
"""
import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from neural_admixture_tpu_torch import _build  # noqa: E402

CSRC = os.path.join(REPO, "neural_admixture_tpu_torch", "csrc")
M_PAD, D = 1_001_472, 8

INTERLEAVE = [
    ("  const int64_t t0 = n_tiles * blockIdx.x / gridDim.x;\n"
     "  const int64_t t1 = n_tiles * (blockIdx.x + 1) / gridDim.x;\n"
     "  const int n_items = (int)(t1 - t0) * steps;",
     "  const int64_t t0 = blockIdx.x;\n"
     "  const int64_t cnt = (n_tiles - blockIdx.x + gridDim.x - 1) / "
     "gridDim.x;\n"
     "  const int n_items = (int)cnt * steps;"),
    ("      ++is_tile;\n", "      is_tile += gridDim.x;\n"),
    ("      ++tile;\n", "      tile += gridDim.x;\n"),
]


def stages(n):
    return [("constexpr int kStages = 8;", f"constexpr int kStages = {n};")]


NOCOPY = [("      cp_async16(dst, ok ? packed + base : packed, ok ? 16 : 0)"
           ";\n", "      (void)ok;\n")]
NOMMA = [("        mma_s8(acc[j][k], a0, a1, a2, a3, bf[k]);",
          "        acc[j][k][0] += a0 ^ a1 ^ a2 ^ a3 ^ bf[k].x ^ bf[k].y;")]
NOFOLD = [("          sums[j][q] =\n"
           "              __fadd_rn(sums[j][q], __fmul_rn(fold(a), q & 1 ? s1 "
           ": s0));",
           "          sums[j][q] += __int_as_float(a[0] ^ a[1] ^ a[2] ^ a[3]) "
           "* s0;")]
NOBAR = [("    __syncthreads();  // everyone's copies of it; everyone done "
          "with it - 1\n", "\n")]

SETS = {
    "ring": {"base": [], "interleave": INTERLEAVE, "stages4": stages(4),
             "stages12": stages(12), "stages16+interleave":
             stages(16) + INTERLEAVE},
    "diagnose": {"base": [], "nocopy": NOCOPY, "nomma": NOMMA,
                 "nocopy+nomma": NOCOPY + NOMMA, "nofold": NOFOLD,
                 "nobar": NOBAR, "nocopy+nobar": NOCOPY + NOBAR},
}


def make(name, subs):
    """Copy csrc/, substitute in dv.cu, build; returns (name, library path,
    registers line)."""
    d = os.path.join(REPO, "build", "dv_variants", name.replace("+", "_"))
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    for f in os.listdir(CSRC):
        if f.endswith((".cu", ".cuh")):
            shutil.copy(os.path.join(CSRC, f), d)
    path = os.path.join(d, "dv.cu")
    src = open(path).read()
    for old, new in subs:
        if src.count(old) != 1:
            raise ValueError(f"{name}: substitution does not apply once: "
                             f"{old!r}")
        src = src.replace(old, new)
    open(path, "w").write(src)
    info = _build.build(["dv"], csrc=d)["dv"]
    regs = [ln.split(":", 1)[1].strip() for ln in info["log"].splitlines()
            if "Used" in ln and "registers" in ln]
    return name, str(info["path"]), regs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--set", default="ring", choices=sorted(SETS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    variants = SETS[args.set]
    with ThreadPoolExecutor(len(variants)) as pool:
        built = list(pool.map(lambda kv: make(*kv), variants.items()))
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    libs = {}
    for name, path, regs in built:
        print(f"{name}: ptxas {regs[0] if regs else '?'}", flush=True)
        lib = ctypes.CDLL(path)
        lib.na_dv.argtypes = [vp, vp, vp, ll, ll, i, i, vp, i, vp]
        lib.na_dv.restype = i
        libs[name] = lib
    rng = np.random.default_rng(0)
    W = M_PAD // 4
    results = {"card": card, "set": args.set}
    for B, missing in ((800, True), (800, False), (96, True)):
        # uniform bytes, or uniform among the bytes with no code 3
        table = np.array([b for b in range(256) if missing or all(
            (b >> s) & 3 != 3 for s in (0, 2, 4, 6))], np.uint8)
        packed = torch.from_numpy(table[rng.integers(0, table.size,
                                                     size=(B, W))]).to(dev)
        dXp = torch.from_numpy(rng.normal(size=(B, D)).astype(np.float32)
                               ).to(dev)
        out = torch.empty(M_PAD, D, device=dev)

        def run(lib):
            err = lib.na_dv(packed.data_ptr(), dXp.data_ptr(), out.data_ptr(),
                            B, W, D, int(not missing), None, 1,
                            torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"na_dv failed: CUDA error {err}")

        ref = None
        for name, lib in libs.items():
            run(lib)
            torch.cuda.synchronize()
            if ref is None:
                ref = out.clone()
            elif args.set == "ring" and not torch.equal(out, ref):
                raise AssertionError(f"{name} differs from base")
        times = {}
        for name in list(libs) + list(libs)[::-1]:
            for _ in range(3):
                run(libs[name])
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(20):
                run(libs[name])
            b.record()
            torch.cuda.synchronize()
            times.setdefault(name, []).append(a.elapsed_time(b) / 20)
        key = f"B={B} {'with' if missing else 'without'} code 3"
        results[key] = times
        for name, ts in times.items():
            print(f"{key}, {name}: " + " / ".join(f"{t:.4f}" for t in ts)
                  + " ms", flush=True)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    name = f"dv_variants_{args.set}.json"
    with open(os.path.join(REPO, "chiprun_out", name), "w") as fb:
        json.dump(results, fb, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

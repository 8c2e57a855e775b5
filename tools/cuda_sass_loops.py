"""Count the SASS instructions of the port's kernels loop by loop, on the
machine with the CUDA toolkit: ``python3 tools/cuda_sass_loops.py [--csrc
DIR] [NAME ...]`` (NAME a source of ``csrc/``, e.g. ``bce_sum``; default
every source).

Builds the libraries (``_build.build``: the checkout's ``csrc/``, or DIR, a
copy of another version of it), disassembles each with ``cuobjdump -sass``
and, for every kernel, prints its instruction count and each innermost loop
(a backward branch and the instructions between its target and itself):
their number, and how many of them are tensor-core products (HMMA, IMMA),
special-function ops (MUFU), fp32 arithmetic (FADD, FMUL, FFMA, FMNMX),
selects and compares (SEL, FSEL, ISETP, FSETP), integer ops (IADD3,
IMAD, LOP3, SHF, LEA, ...), loads (LDG, LDS) and branches. The counts are
static: a branch inside a loop (a rare path) is counted as if taken. The
instructions an element are a loop's count over the elements one
iteration computes, which the kernel's source gives.

Writes the disassembly to chiprun_out/sass_NAME.txt.gz (gzip). Needs no
card.
"""
import argparse
import gzip
import os
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from neural_admixture_tpu_torch import _build  # noqa: E402

INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
FAMILIES = {
    "mma": ("HMMA", "IMMA"), "mufu": ("MUFU",),
    "fp32": ("FADD", "FMUL", "FFMA", "FMNMX", "FCHK"),
    "select": ("SEL", "FSEL", "ISETP", "FSETP", "PLOP3"),
    "int": ("IADD3", "IMAD", "LOP3", "SHF", "LEA", "IABS", "PRMT", "BFE",
            "BMSK", "FLO", "POPC", "I2F", "F2I", "MOV", "S2R", "CS2R"),
    "load": ("LDG", "LDS", "LDC", "LD", "LDSM"),
    "branch": ("BRA", "BSSY", "BSYNC", "EXIT", "RET", "CALL"),
}


def cuobjdump() -> str:
    for cand in ("/usr/local/cuda/bin/cuobjdump", shutil.which("cuobjdump")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("cuobjdump not found (/usr/local/cuda/bin, PATH)")


def functions(sass: str):
    """{kernel name: [(address, instruction text)]}."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = INSN.search(line)
        if m and name:
            text = re.sub(r"^@!?U?P\w+\s+", "", m.group(2).strip())
            out[name].append((int(m.group(1), 16), text))
    return out


def family(text: str) -> str:
    op = text.split()[0].split(".")[0]
    for fam, ops in FAMILIES.items():
        if op in ops:
            return fam
    return "other"


def innermost_loops(insns):
    """[(first address, last address)] of the loops that hold no other."""
    loops = []
    for addr, text in insns:
        m = re.match(r"BRA\s+(?:`\(\.L_x_\d+\)\s*)?0x([0-9a-f]+)", text)
        if m and int(m.group(1), 16) <= addr:
            loops.append((int(m.group(1), 16), addr))
    return [(a, b) for a, b in loops
            if not any(a <= c and d <= b and (c, d) != (a, b)
                       for c, d in loops)]


def busiest_loop(insns, op):
    """(instructions, ``op`` instructions) of the innermost loop that holds
    the most of ``op`` (e.g. HMMA: a kernel's main loop of products)."""
    best = (0, 0)
    for a, b in innermost_loops(insns):
        body = [t for addr, t in insns if a <= addr <= b]
        best = max(best, (sum(t.split()[0].split(".")[0] == op
                              for t in body), len(body)))
    return best[1], best[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("names", nargs="*")
    ap.add_argument("--csrc", default=str(_build.CSRC))
    args = ap.parse_args(argv)
    built = _build.build(args.names or None, Path(args.csrc))
    out_dir = Path(REPO) / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    tag = "" if Path(args.csrc) == _build.CSRC else "_other"
    for name, info in built.items():
        sass = subprocess.run([cuobjdump(), "-sass", str(info["path"])],
                              capture_output=True, text=True,
                              check=True).stdout
        with gzip.open(out_dir / f"sass_{name}{tag}.txt.gz", "wt") as fb:
            fb.write(sass)
        for fn, insns in functions(sass).items():
            print(f"{name} {fn}: {len(insns)} instructions")
            for a, b in innermost_loops(insns):
                body = [t for addr, t in insns if a <= addr <= b]
                fams = Counter(family(t) for t in body)
                print(f"   loop 0x{a:x}-0x{b:x}: {len(body)} instructions; "
                      + ", ".join(f"{f} {n}" for f, n in
                                  sorted(fams.items())), flush=True)


if __name__ == "__main__":
    main()

"""The native host decoder under ThreadSanitizer:
``python -m neural_admixture_tpu_torch.native.tsan``.

Builds ``bed_decode.cpp`` with the harness ``tsan_test.cpp`` (g++ -O1 -g
-pthread -fsanitize=thread -std=c++17) into ``native/build/``, named by a
hash of both sources and the flags as ``build.py`` names the library, then

1. runs the harness's canary, a deliberate data race, and requires
   ThreadSanitizer to report it: proof that the build instruments the code;
2. runs the harness with ``TSAN_OPTIONS=halt_on_error=1`` and requires exit
   0 and no report;
3. holds the chunking that the harness printed for each threaded entry
   point against ``bed_decode.cpp`` itself: the same dimension and chunk as
   the entry point passes to ``parallel_chunks``, and 2 or more chunks on a
   pool of 2 or more threads (a call of one chunk runs on the calling
   thread, which leaves ThreadSanitizer nothing to check).

Exits 0 only when all three hold. ``--canary`` runs the canary alone and
exits with its code, non-zero when ThreadSanitizer works. About 15 s on 8
cores.
"""
import argparse
import hashlib
import os
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Tuple

from .build import BUILD_DIR, SRC, _cxx

HARNESS = SRC.with_name("tsan_test.cpp")
TSAN_FLAGS = ["-O1", "-g", "-pthread", "-fsanitize=thread", "-std=c++17"]
REPORT = "WARNING: ThreadSanitizer:"


def binary_path(src: Path = SRC, out_dir: Path = BUILD_DIR) -> Path:
    """Where the harness of these sources and flags lives."""
    h = hashlib.sha256()
    for f in (src, HARNESS):
        h.update(f.read_bytes())
    h.update(" ".join([_cxx(), *TSAN_FLAGS]).encode())
    return out_dir / f"tsan_test_{h.hexdigest()[:16]}"


def build(src: Path = SRC, out_dir: Path = BUILD_DIR) -> Tuple[Path, float]:
    """Compiles the harness against ``src`` (a copy of bed_decode.cpp, by
    default this package's) into ``out_dir`` unless it is built there;
    returns its path and the compile's seconds (0.0 when it was built
    already). Raises RuntimeError with the compiler's output on failure."""
    exe = binary_path(src, out_dir)
    if exe.exists():
        return exe, 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = exe.with_name(f"{exe.name}.{os.getpid()}.tmp")
    cmd = [_cxx(), *TSAN_FLAGS, str(src), str(HARNESS), "-o", str(tmp)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"ThreadSanitizer build failed ({' '.join(cmd)}):"
                           f"\n{res.stderr}")
    os.replace(tmp, exe)
    return exe, time.perf_counter() - t0


def run(exe: Path, *args: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, TSAN_OPTIONS="halt_on_error=1")
    return subprocess.run([str(exe), *args], capture_output=True, text=True,
                          env=env)


def source_chunking() -> Dict[str, Tuple[str, int]]:
    """{entry point: (dimension, chunk)} of every ``parallel_chunks`` call
    in ``bed_decode.cpp``, read from the source: the dimension as written
    (N or M), the chunk as a number (a literal, or a constant of the
    function)."""
    text = SRC.read_text()
    out = {}
    for m in re.finditer(r"^\w[\w\s\*]*\b(na_\w+)\(.*?^\}", text,
                         re.M | re.S):
        body = m.group(0)
        for dim, tok in re.findall(r"parallel_chunks\((\w+),\s*(\w+)", body):
            if not tok.isdigit():
                tok = re.search(rf"\b{tok}\s*=\s*(\d+)", body).group(1)
            out[m.group(1)] = (dim, int(tok))
    return out


def harness_calls(stdout: str) -> Dict[str, Dict[str, str]]:
    """The harness's ``call NAME key=value ...`` lines, by name."""
    calls = {}
    for line in stdout.splitlines():
        if line.startswith("call "):
            name, *fields = line.split()[1:]
            calls[name] = dict(f.split("=", 1) for f in fields if "=" in f)
    return calls


def check_chunking(stdout: str) -> List[str]:
    """Faults of the harness's chunking against the source (none: [])."""
    calls = harness_calls(stdout)
    faults = []
    for name, (dim, chunk) in sorted(source_chunking().items()):
        c = calls.get(name)
        if c is None:
            faults.append(f"{name}: threaded in the source, not called by "
                          "the harness")
        elif (c.get("dim"), int(c.get("chunk", -1))) != (dim, chunk):
            faults.append(f"{name}: the harness assumes chunks of "
                          f"{c.get('chunk')} over {c.get('dim')}, the source "
                          f"passes {chunk} over {dim}")
        elif int(c["chunks"]) < 2 or int(c["pool"]) < 2:
            faults.append(f"{name}: {c['chunks']} chunk(s) on a pool of "
                          f"{c['pool']}: one thread")
    return faults


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--canary", action="store_true",
                    help="run only the deliberate data race and exit with "
                    "its code (non-zero when ThreadSanitizer reports it)")
    args = ap.parse_args(argv)
    exe, secs = build()
    print(f"tsan: {exe.name} ({'built in %.1f s' % secs if secs else 'built'}"
          f"; {' '.join(TSAN_FLAGS)})", flush=True)
    t0 = time.perf_counter()
    canary = run(exe, "--canary")
    if args.canary:
        sys.stdout.write(canary.stdout)
        sys.stderr.write(canary.stderr)
        return canary.returncode
    if canary.returncode == 0 or REPORT not in canary.stderr:
        print(f"tsan: the canary's data race went unreported (exit "
              f"{canary.returncode}): the build does not instrument the "
              f"code\n{canary.stderr[-2000:]}", file=sys.stderr)
        return 1
    print(f"tsan: canary reported (exit {canary.returncode}, "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    res = run(exe)
    sys.stdout.write(res.stdout)
    if res.returncode != 0 or REPORT in res.stderr:
        print(f"tsan: the harness failed (exit {res.returncode})\n"
              f"{res.stderr[-20000:]}", file=sys.stderr)
        return 1
    faults = check_chunking(res.stdout)
    if faults:
        print("tsan: " + "; ".join(faults), file=sys.stderr)
        return 1
    print(f"tsan: no data race in {SRC.name} "
          f"({len(harness_calls(res.stdout))} calls, "
          f"{time.perf_counter() - t0:.1f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Build the native host library from ``bed_decode.cpp`` with g++.

The library goes into ``native/build/``, named by a hash of the source and
the compiler flags (as ``_build.py`` names the CUDA libraries), so an
edited source is rebuilt at its next first use and an unchanged one is
loaded as it is. Threading is std::thread (-pthread), not OpenMP.

``python -m neural_admixture_tpu_torch.native.build`` builds it and prints
its path.
"""
import hashlib
import os
import platform
import shutil
import subprocess
import sysconfig
from pathlib import Path
from typing import List

_HERE = Path(__file__).resolve().parent
SRC = _HERE / "bed_decode.cpp"
BUILD_DIR = _HERE / "build"
CXX_FLAGS = ["-O3", "-pthread", "-std=c++17", "-shared", "-fPIC"]


def _march_flags() -> List[str]:
    """Portable-first -march candidates the build host can actually run.

    Compilation with -march=x86-64-v3 succeeds on any x86 host (the
    compiler never checks the CPU), so host support must be read from
    /proc/cpuinfo: a v3 binary built on a pre-AVX2 host would SIGILL on
    first use. Portable levels come before -march=native because the
    library may be copied with the checkout and run on another host.
    """
    if platform.machine() not in ("x86_64", "AMD64"):
        return ["-march=native", ""]
    flags = ""
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith("flags"):
                    flags = line
                    break
    except OSError:
        pass
    if "avx2" in flags:
        return ["-march=x86-64-v3", "-march=native", ""]
    if "sse4_2" in flags:
        return ["-march=x86-64-v2", "-march=native", ""]
    return ["-march=native", ""]


def _cxx() -> str:
    """The C++ compiler Python was built with, if this host has it, else
    g++."""
    cxx = (sysconfig.get_config_var("CXX") or "").split()
    for cand in (cxx[0] if cxx else None, "g++", "c++"):
        if cand and shutil.which(cand):
            return cand
    raise RuntimeError("no C++ compiler found (looked for Python's CXX, "
                       "g++ and c++ on PATH)")


def lib_path() -> Path:
    """Where the library of this source and these flags lives."""
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS + _march_flags()).encode())
    return BUILD_DIR / f"libna_native_{h.hexdigest()[:16]}.so"


def build(force: bool = False) -> Path:
    """Compile the library unless it is built already (``force``: compile
    anyway); returns its path. Raises RuntimeError with the compiler's
    output when every -march candidate fails."""
    lib = lib_path()
    if lib.exists() and not force:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cxx = _cxx()
    # Compile to a per-process temporary name and os.replace() it into
    # place: concurrent first-use builds (test workers, two CLI processes)
    # would otherwise race on one output path, and a process could dlopen
    # a half-written library.
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    res, cmd = None, None
    for march in _march_flags():
        cmd = [cxx, *([march] if march else []), *CXX_FLAGS, str(SRC),
               "-o", str(tmp)]
        res = subprocess.run(cmd, capture_output=True)
        if res.returncode == 0:
            os.replace(tmp, lib)
            return lib
    tmp.unlink(missing_ok=True)
    raise RuntimeError(f"native build failed ({' '.join(cmd)}):\n"
                       f"{res.stderr.decode(errors='replace')}")


if __name__ == "__main__":
    print(build(force=True))

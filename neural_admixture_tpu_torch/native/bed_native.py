"""ctypes bindings for the native host library (``bed_decode.cpp``).

The library is built at first use into ``native/build/`` (native/build.py).
Where it cannot be built (no compiler), ``available()`` is False, one
warning with the build error is logged, and the callers read through
their NumPy twins, which give the same bytes. A library without the
versioned PGEN symbol disables only PGEN decoding (``pgen_available``).

Each wrapper counts the calls that reach the library in its ``calls``
attribute (``decode_bed.calls``, ...), as the CUDA wrappers count their
launches; ``reset_calls`` and ``call_counts`` read and clear them all.
"""
import ctypes
from typing import Dict, Optional

import numpy as np

from ..utils.logger import log

_lib: Optional[ctypes.CDLL] = None
_tried = False

_u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
_f8p = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
_i64 = ctypes.c_int64


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.na_decode_bed.argtypes = [_u8p, _i64, _i64, _i64, _u8p]
    lib.na_decode_bed.restype = None
    lib.na_bed_to_packed.argtypes = [_u8p, _i64, _i64, _i64, _i64, _u8p]
    lib.na_bed_to_packed.restype = None
    lib.na_pack_2bit.argtypes = [_u8p, _i64, _i64, _i64, _u8p]
    lib.na_pack_2bit.restype = None
    lib.na_loglikelihood.argtypes = [_u8p, _f8p, _f8p, _i64, _i64, _i64,
                                     ctypes.c_double]
    lib.na_loglikelihood.restype = ctypes.c_double
    try:
        # Optional: a library without the versioned (spec-conformant)
        # PGEN decoder must not disable the other kernels, and must not be
        # used for PGEN decoding either.
        lib.na_pgen_decode2.argtypes = [_u8p, _i64p, _u8p, _i64, _i64, _i64,
                                        _i64, _u8p, _i64p, _u8p]
        lib.na_pgen_decode2.restype = _i64
        lib._has_pgen = True
    except AttributeError:
        lib._has_pgen = False
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    from . import build
    try:
        try:
            _lib = _bind(ctypes.CDLL(str(build.build())))
        except (OSError, AttributeError):
            # A library that does not load here (built on another host) or
            # lacks a required symbol: rebuild it with this host's compiler.
            _lib = _bind(ctypes.CDLL(str(build.build(force=True))))
    except (OSError, AttributeError, RuntimeError) as exc:
        _lib = None
        log.warning("    The native host decoder could not be built or "
                    f"loaded ({exc}); reading with the NumPy decoders, "
                    "which give the same bytes more slowly.")
    return _lib


def available() -> bool:
    return _load() is not None


def library_path() -> Optional[str]:
    """The path of the loaded library, None without one."""
    lib = _load()
    return None if lib is None else lib._name


def decode_bed(B: np.ndarray, N: int) -> np.ndarray:
    """SNP-major BED bytes (M, ceil(N/4)) -> (N, M) uint8 dosages."""
    lib = _load()
    B = np.ascontiguousarray(B, dtype=np.uint8)
    M, nbytes = B.shape
    out = np.empty((N, M), dtype=np.uint8)
    lib.na_decode_bed(B, M, nbytes, N, out)
    decode_bed.calls += 1
    return out


def bed_to_packed(B: np.ndarray, N: int, m_pad: int) -> np.ndarray:
    """SNP-major BED bytes -> sample-major 2-bit packed (N, m_pad//4),
    without materialising the (N, M) uint8 matrix."""
    lib = _load()
    B = np.ascontiguousarray(B, dtype=np.uint8)
    M, nbytes = B.shape
    if m_pad % 4 or m_pad < M:
        raise ValueError(f"m_pad {m_pad} must be a multiple of 4 and at "
                         f"least M = {M}")
    W = m_pad // 4
    out = np.zeros((N, W), dtype=np.uint8)
    lib.na_bed_to_packed(B, M, nbytes, N, W, out)
    bed_to_packed.calls += 1
    return out


def pack_2bit(G: np.ndarray, m_pad: int) -> np.ndarray:
    """(N, M) uint8 dosages -> (N, m_pad//4) 2-bit packed rows."""
    lib = _load()
    G = np.ascontiguousarray(G, dtype=np.uint8)
    N, M = G.shape
    if m_pad % 4 or m_pad < M:
        raise ValueError(f"m_pad {m_pad} must be a multiple of 4 and at "
                         f"least M = {M}")
    W = m_pad // 4
    out = np.zeros((N, W), dtype=np.uint8)
    lib.na_pack_2bit(G, N, M, W, out)
    pack_2bit.calls += 1
    return out


def loglikelihood(G: np.ndarray, P: np.ndarray, Q: np.ndarray,
                  eps: float = 1e-6) -> float:
    """The masked binomial log-likelihood of G (N, M) uint8 under P (M, K)
    and Q (N, K), in float64."""
    lib = _load()
    G = np.ascontiguousarray(G, dtype=np.uint8)
    P = np.ascontiguousarray(P, dtype=np.float64)
    Q = np.ascontiguousarray(Q, dtype=np.float64)
    N, M = G.shape
    K = P.shape[1]
    if Q.shape != (N, K) or P.shape != (M, K):
        raise ValueError(f"shapes G {G.shape}, P {P.shape}, Q {Q.shape} do "
                         "not agree")
    out = float(lib.na_loglikelihood(G, P, Q, N, M, K, eps))
    loglikelihood.calls += 1
    return out


def pgen_available() -> bool:
    lib = _load()
    return lib is not None and getattr(lib, "_has_pgen", False)


def pgen_decode(recs: np.ndarray, rec_off: np.ndarray, vrtypes: np.ndarray,
                skip: int, N: int, sid_bytes: int, base: np.ndarray,
                base_valid: np.ndarray) -> np.ndarray:
    """Decode mode-0x10/0x11 variant records (io/pgen_standard.py's loop).

    ``recs``: contiguous record bytes for len(vrtypes) variants, delimited
    by ``rec_off`` (len + 1 int64). The first ``skip`` variants only
    rebuild the LD-base state; the rest land in the returned
    (len - skip, N) uint8 array. ``base`` (N,) uint8 and ``base_valid``
    (1,) int64 persist the LD state across calls (the caller owns them).
    Raises ValueError on a malformed or unsupported record (the caller
    then decodes with the pure-Python path, which re-raises on a record
    that is truly malformed).
    """
    lib = _load()
    n_var = vrtypes.shape[0]
    out = np.empty((n_var - skip, N), dtype=np.uint8)
    rc = lib.na_pgen_decode2(
        np.ascontiguousarray(recs, np.uint8),
        np.ascontiguousarray(rec_off, np.int64),
        np.ascontiguousarray(vrtypes, np.uint8),
        n_var, skip, N, sid_bytes, base, base_valid, out)
    pgen_decode.calls += 1
    if rc != 0:
        raise ValueError(f"na_pgen_decode2 failed with code {rc}")
    return out


_COUNTED = (decode_bed, bed_to_packed, pack_2bit, loglikelihood, pgen_decode)


def reset_calls() -> None:
    for fn in _COUNTED:
        fn.calls = 0


def call_counts() -> Dict[str, int]:
    return {fn.__name__: fn.calls for fn in _COUNTED}


reset_calls()

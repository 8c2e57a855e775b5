"""Decoder for PLINK2 PGEN "standard" storage modes (0x10/0x11), the JAX
package's io/pgen_standard.py.

plink2 writes mode-0x10 files by default: per-variant records compressed
with difflists (sparse / LD / onebit representations). This module reads
them without pgenlib, in pure Python or through the native host library's
record decoder (native/bed_native.py pgen_decode, C++). pgenlib is still
PREFERRED when importable (io/pgen.py open_pgen tries it first) -- this is
the fallback.

Implemented from the public PGEN specification draft
(github.com/chrchang/plink-ng, pgen_spec), matching pgenlib's semantics:

  header:   magic 6C 1B | mode (0x10 or 0x11) | variant_ct u32le |
            sample_ct u32le | header control byte FMT.
            Mode 0x11 splits the file: the .pgen holds only the 3 magic/
            mode bytes followed directly by the variant records, and the
            rest of the header (bytes 3..11, block offsets, block indexes)
            lives in a companion ``<file>.pgi`` index file prefixed with
            the same 3 magic/mode bytes.
  FMT bits 0-3 (record type/length storage, pgenlib
            ``vrtype_and_fpos_storage``):
            0..7 -> vrtypes are 4-bit when (value & 4) == 0 else 8-bit;
                    record lengths are (value & 3) + 1 bytes each (LE);
            8    -> every record is a plain 2-bit hardcall of ceil(N/4)
                    bytes; no offset array or per-block index is stored;
            9..15 (fixed-width dosage layouts) are not supported here.
  FMT bits 4-5: bytes per explicit allele count (0 = absent).
  FMT bits 6-7: 2-bit provisional-reference code; ONLY code 3 stores a
            per-variant nonref-flag bitarray in the block index (codes
            0/1/2 mean "uniformly provisional / trusted": no bitarray).
  then:     ceil(variant_ct / 2^16) u64le file positions, the k-th the
            position of variant block k's FIRST VARIANT RECORD (in the
            .pgen -- the only quantity not computable from the header).
            The per-block indexes follow this array contiguously
            (vrtypes array, then record lengths, then optional allele
            counts / nonref-flag bitarray); record positions inside a
            block are the block offset plus the running record lengths.

  vrtype & 7 (main genotype track; codes 0=hom ref, 1=het, 2=hom alt,
  3=missing, 4 samples/byte, low bits first):
    0    plain 2-bit, ceil(N/4) bytes
    1    onebit: 1 header byte C (low common value = C >> 2, second value
         = (C >> 2) + (C & 3)), ceil(N/8) bitarray (bit set -> second
         value), then a difflist of rare exceptions
    2    LD difflist: copy the most recent variant whose vrtype & 7 is
         not in {2, 3}, then apply the difflist
    3    as 2, with the base genotypes inverted (0 <-> 2) first
    4-7  difflist against the constant genotype (vrtype & 3): 4 = all
         hom ref, 5 = all het, 6 = all hom alt, 7 = all missing
  Higher vrtype bits flag multiallelic/phase/dosage tracks appended to
  the record -- genotype decoding is unaffected, the extra bytes are
  covered by the record length; hardcalls-only consumers skip them.
  When no high bit is set the main track must consume the record
  EXACTLY -- leftover bytes mean a misparse and raise.

  difflist: [vint L] and, when L > 0:
    [ceil(L/64) group-start sample ids, sample_id_bytes(N) bytes each]
    [ceil(L/4) bytes of 2-bit genotype values ("raregeno")]
    [L - ceil(L/64) vint deltas between consecutive sample ids, the
     per-group streams (63 deltas each) concatenated]
  sample ids must be strictly increasing and < sample_ct (checked).
  sample_id_bytes(N) = bytes needed to represent the VALUE N (pgenlib
  ``BytesToRepresentNzU32(raw_sample_ct)``): N = 255 -> 1, N = 256 -> 2.
  vint = LEB128 (7 data bits/byte, high bit = continuation).

VERIFICATION STATUS: the layout above is from the public spec, and
write_pgen_standard below emits it, so reader and writer are pinned
mutually bit-exact across every record type, and both decode paths (this
module and the C++ na_pgen_decode2) are fuzzed against each other with
corrupted inputs: they must agree on accept-vs-reject and never crash
(tests/test_torch_port_readers.py, which also holds both against the JAX
package's decoder). pgenlib itself is the check of the spec where it is
installed; where it is not, treat plink2-written 0x10/0x11 inputs as
best-effort and prefer installing pgenlib for production. Strict
structural validation (exact record consumption, monotone sample ids,
bounds everywhere) turns most conceivable misreadings into loud errors
instead of silent garbage.
"""
import os
from typing import List, Tuple

import numpy as np

MAGIC = b"\x6c\x1b"
VBLOCK = 1 << 16  # variants per block


def _sample_id_bytes(n: int) -> int:
    """Bytes per stored difflist sample id: the width representing the
    value ``n`` itself (pgenlib ``BytesToRepresentNzU32(raw_sample_ct)``,
    NOT n - 1: n = 256 stores ids in 2 bytes even though 255 fits one)."""
    return (int(n).bit_length() + 7) // 8


def _read_vint(buf: np.ndarray, pos: int) -> Tuple[int, int]:
    val, shift = 0, 0
    size = buf.size
    while True:
        if pos >= size:
            raise ValueError("PGEN record truncated inside a vint")
        byte = int(buf[pos])
        pos += 1
        val |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return val, pos
        shift += 7
        if shift > 56:
            raise ValueError("PGEN vint overflows 63 bits")


def _read_vints(buf: np.ndarray, pos: int, count: int
                ) -> Tuple[np.ndarray, int]:
    """Parse ``count`` consecutive LEB128 vints, vectorized for the common
    all-1-byte case (difflist deltas are almost always < 128)."""
    if count == 0:
        return np.zeros(0, np.int64), pos
    window = buf[pos:pos + 5 * count]
    if window.size >= count and not (window[:count] & 0x80).any():
        return window[:count].astype(np.int64), pos + count
    out = np.empty(count, np.int64)
    for i in range(count):
        out[i], pos = _read_vint(buf, pos)
    return out, pos


def _unpack2(raw: np.ndarray, n: int) -> np.ndarray:
    """ceil(n/4) packed bytes -> (n,) 2-bit values (io.packed layout)."""
    from .packed import unpack_2bit_rows
    return unpack_2bit_rows(raw.reshape(1, -1), n)[0]


def _pack2(vals: np.ndarray) -> np.ndarray:
    """(n,) 2-bit values -> ceil(n/4) packed bytes (io.packed layout)."""
    from .packed import pack_2bit_rows
    return pack_2bit_rows(vals.reshape(1, -1))[0]


def _parse_difflist(rec: np.ndarray, pos: int, n: int
                    ) -> Tuple[np.ndarray, np.ndarray, int]:
    """(sample_ids, genotype_values, next_pos) of one difflist.

    Validates structure: lengths/bounds, and sample ids strictly
    increasing in [0, n)."""
    L, pos = _read_vint(rec, pos)
    if L > n:
        raise ValueError(f"PGEN difflist length {L} exceeds sample count")
    if L == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.uint8), pos
    sid_b = _sample_id_bytes(n)
    n_groups = -(-L // 64)
    raw = rec[pos:pos + n_groups * sid_b]
    if raw.size < n_groups * sid_b:
        raise ValueError("PGEN difflist truncated in group starts")
    raw = raw.reshape(n_groups, sid_b)
    starts = (raw.astype(np.int64)
              @ (np.int64(1) << (8 * np.arange(sid_b, dtype=np.int64))))
    pos += n_groups * sid_b
    rg = -(-L // 4)
    if rec.size - pos < rg:
        raise ValueError("PGEN difflist truncated in raregeno")
    vals = _unpack2(rec[pos:pos + rg], L)
    pos += rg
    deltas, pos = _read_vints(rec, pos, L - n_groups)
    ids = np.empty(L, np.int64)
    d0 = 0
    for g in range(n_groups):
        size = min(64, L - g * 64)
        ids[g * 64] = starts[g]
        if size > 1:
            ids[g * 64 + 1:g * 64 + size] = starts[g] + np.cumsum(
                deltas[d0:d0 + size - 1])
        d0 += size - 1
    # EVERY id must be bounds-checked, not just the last: int64 cumsum
    # wraps silently in numpy, so 63 crafted huge deltas can wrap the
    # running sum back under n with all pairwise diffs positive -- the
    # final-id check alone would accept and then crash (IndexError) on
    # the fancy-indexed assignment instead of rejecting cleanly.
    if (ids < 0).any() or (ids >= n).any() \
            or (L > 1 and (np.diff(ids) <= 0).any()):
        raise ValueError("PGEN difflist sample ids not strictly "
                         "increasing within bounds")
    return ids, vals, pos


_INVERT = np.array([2, 1, 0, 3], dtype=np.uint8)  # 0<->2, het/missing fixed


class StandardPgen:
    """Block reader for mode-0x10/0x11 PGEN files (same surface as
    io/pgen.py's readers: .N, .M, read_block(v0, v1) -> (v1-v0, N) uint8,
    missing=3)."""

    def __init__(self, path: str):
        with open(path, "rb") as fh:
            head = fh.read(12)
        if head[:2] != MAGIC or head[2] not in (0x10, 0x11):
            raise ValueError(f"{path} is not a mode-0x10/0x11 PGEN file")
        self.path = path
        self.mode = head[2]
        if self.mode == 0x11:
            # Separate-index variant: header/offsets/index live in the
            # companion <file>.pgi; the .pgen holds records from byte 3.
            self._index_path = path + ".pgi"
            if not os.path.exists(self._index_path):
                raise FileNotFoundError(
                    f"{path} is a mode-0x11 PGEN (separate index); its "
                    f"companion index {self._index_path} is missing.")
            with open(self._index_path, "rb") as fh:
                hdr = fh.read(12)
            if hdr[:2] != MAGIC or hdr[2] != 0x11:
                raise ValueError(
                    f"{self._index_path} is not a mode-0x11 PGEN index")
            data_start = 3
        else:
            self._index_path = path
            hdr = head
            data_start = 12
        if len(hdr) < 12:
            raise ValueError(f"{path}: PGEN header truncated")
        self.M = int(np.frombuffer(hdr[3:7], "<u4")[0])
        self.N = int(np.frombuffer(hdr[7:11], "<u4")[0])
        if self.M == 0 or self.N == 0:
            raise ValueError(f"{path}: empty PGEN ({self.M} x {self.N})")
        fmt = hdr[11]
        storage = fmt & 0x0F
        self._ac_b = (fmt >> 4) & 3
        self._nonref_code = (fmt >> 6) & 3
        if storage >= 8:
            if storage != 8 or self._ac_b or self._nonref_code == 3:
                raise NotImplementedError(
                    f"PGEN header control byte {fmt:#04x} (storage code "
                    f"{storage}) uses a fixed-width dosage/auxiliary "
                    "layout this reader does not support; install "
                    "pgenlib.")
            # Storage 8: every record is a plain 2-bit hardcall; no
            # offset array or block index exists (so the index-file size
            # says nothing about M -- a mode-0x11 .pgi is 12 bytes).
            # Bound M by the record file BEFORE the (M+1)-sized
            # allocation below so a corrupt header fails cheaply.
            need = data_start + self.M * (-(-self.N // 4))
            if need > os.path.getsize(path):
                raise ValueError(
                    f"{path}: PGEN truncated ({self.M} fixed-width "
                    f"records need {need} bytes, file has "
                    f"{os.path.getsize(path)})")
            self.vrtypes = np.zeros(self.M, np.uint8)
            self.rec_pos = data_start + (-(-self.N // 4)) * np.arange(
                self.M + 1, dtype=np.int64)
        else:
            if self.M > 2 * os.path.getsize(self._index_path):
                # The smallest index spends >= half a byte per variant
                # (4-bit vrtypes): a header claiming more variants than
                # that is corrupt. Also keeps corrupt headers from
                # driving giant allocations in _load_index.
                raise ValueError(
                    f"{path}: variant count {self.M} is impossible for a "
                    f"{os.path.getsize(self._index_path)}-byte file")
            self._vrtype8 = bool(storage & 4)
            self._len_b = (storage & 3) + 1
            self._load_index()
        if self.rec_pos[-1] > os.path.getsize(path):
            raise ValueError(
                f"{path}: PGEN truncated (records end at "
                f"{int(self.rec_pos[-1])}, file has "
                f"{os.path.getsize(path)} bytes)")
        # Sequential-decode state: genotypes of the most recent non-LD
        # variant (the base the LD difflists patch), and the next variant
        # index the state is valid to continue from.
        self._ld_base_idx = -1
        self._ld_base = None
        self._next = 0
        # Native (C++) decoder state: caller-persisted LD base + validity
        # flag (see native/bed_decode.cpp na_pgen_decode2).
        self._nat_base = np.zeros(self.N, np.uint8)
        self._nat_valid = np.zeros(1, np.int64)
        self._nat_next = 0

    def _load_index(self):
        n_blocks = -(-self.M // VBLOCK)
        with open(self._index_path, "rb") as fh:
            fh.seek(12)
            block_pos = np.fromfile(fh, "<u8", n_blocks)
            if block_pos.size < n_blocks:
                raise ValueError("PGEN block-offset array truncated")
            vrtypes = np.empty(self.M, np.uint8)
            self.rec_pos = np.empty(self.M + 1, np.int64)
            # Per-block indexes are contiguous right after the offsets;
            # the u64 offsets locate each block's first RECORD.
            fsize = os.path.getsize(self.path)
            if (block_pos > fsize).any():
                raise ValueError(
                    "PGEN block offsets point past the end of the file")
            for b in range(n_blocks):
                bm = min(VBLOCK, self.M - b * VBLOCK)
                if self._vrtype8:
                    vt = np.fromfile(fh, np.uint8, bm)
                else:
                    raw = np.fromfile(fh, np.uint8, -(-bm // 2))
                    if raw.size < -(-bm // 2):
                        raise ValueError("PGEN vrtype index truncated")
                    vt = ((raw[:, None] >> np.array([0, 4], np.uint8)) & 0xF
                          ).reshape(-1)[:bm].astype(np.uint8)
                if vt.size < bm:
                    raise ValueError("PGEN vrtype index truncated")
                vrtypes[b * VBLOCK:b * VBLOCK + bm] = vt
                raw = np.fromfile(fh, np.uint8, bm * self._len_b)
                if raw.size < bm * self._len_b:
                    raise ValueError("PGEN record-length index truncated")
                lens = raw.reshape(bm, self._len_b).astype(np.int64) \
                    @ (np.int64(1) << (8 * np.arange(self._len_b,
                                                     dtype=np.int64)))
                base = int(block_pos[b])
                self.rec_pos[b * VBLOCK] = base
                self.rec_pos[b * VBLOCK + 1:b * VBLOCK + bm + 1] = \
                    base + np.cumsum(lens)
                skip = bm * self._ac_b \
                    + (-(-bm // 8) if self._nonref_code == 3 else 0)
                fh.seek(skip, 1)
        self.vrtypes = vrtypes
        if (np.diff(self.rec_pos) < 0).any():
            raise ValueError("PGEN record positions are not monotone "
                             "(corrupt block offsets or lengths)")

    def _record(self, fh, v: int) -> np.ndarray:
        fh.seek(int(self.rec_pos[v]))
        return np.fromfile(fh, np.uint8,
                           int(self.rec_pos[v + 1] - self.rec_pos[v]))

    def _decode_one(self, fh, v: int) -> np.ndarray:
        """(N,) genotypes of variant v; maintains the LD-base state, so call
        in ascending order (read_block rewinds to the base when needed)."""
        vt = int(self.vrtypes[v])
        t = vt & 7
        rec = self._record(fh, v)
        if t == 0:
            nb = -(-self.N // 4)
            if rec.size < nb:
                raise ValueError(f"PGEN record {v} truncated (plain)")
            g = _unpack2(rec[:nb], self.N)
            pos = nb
        elif t == 1:  # onebit: value0 = C >> 2, value1 = value0 + (C & 3)
            nb = -(-self.N // 8)
            if rec.size < 1 + nb:
                raise ValueError(f"PGEN record {v} truncated (onebit)")
            code = int(rec[0])
            v_lo, delta = code >> 2, code & 3
            if v_lo + delta > 3:
                raise ValueError(
                    f"PGEN record {v}: onebit common values out of range")
            bits = np.unpackbits(rec[1:1 + nb], bitorder="little")[:self.N]
            g = np.where(bits, np.uint8(v_lo + delta), np.uint8(v_lo))
            ids, vals, pos = _parse_difflist(rec, 1 + nb, self.N)
            g[ids] = vals
        elif t in (2, 3):  # LD / inverted LD
            if self._ld_base_idx == -1:
                raise ValueError(
                    f"PGEN record {v}: LD-compressed variant has no base")
            g = self._ld_base.copy() if t == 2 else _INVERT[self._ld_base]
            ids, vals, pos = _parse_difflist(rec, 0, self.N)
            g[ids] = vals
        else:  # 4-7: difflist against the constant genotype (vt & 3)
            g = np.full(self.N, vt & 3, np.uint8)
            ids, vals, pos = _parse_difflist(rec, 0, self.N)
            g[ids] = vals
        if not vt & 0xF8 and pos != rec.size:
            raise ValueError(
                f"PGEN record {v}: {rec.size - pos} undecoded trailing "
                "bytes (misparse or corrupt record)")
        if (t & 6) != 2:
            self._ld_base_idx, self._ld_base = v, g
        return g

    def read_block(self, v0: int, v1: int) -> np.ndarray:
        """Dosages of variants [v0, v1) as (v1-v0, N) uint8, missing == 3.

        Uses the native C++ record decoder when built (same spec model,
        pinned bit-identical to this pure-Python path by tests); a native
        decode error hands the block to the pure path, which re-raises on
        a record that is truly malformed."""
        from ..native import bed_native
        if bed_native.pgen_available() and v1 > v0:
            try:
                return self._read_block_native(bed_native, v0, v1)
            except ValueError:
                self._nat_valid[0] = 0
        out = np.empty((v1 - v0, self.N), np.uint8)
        with open(self.path, "rb") as fh:
            start = v0
            if not (self._ld_base_idx >= 0 and v0 == self._next):
                # Random access: rewind to the nearest non-LD variant at or
                # before v0 and rebuild the LD-base state from it.
                while start > 0 and (self.vrtypes[start] & 7) in (2, 3):
                    start -= 1
                self._ld_base_idx = -1
            for v in range(start, v1):
                g = self._decode_one(fh, v)
                if v >= v0:
                    out[v - v0] = g
        self._next = v1
        return out

    def _read_block_native(self, bed_native, v0: int, v1: int) -> np.ndarray:
        """C++ decode of [v0, v1): one contiguous record read (rewound to
        the nearest non-LD variant when the persisted LD state cannot
        continue from v0)."""
        if self._nat_valid[0] and v0 == self._nat_next:
            start = v0
        else:
            start = v0
            while start > 0 and (self.vrtypes[start] & 7) in (2, 3):
                start -= 1
            self._nat_valid[0] = 0
        with open(self.path, "rb") as fh:
            fh.seek(int(self.rec_pos[start]))
            recs = np.fromfile(
                fh, np.uint8, int(self.rec_pos[v1] - self.rec_pos[start]))
        if recs.size < int(self.rec_pos[v1] - self.rec_pos[start]):
            raise ValueError("PGEN truncated mid-record")
        rec_off = (self.rec_pos[start:v1 + 1]
                   - self.rec_pos[start]).astype(np.int64)
        out = bed_native.pgen_decode(
            recs, rec_off, self.vrtypes[start:v1], v0 - start, self.N,
            _sample_id_bytes(self.N), self._nat_base, self._nat_valid)
        self._nat_next = v1
        return out


# ------------------------------ writer --------------------------------------


def _difflist_bytes(ids: np.ndarray, vals: np.ndarray, n: int) -> bytes:
    out = bytearray()
    L = ids.size
    _write_vint(out, L)
    if L == 0:
        return bytes(out)
    sid_b = _sample_id_bytes(n)
    n_groups = -(-L // 64)
    for g in range(n_groups):
        out += int(ids[g * 64]).to_bytes(sid_b, "little")
    out += _pack2(vals).tobytes()
    for g in range(n_groups):
        size = min(64, L - g * 64)
        for d in np.diff(ids[g * 64:g * 64 + size]):
            _write_vint(out, int(d))
    return bytes(out)


def _write_vint(out: bytearray, v: int) -> None:
    while True:
        if v < 0x80:
            out.append(v)
            return
        out.append(0x80 | (v & 0x7F))
        v >>= 7


def _write_psam(path: str, N: int) -> None:
    from pathlib import Path
    p = Path(path)
    base = p.with_suffix("") if p.suffix == ".pgen" else p
    with open(str(base) + ".psam", "w") as fh:
        fh.write("#IID\tSEX\n")
        for i in range(N):
            fh.write(f"sample{i}\tNA\n")


def write_pgen_standard(path: str, G: np.ndarray, psam: bool = True,
                        ld_chain: bool = True, idx_enc: int = None,
                        nonref_code: int = 0, allele_ct_bytes: int = 0,
                        mode: int = 0x10, fixed_width: bool = False
                        ) -> List[int]:
    """Write ``G`` (N, M) uint8 dosages (3 = missing) as a mode-0x10/0x11
    PGEN, choosing the cheapest representation per variant like plink2
    does (plain / constant-base difflist / onebit / LD difflist vs the
    previous non-LD variant).

    ``idx_enc`` = the header control byte's storage code (0..3 = 4-bit
    vrtypes, 4..7 = 8-bit; (value & 3) + 1 length bytes); None = 8-bit
    vrtypes with the narrowest length width that fits the longest record.
    ``nonref_code`` (0/1/2/3) sets the provisional-reference code; code 3
    writes an all-zero per-variant nonref bitarray into each block index.
    ``allele_ct_bytes`` > 0 stores an explicit allele count (2) per
    variant in the index. ``mode=0x11`` writes the separate-index layout
    (records-only .pgen + ``<path>.pgi``). ``fixed_width=True`` writes
    storage code 8 (all records plain 2-bit, no index at all).
    Returns the chosen vrtypes (for tests asserting type coverage).
    Fixture/tooling writer -- it also pins the reader above bit-exactly.
    """
    G = np.ascontiguousarray(G, np.uint8)
    N, M = G.shape
    assert mode in (0x10, 0x11) and 0 <= nonref_code <= 3 \
        and 0 <= allele_ct_bytes <= 3

    if fixed_width:
        assert not allele_ct_bytes and nonref_code != 3, \
            "storage code 8 stores no index to put aux fields in"

        def _header(fh):
            fh.write(MAGIC + bytes([mode]))
            fh.write(np.asarray([M], "<u4").tobytes())
            fh.write(np.asarray([N], "<u4").tobytes())
            fh.write(bytes([8 | (nonref_code << 6)]))

        if mode == 0x11:
            # Separate-index layout: the 12-byte header IS the whole
            # .pgi (storage 8 has no offsets/index); records follow the
            # 3 magic/mode bytes in the .pgen.
            with open(path + ".pgi", "wb") as fh:
                _header(fh)
        with open(path, "wb") as fh:
            if mode == 0x11:
                fh.write(MAGIC + bytes([mode]))
            else:
                _header(fh)
            for v in range(M):
                fh.write(_pack2(G[:, v]).tobytes())
        if psam:
            _write_psam(path, N)
        return [0] * M

    recs, vrtypes = [], []
    base = None

    def dl(mask, vals_src):
        ids = np.flatnonzero(mask).astype(np.int64)
        return _difflist_bytes(ids, vals_src[ids], N)

    for v in range(M):
        g = G[:, v]
        cands = [(0, _pack2(g).tobytes())]
        for c in (0, 2, 3):  # constant-base difflists (base het is useless)
            cands.append((4 + c, dl(g != c, g)))
        counts = np.bincount(g, minlength=4)
        top2 = np.argsort(-counts, kind="stable")[:2]
        lo, hi = int(min(top2)), int(max(top2))
        head = bytes([(lo << 2) | (hi - lo)])
        bits = np.packbits(g == hi, bitorder="little")
        cands.append((1, head + bits.tobytes()
                      + dl((g != lo) & (g != hi), g)))
        if base is not None and ld_chain and v % VBLOCK:
            cands.append((2, dl(g != base, g)))
            cands.append((3, dl(g != _INVERT[base], g)))
        t, rec = min(cands, key=lambda c: len(c[1]))
        vrtypes.append(t)
        recs.append(rec)
        if (t & 6) != 2:
            base = g
    if idx_enc is None:
        max_len = max((len(r) for r in recs), default=0)
        len_b = 1
        while max_len >= 256 ** len_b:
            len_b += 1
        idx_enc = 4 + (len_b - 1)
    assert 0 <= idx_enc <= 7, idx_enc
    vrtype8 = idx_enc >= 4
    len_b = (idx_enc & 3) + 1
    fmt = idx_enc | (allele_ct_bytes << 4) | (nonref_code << 6)

    n_blocks = -(-M // VBLOCK)
    block_sizes = []  # (index bytes, record bytes) per block
    for bk in range(n_blocks):
        bm = min(VBLOCK, M - bk * VBLOCK)
        idx = (bm if vrtype8 else -(-bm // 2)) + bm * len_b \
            + bm * allele_ct_bytes + (-(-bm // 8) if nonref_code == 3 else 0)
        rec = sum(len(r) for r in recs[bk * VBLOCK:bk * VBLOCK + bm])
        block_sizes.append((idx, rec))

    if mode == 0x11:
        rec0 = 3  # records start right after the .pgen magic/mode bytes
        index_path = path + ".pgi"
    else:
        rec0 = 12 + 8 * n_blocks + sum(i for i, _ in block_sizes)
        index_path = path
    offs, pos = [], rec0
    for idx, rec in block_sizes:
        offs.append(pos)
        pos += rec

    def write_header_and_index(fh):
        fh.write(MAGIC + bytes([mode]))
        fh.write(np.asarray([M], "<u4").tobytes())
        fh.write(np.asarray([N], "<u4").tobytes())
        fh.write(bytes([fmt]))
        fh.write(np.asarray(offs, "<u8").tobytes())
        for bk in range(n_blocks):
            bm = min(VBLOCK, M - bk * VBLOCK)
            vt = np.asarray(vrtypes[bk * VBLOCK:bk * VBLOCK + bm], np.uint8)
            if vrtype8:
                fh.write(vt.tobytes())
            else:
                padded = np.zeros(-(-bm // 2) * 2, np.uint8)
                padded[:bm] = vt
                fh.write((padded[0::2] | (padded[1::2] << 4)).tobytes())
            lens = np.asarray(
                [len(r) for r in recs[bk * VBLOCK:bk * VBLOCK + bm]],
                np.int64)
            assert lens.max(initial=0) < 256 ** len_b, \
                f"record too long for {len_b}-byte lengths"
            le = np.zeros((bm, len_b), np.uint8)
            for j in range(len_b):
                le[:, j] = (lens >> (8 * j)) & 0xFF
            fh.write(le.tobytes())
            if allele_ct_bytes:
                ac = np.zeros((bm, allele_ct_bytes), np.uint8)
                ac[:, 0] = 2  # biallelic
                fh.write(ac.tobytes())
            if nonref_code == 3:
                fh.write(bytes(-(-bm // 8)))  # all-zero nonref bitarray

    if mode == 0x11:
        with open(index_path, "wb") as fh:
            write_header_and_index(fh)
        with open(path, "wb") as fh:
            fh.write(MAGIC + bytes([mode]))
            for rec in recs:
                fh.write(rec)
    else:
        with open(path, "wb") as fh:
            write_header_and_index(fh)
            for rec in recs:
                fh.write(rec)
    if psam:
        _write_psam(path, N)
    return vrtypes

"""PLINK 2 PGEN genotype input (the JAX package's io/pgen.py).

  * with ``pgenlib`` installed, variants are read in blocks through
    ``PgenReader.read_range`` (alt-allele hardcall counts, missing = -9);
  * without pgenlib, the fixed-width storage modes 0x01 and 0x02 are
    decoded here in NumPy, and the compressed "standard" modes 0x10 / 0x11
    -- what plink2 writes by default (difflist/LD/onebit records; 0x11
    keeps its index in a companion .pgi file) -- by io/pgen_standard.py;
    other modes raise a clear install-pgenlib error;
  * ``read_pgen_packed`` streams variant blocks straight into the
    sample-major 2-bit packed rows, the contract of io/bed.py
    read_bed_packed: the (N, M) uint8 matrix never exists.

Fixed-width storage modes (PGEN spec, plink-ng PgenFileFormat):
  0x01  the body after the 3 magic bytes is a PLINK1 .bed payload
        (variant-major, codes {0b00: hom A1, 0b01: missing, 0b10: het,
        0b11: hom A2}); the sample count comes from the companion .psam
        (or .fam);
  0x02  the header continues with variant_ct (u32 LE) and sample_ct (u32
        LE), then one ceil(N/4)-byte record per variant, 2 bits per sample
        with direct dosage codes {0, 1, 2, 3=missing}.
"""
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..utils.logger import log, setup_logging
from .bed import (_LUT8 as _BED_LUT8, _chunked_hist, flip_packed_minor_allele,
                  packed_code_counts, rezero_flip_padding)
from .packed import packed_width

MAGIC = b"\x6c\x1b"
_BLOCK_VARIANTS = 4096  # variants per streamed read (multiple of 4)

# Mode-0x02 per-byte decode: 4 direct 2-bit dosage codes, low bits first.
_DIRECT_LUT8 = np.zeros((256, 4), dtype=np.uint8)
for _b in range(256):
    for _j in range(4):
        _DIRECT_LUT8[_b, _j] = (_b >> (2 * _j)) & 3


def _psam_sample_count(pgen_path: Path) -> int:
    """Sample count from the companion .psam (or .fam) metadata file."""
    for suffix in (".psam", ".fam"):
        meta = pgen_path.with_suffix(suffix)
        if meta.exists():
            with open(meta, "r") as fh:
                return sum(1 for line in fh
                           if line.strip() and not line.startswith("#"))
    raise FileNotFoundError(
        f"Mode-0x01 PGEN needs a companion {pgen_path.with_suffix('.psam')} "
        "(or .fam) to determine the sample count.")


class _FixedWidthPgen:
    """NumPy reader for the uncompressed PGEN storage modes 0x01/0x02.

    The surface of every PGEN reader here: ``N``, ``M`` and
    ``read_block(v0, v1)`` -> (v1-v0, N) uint8 dosages with missing == 3.
    """

    def __init__(self, path: str):
        self.path = Path(path)
        with open(self.path, "rb") as fh:
            head = fh.read(11)
        if head[:2] != MAGIC:
            raise ValueError(f"{path} is not a PGEN file (bad magic)")
        self.mode = head[2]
        size = self.path.stat().st_size
        if self.mode == 0x01:
            self.N = _psam_sample_count(self.path)
            self._data_start = 3
            rec = -(-self.N // 4)
            payload = size - 3
            if payload % rec:
                raise ValueError(
                    f"PGEN payload {payload} B is not a whole number of "
                    f"ceil(N/4)={rec} B variant records; .psam mismatch?")
            self.M = payload // rec
        elif self.mode == 0x02:
            self.M = int(np.frombuffer(head[3:7], "<u4")[0])
            self.N = int(np.frombuffer(head[7:11], "<u4")[0])
            self._data_start = 11
            rec = -(-self.N // 4)
            if size - 11 < self.M * rec:
                raise ValueError(
                    f"PGEN file truncated: expected {self.M} x {rec} B "
                    f"records, found {size - 11} B")
        else:
            raise NotImplementedError(
                f"PGEN storage mode {self.mode:#04x} is compressed/variable "
                "width; install pgenlib to read it (pip install pgenlib).")
        self._rec = -(-self.N // 4)
        self._lut = _BED_LUT8 if self.mode == 0x01 else _DIRECT_LUT8

    def read_block(self, v0: int, v1: int) -> np.ndarray:
        """Dosages of variants [v0, v1) as (v1-v0, N) uint8, missing == 3."""
        with open(self.path, "rb") as fh:
            fh.seek(self._data_start + v0 * self._rec)
            raw = np.fromfile(fh, np.uint8, (v1 - v0) * self._rec)
        raw = raw.reshape(v1 - v0, self._rec)
        return self._lut[raw].reshape(v1 - v0, -1)[:, :self.N]


class _PgenlibPgen:
    """pgenlib-backed block reader (handles every storage mode)."""

    def __init__(self, path: str):
        import pgenlib
        self._reader = pgenlib.PgenReader(bytes(Path(path)))
        self.M = self._reader.get_variant_ct()
        self.N = self._reader.get_raw_sample_ct()

    def read_block(self, v0: int, v1: int) -> np.ndarray:
        buf = np.empty((v1 - v0, self.N), dtype=np.int8)
        self._reader.read_range(v0, v1, buf)
        out = buf.view(np.uint8)
        out[buf < 0] = 3  # pgenlib encodes missing hardcalls as -9
        return out


def open_pgen(path: str):
    """The best PGEN block reader here: pgenlib where it imports, else the
    fixed-width reader (modes 0x01/0x02) or io/pgen_standard.py's
    StandardPgen (modes 0x10/0x11)."""
    try:
        import pgenlib  # noqa: F401
        return _PgenlibPgen(path)
    except ImportError:
        with open(path, "rb") as fh:
            mode = fh.read(3)[2:]
        if mode and mode[0] in (0x10, 0x11):
            from .pgen_standard import StandardPgen
            setup_logging()
            log.warning(
                "    pgenlib is not installed; decoding this mode-%#04x "
                "PGEN with the built-in reader (implemented from the public "
                "spec draft; cross-validated against pgenlib only where it "
                "is installed -- prefer `pip install pgenlib` for "
                "production, see io/pgen_standard.py).", mode[0])
            return StandardPgen(path)
        return _FixedWidthPgen(path)


def read_pgen(path: str) -> np.ndarray:
    """Dense (N, M) uint8 dosage matrix (3 = missing), read per block."""
    reader = open_pgen(path)
    N, M = reader.N, reader.M
    G = np.empty((N, M), dtype=np.uint8)
    for v0 in range(0, M, _BLOCK_VARIANTS):
        v1 = min(v0 + _BLOCK_VARIANTS, M)
        G[:, v0:v1] = reader.read_block(v0, v1).T
    return G


def _pack_block(gb: np.ndarray) -> np.ndarray:
    """(n, vb) dosages -> (n, ceil(vb/4)) packed bytes, the final partial
    byte's fields zero."""
    n, vb = gb.shape
    vb4 = -(-vb // 4) * 4
    if vb4 != vb:
        gb = np.concatenate([gb, np.zeros((n, vb4 - vb), np.uint8)], axis=1)
    g4 = gb.reshape(n, vb4 // 4, 4)
    return (g4[:, :, 0] | (g4[:, :, 1] << 2)
            | (g4[:, :, 2] << 4) | (g4[:, :, 3] << 6))


def read_pgen_packed(path: str, lane_multiple: int = 2048
                     ) -> Tuple[np.ndarray, int, int]:
    """Stream a PGEN file straight into the sample-major 2-bit packed layout.

    io/bed.py read_bed_packed's contract: the biallelic check and the
    minor-allele flip (mean dosage, missing counted as 3, >= 1 -> 2 - g) in
    the packed domain; (packed (N, m_pad//4) uint8, N, M) out. Peak extra
    memory is one variant block, not the (N, M) matrix.
    """
    reader = open_pgen(path)
    N, M = reader.N, reader.M
    m_pad = ((M + lane_multiple - 1) // lane_multiple) * lane_multiple
    packed = np.zeros((N, packed_width(m_pad)), dtype=np.uint8)
    counts = np.zeros(4, dtype=np.int64)
    for v0 in range(0, M, _BLOCK_VARIANTS):
        v1 = min(v0 + _BLOCK_VARIANTS, M)
        gb = np.ascontiguousarray(reader.read_block(v0, v1).T)  # (N, vb)
        counts += _chunked_hist(gb)[:4]
        pb = _pack_block(gb)
        packed[:, v0 // 4:v0 // 4 + pb.shape[1]] = pb

    if not (counts[0] > 0 and (counts[2] > 0 or counts[3] > 0)):
        raise ValueError("Only biallelic SNPs are supported. Please make sure "
                         "multiallelic sites have been removed.")
    mean = float((counts * np.arange(4)).sum()) / max(1, int(counts.sum()))
    if mean >= 1:
        packed = rezero_flip_padding(flip_packed_minor_allele(packed), M)
    return packed, N, M


def read_pgen_packed_rows(path: str, start: int, end: int,
                          lane_multiple: int = 2048
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Decode only sample rows [start, end) into the packed layout.

    The per-host input path, io/bed.py read_bed_packed_rows's contract: no
    validation or minor-allele flip (both need global counts); returns
    (packed_rows, local_code_counts). Each variant block is read once and
    only the local sample columns are kept.
    """
    reader = open_pgen(path)
    N, M = reader.N, reader.M
    if not 0 <= start <= end <= N:
        raise ValueError(f"rows [{start}, {end}) are not within [0, {N})")
    m_pad = ((M + lane_multiple - 1) // lane_multiple) * lane_multiple
    packed = np.zeros((end - start, packed_width(m_pad)), dtype=np.uint8)
    for v0 in range(0, M, _BLOCK_VARIANTS):
        v1 = min(v0 + _BLOCK_VARIANTS, M)
        pb = _pack_block(np.ascontiguousarray(
            reader.read_block(v0, v1)[:, start:end].T))  # (n_local, vb)
        packed[:, v0 // 4:v0 // 4 + pb.shape[1]] = pb
    return packed, packed_code_counts(packed, M)


def pgen_dims(path: str) -> Tuple[int, int]:
    """(N, M) of a PGEN fileset without decoding any genotypes."""
    reader = open_pgen(path)
    return reader.N, reader.M


def write_pgen_mode2(path: str, G: np.ndarray,
                     psam: Optional[bool] = True) -> None:
    """Write a mode-0x02 fixed-width PGEN file (plus a minimal .psam).

    Makes valid PGEN fixtures without pgenlib. ``G`` is (N, M) uint8
    dosages with 3 = missing.
    """
    G = np.ascontiguousarray(G, dtype=np.uint8)
    N, M = G.shape
    records = _pack_block(np.ascontiguousarray(G.T)).astype(np.uint8)
    with open(path, "wb") as fh:
        fh.write(MAGIC + b"\x02")
        fh.write(np.asarray([M], "<u4").tobytes())
        fh.write(np.asarray([N], "<u4").tobytes())
        fh.write(records.tobytes())
    if psam:
        with open(Path(path).with_suffix(".psam"), "w") as fh:
            fh.write("#IID\tSEX\n")
            for i in range(N):
                fh.write(f"sample{i}\tNA\n")

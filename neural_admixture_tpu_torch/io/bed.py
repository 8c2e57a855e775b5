"""PLINK BED genotype decoding, straight into the 2-bit packed layout.

The BED format stores genotypes SNP-major: after a 3-byte magic, each SNP
occupies ceil(N/4) bytes, 4 samples per byte, 2 bits per sample, with codes

    0b00 -> 2 (hom. first/A1 allele)   0b01 -> 3 (missing)
    0b10 -> 1 (het.)                   0b11 -> 0 (hom. second/A2 allele)

i.e. the dosage lookup table [2, 3, 1, 0].

Two decode paths give the same bytes:
  * the native host library (native/bed_native.py, C++ built with g++ at
    first use), which decodes BED bytes straight into the sample-major
    2-bit packed layout, or into dense dosages for :func:`read_bed`;
  * its NumPy twin, a 256x4 lookup table (:func:`decode_bed_numpy`) and
    io/packed.py's packing, used where the library cannot be built.
"""
from math import ceil
from pathlib import Path
from typing import Tuple

import numpy as np

from .packed import pack_2bit_rows, unpack_2bit_rows

# lut8[b] = 4 dosages encoded in byte b (sample order: low bits first)
_LUT4 = np.array([2, 3, 1, 0], dtype=np.uint8)
_LUT8 = np.zeros((256, 4), dtype=np.uint8)
for _b in range(256):
    for _j in range(4):
        _LUT8[_b, _j] = _LUT4[(_b >> (2 * _j)) & 3]


def read_bed_dims(file: str) -> Tuple[int, int]:
    """Return (N, M) for a BED fileset by counting .fam lines and sizing .bed."""
    file_path = Path(file)
    fam_file = file_path.with_suffix(".fam")
    bed_file = file_path.with_suffix(".bed")
    with open(fam_file, "r") as fam:
        # Skip blank lines: a trailing newline-only line would otherwise add
        # a phantom sample decoded from BED padding bits (code 0b00 is
        # dosage 2), and the payload size check below cannot catch it when
        # ceil(N/4) is unchanged.
        N = sum(1 for line in fam if line.strip())
    n_bytes_per_snp = ceil(N / 4)
    total = bed_file.stat().st_size - 3
    if total % n_bytes_per_snp != 0:
        raise ValueError(f".bed payload size {total} is not a multiple of "
                         f"ceil(N/4)={n_bytes_per_snp}; .fam/.bed mismatch")
    return N, total // n_bytes_per_snp


def _check_magic(bed_file: Path) -> None:
    with open(bed_file, "rb") as bed:
        magic = bed.read(3)
    if magic[:2] != b"\x6c\x1b":
        raise ValueError(f"{bed_file} is not a PLINK BED file (bad magic)")
    if magic[2] != 1:
        raise ValueError("Only SNP-major (mode 1) BED files are supported")


def read_bed_bytes(file: str) -> Tuple[np.ndarray, int, int]:
    """Read the raw SNP-major byte matrix of shape (M, ceil(N/4)), with N
    and M."""
    bed_file = Path(file).with_suffix(".bed")
    N, M = read_bed_dims(file)
    _check_magic(bed_file)
    B = np.fromfile(bed_file, dtype=np.uint8, offset=3)
    return B.reshape(M, ceil(N / 4)), N, M


def decode_bed_numpy(B: np.ndarray, N: int) -> np.ndarray:
    """Decode SNP-major BED bytes (M, ceil(N/4)) to sample-major dosages (N, M)."""
    M = B.shape[0]
    G = _LUT8[B].reshape(M, -1)[:, :N]
    return np.ascontiguousarray(G.T)


def _native():
    """The native library's bindings, or None where it cannot be built."""
    from ..native import bed_native
    return bed_native if bed_native.available() else None


def read_bed(file: str) -> np.ndarray:
    """Read a BED fileset into a (N, M) uint8 dosage matrix (3 = missing),
    natively where the library is built, else through NumPy."""
    B, N, M = read_bed_bytes(file)
    native = _native()
    return native.decode_bed(B, N) if native else decode_bed_numpy(B, N)


def _bed_block_to_packed(B: np.ndarray, N: int, m_pad: int, native
                         ) -> np.ndarray:
    """SNP-major BED bytes (M, ceil(N/4)) -> packed rows (N, m_pad // 4),
    through the native library or, without it, its NumPy twin."""
    if native:
        return native.bed_to_packed(B, N, m_pad)
    return pack_2bit_rows(decode_bed_numpy(B, N), m_pad=m_pad)


_BYTE_CODE_CNT = np.stack([(_LUT8 == v).sum(axis=1)
                           for v in range(4)], axis=1).astype(np.int64)


def _chunked_hist(arr: np.ndarray, minlength: int = 256) -> np.ndarray:
    """256-bin byte histogram with one bounded reused buffer.

    np.bincount first casts its input to intp -- an 8x copy of the whole
    array -- so the cast runs chunked through ``buf``. ``arr`` may be a
    memmap (one sequential read pass)."""
    flat = arr.reshape(-1)
    total = flat.size
    chunk = int(max(1 << 16, min(1 << 22, total // 32))) or 1
    buf = np.empty(chunk, np.intp)
    hist = np.zeros(max(256, minlength), np.int64)
    for i in range(0, total, chunk):
        n = min(chunk, total - i)
        np.copyto(buf[:n], flat[i:i + n])
        hist += np.bincount(buf[:n], minlength=max(256, minlength))
    return hist


def bed_code_counts(B: np.ndarray, N: int) -> np.ndarray:
    """Count dosage codes {0,1,2,3} over the whole BED matrix, excluding the
    tail padding samples of each byte. Returns shape (4,) int64, with
    bounded extra memory (a byte histogram times a per-byte count table)."""
    hist = _chunked_hist(B)
    counts = hist @ _BYTE_CODE_CNT
    tail = (-N) % 4
    if tail:
        last_hist = _chunked_hist(np.ascontiguousarray(B[:, -1]))
        for slot in range(4 - tail, 4):
            pad_vals = _LUT8[:, slot]
            for v in range(4):
                counts[v] -= int(last_hist[pad_vals == v].sum())
    return counts


def flip_packed_minor_allele(packed: np.ndarray) -> np.ndarray:
    """Dosage flip g -> 2-g (missing 3 unchanged) directly on 2-bit rows.

    Per 2-bit field v: {0->2, 1->1, 2->0, 3->3} == v XOR 2 iff LSB(v) == 0,
    i.e. bytewise ``b ^ ((~b & 0x55) << 1)``. Padding fields are 0 and become
    2 -- callers re-zero them (:func:`rezero_flip_padding`).
    """
    b = np.asarray(packed)
    return (b ^ ((~b & 0x55) << 1)).astype(np.uint8)


# Direct 2-bit dosage-code counts per packed byte.
_PACKED_CODE_CNT = np.zeros((256, 4), dtype=np.int64)
for _b in range(256):
    for _j in range(4):
        _PACKED_CODE_CNT[_b, (_b >> (2 * _j)) & 3] += 1


def packed_code_counts(packed: np.ndarray, M: int) -> np.ndarray:
    """Dosage-code histogram {0,1,2,3} of 2-bit packed rows, excluding the
    zero padding columns beyond M."""
    packed = np.asarray(packed)
    hist = _chunked_hist(packed)
    counts = hist @ _PACKED_CODE_CNT
    counts[0] -= packed.shape[0] * (packed.shape[1] * 4 - M)
    return counts


def rezero_flip_padding(packed: np.ndarray, M: int) -> np.ndarray:
    """Re-zero the padding columns beyond M that a minor-allele flip turned
    into dosage 2 (in place; also returns ``packed``)."""
    m_pad = packed.shape[1] * 4
    if m_pad != M:
        w_last = M // 4  # whole bytes before the partial/padding region
        tail = unpack_2bit_rows(packed[:, w_last:], m_pad - w_last * 4)
        tail[:, M - w_last * 4:] = 0
        packed[:, w_last:] = pack_2bit_rows(tail)
    return packed


def read_bed_packed_rows(file: str, start: int, end: int,
                         lane_multiple: int = 2048
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Decode only sample rows [start, end) into the packed layout.

    The per-host input path of a run over several processes: each decodes
    and holds just its block; the .bed bytes are memmapped so only the
    pages covering the requested samples are read. No validation or
    minor-allele flip is applied -- both need global code counts -- so this
    returns (packed_rows, local_code_counts) and the caller combines the
    counts across hosts before flipping (flip_packed_minor_allele +
    rezero_flip_padding).
    """
    N, M = read_bed_dims(file)
    if not 0 <= start <= end <= N:
        raise ValueError(f"rows [{start}, {end}) are not within [0, {N})")
    b0, b1 = start // 4, ceil(end / 4)
    mm = np.memmap(Path(file).with_suffix(".bed"), dtype=np.uint8,
                   mode="r", offset=3, shape=(M, ceil(N / 4)))
    B = np.ascontiguousarray(mm[:, b0:b1])
    del mm
    n_slice = min(4 * b1, N) - 4 * b0  # decoded samples in the byte slice
    m_pad = ((M + lane_multiple - 1) // lane_multiple) * lane_multiple
    packed = _bed_block_to_packed(B, n_slice, m_pad, _native())
    del B
    packed = np.ascontiguousarray(packed[start - 4 * b0:end - 4 * b0])
    return packed, packed_code_counts(packed, M)


def read_bed_packed(file: str, lane_multiple: int = 2048,
                    block_m: int = None) -> Tuple[np.ndarray, int, int]:
    """Read a BED fileset straight into the sample-major 2-bit packed layout.

    The .bed payload is memmapped and decoded in SNP blocks of ``block_m``
    variants, so neither the (N, M) uint8 matrix nor the whole SNP-major
    byte matrix is ever held in memory. Each block is decoded by the
    native library where it is built, else by its NumPy twin. Applies the
    reference's validation (biallelic codes) and minor-allele flip (mean
    dosage >= 1 -> 2 - g) in the packed domain. Returns (packed (N,
    m_pad//4) uint8, N, M), with M padded to a multiple of
    ``lane_multiple``.
    """
    bed_file = Path(file).with_suffix(".bed")
    N, M = read_bed_dims(file)
    _check_magic(bed_file)
    mm = np.memmap(bed_file, dtype=np.uint8, mode="r", offset=3,
                   shape=(M, ceil(N / 4)))
    counts = bed_code_counts(mm, N)
    if not (counts[0] > 0 and (counts[2] > 0 or counts[3] > 0)):
        raise ValueError("Only biallelic SNPs are supported. Please make sure "
                         "multiallelic sites have been removed.")
    mean = (counts[1] * 1 + counts[2] * 2 + counts[3] * 3) \
        / max(1, int(counts.sum()))

    m_pad = ((M + lane_multiple - 1) // lane_multiple) * lane_multiple
    native = _native()
    if block_m is None:
        # ~256 MB of block temporaries (the NumPy twin's (N, block_m) dense
        # block).
        block_m = (1 << 28) // max(N, 1)
    block_m = max(4, (block_m // 4) * 4)  # 4 SNPs = 1 packed byte column
    packed = np.zeros((N, m_pad // 4), dtype=np.uint8)
    for m0 in range(0, M, block_m):
        m1 = min(m0 + block_m, M)
        B_blk = np.ascontiguousarray(mm[m0:m1])
        # The final block carries the lane padding out to m_pad.
        w = (m_pad if m1 == M else m1) - m0
        pb = _bed_block_to_packed(B_blk, N, w, native)
        packed[:, m0 // 4:(m0 + w) // 4] = pb
        del B_blk, pb
    del mm

    if mean >= 1:
        for i in range(0, N, 4096):
            packed[i:i + 4096] = flip_packed_minor_allele(packed[i:i + 4096])
        rezero_flip_padding(packed, M)
    return packed, N, M

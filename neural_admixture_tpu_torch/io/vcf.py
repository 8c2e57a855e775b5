"""Built-in VCF genotype reader (no external dependencies), the JAX
package's io/vcf.py.

The reference reads VCFs with scikit-allel: the GT allele pair summed,
each missing allele as -1, a negative sum mapped to 3, the result
transposed to (samples, variants). This module reproduces those semantics
with a dependency-free parser (plain or gzip VCF); io/snp_reader.py prefers
scikit-allel when it is importable and falls back to this.
"""
import gzip
from typing import List, Tuple

import numpy as np

_PACK_BLOCK = 4096  # variants buffered per packing step (streaming reader)


def _open(path: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


def _gt_dosage(sample_field: str) -> int:
    """GT subfield -> summed allele dosage, matching scikit-allel's semantics
    exactly (the reference's reader): each missing
    allele contributes -1 and only a NEGATIVE total maps to missing (3).
    Hence './.' -> 3 but './1' -> 0 -- faithful to the reference, quirks
    included."""
    gt = sample_field.split(":", 1)[0]
    total = 0
    for allele in gt.replace("|", "/").split("/"):
        # strip() guards the last sample column of a CRLF VCF, where a
        # missing allele arrives as '.\r' (numeric alleles already parse
        # because int() tolerates surrounding whitespace).
        allele = allele.strip()
        total += -1 if allele in (".", "") else int(allele)
    if total < 0:
        return 3
    return min(total, 255)


def read_vcf(path: str) -> np.ndarray:
    """Parse a VCF into a (n_samples, n_variants) uint8 dosage matrix."""
    rows: List[List[int]] = []
    n_samples = None
    with _open(path) as f:
        for line in f:
            if line.startswith("##"):
                continue
            if line.startswith("#CHROM"):
                header = line.rstrip("\r\n").split("\t")
                if len(header) < 10:
                    raise ValueError("VCF has no sample columns")
                n_samples = len(header) - 9
                continue
            if not line.strip():
                continue
            if n_samples is None:
                raise ValueError("VCF data before #CHROM header")
            fields = line.rstrip("\r\n").split("\t")
            samples = fields[9:]
            if len(samples) != n_samples:
                raise ValueError(f"VCF row has {len(samples)} samples, "
                                 f"expected {n_samples}")
            rows.append([_gt_dosage(s) for s in samples])
    if n_samples is None:
        raise ValueError("Not a VCF file (no #CHROM header)")
    G = np.asarray(rows, dtype=np.uint8)  # (variants, samples)
    return np.ascontiguousarray(G.T)


def _stream_packed_cols(path: str, start: int, end, lane_multiple: int
                        ) -> Tuple[np.ndarray, int, int]:
    """Shared streaming core: parse sample columns [start, end) of a VCF
    straight into the sample-major 2-bit packed layout.

    ``end=None`` means all samples (resolved at the #CHROM header). One
    parsing pass, variant blocks packed as they arrive (the dense (N, M)
    uint8 matrix -- 100 GB at biobank scale -- never exists). For a
    proper column slice the tab-split is BOUNDED at the slice's last
    field (``split("\\t", 9 + end)``): fields past the slice stay one
    unsplit remainder whose tabs are only counted, so a multi-host read
    does O(slice) split work per host instead of O(N) (the total-column
    validation is count-based either way). Returns (packed rows of the
    slice, n_samples, M); no validation or allele flip here -- callers
    own those (they need global counts).

    Peak RESIDENT memory is the packed matrix plus one variant block; M
    need not be known in advance: packed column chunks are copied into
    the final array at the end, and although that array's VIRTUAL size
    briefly doubles the footprint, np.zeros commits pages lazily
    (calloc/mmap) while each chunk is freed right after its columns are
    copied, so committed pages stay ~flat through the loop.
    """
    from .packed import packed_width

    n_samples = None
    chunks: List[np.ndarray] = []          # packed column chunks, (n, w_i)
    block: List[List[int]] = []            # pending variant dosage rows
    M = 0

    def _flush():
        nonlocal block
        if not block:
            return
        gb = np.asarray(block, dtype=np.uint8).T  # (n_local, vb)
        if gb.max(initial=0) > 3:
            raise ValueError("Only biallelic SNPs are supported. Please make "
                             "sure multiallelic sites have been removed.")
        vb4 = -(-gb.shape[1] // 4) * 4
        if vb4 != gb.shape[1]:
            gb = np.concatenate(
                [gb, np.zeros((gb.shape[0], vb4 - gb.shape[1]), np.uint8)],
                axis=1)
        g4 = gb.reshape(gb.shape[0], vb4 // 4, 4)
        chunks.append(np.ascontiguousarray(
            g4[:, :, 0] | (g4[:, :, 1] << 2)
            | (g4[:, :, 2] << 4) | (g4[:, :, 3] << 6)))
        block = []

    with _open(path) as f:
        for line in f:
            if line.startswith("##"):
                continue
            if line.startswith("#CHROM"):
                header = line.rstrip("\r\n").split("\t")
                if len(header) < 10:
                    raise ValueError("VCF has no sample columns")
                n_samples = len(header) - 9
                if end is None:
                    end = n_samples
                if not 0 <= start <= end <= n_samples:
                    raise ValueError(f"sample columns [{start}, {end}) are "
                                     f"not within [0, {n_samples})")
                continue
            if not line.strip():
                continue
            if n_samples is None:
                raise ValueError("VCF data before #CHROM header")
            fields = line.rstrip("\r\n").split("\t", 9 + end)
            ncols = len(fields)
            if ncols == 9 + end + 1:
                # the unsplit remainder holds the columns past the slice
                ncols = 9 + end + 1 + fields[-1].count("\t")
            if ncols - 9 != n_samples:
                raise ValueError(
                    f"VCF row has {ncols - 9} samples, "
                    f"expected {n_samples}")
            block.append([_gt_dosage(s)
                          for s in fields[9 + start:9 + end]])
            M += 1
            # Flush only at byte (4-variant) boundaries so chunks
            # concatenate without bit-level splicing.
            if len(block) == _PACK_BLOCK:
                _flush()
    if n_samples is None:
        raise ValueError("Not a VCF file (no #CHROM header)")
    _flush()
    m_pad = ((M + lane_multiple - 1) // lane_multiple) * lane_multiple
    packed = np.zeros((end - start, packed_width(m_pad)), np.uint8)
    w = 0
    while chunks:
        c = chunks.pop(0)
        packed[:, w:w + c.shape[1]] = c
        w += c.shape[1]
    return packed, n_samples, M


def read_vcf_packed(path: str, lane_multiple: int = 2048
                    ) -> Tuple[np.ndarray, int, int]:
    """Stream a VCF straight into the sample-major 2-bit packed layout.

    Same contract as io/bed.py read_bed_packed / io/pgen.py read_pgen_packed:
    the one-pass streaming parse/pack (_stream_packed_cols, full column
    slice), then validation and the minor-allele flip in the packed
    domain. Returns (packed (N, W) uint8, N, M).
    """
    from .bed import (flip_packed_minor_allele, packed_code_counts,
                      rezero_flip_padding)

    packed, n_samples, M = _stream_packed_cols(path, 0, None, lane_multiple)
    counts = packed_code_counts(packed, M)
    if not (counts[0] > 0 and (counts[2] > 0 or counts[3] > 0)):
        raise ValueError("Only biallelic SNPs are supported. Please make sure "
                         "multiallelic sites have been removed.")
    mean = float((counts * np.arange(4)).sum()) / max(1, int(counts.sum()))
    if mean >= 1:
        packed = rezero_flip_padding(flip_packed_minor_allele(packed), M)
    return packed, n_samples, M


def vcf_dims(path: str) -> Tuple[int, int]:
    """(n_samples, n_variants) of a VCF without parsing genotypes.

    One cheap pass: N from the #CHROM header's column count, M from the
    number of non-empty data lines (no field splitting)."""
    n_samples, M = None, 0
    with _open(path) as f:
        for line in f:
            if line.startswith("##"):
                continue
            if line.startswith("#CHROM"):
                header = line.rstrip("\r\n").split("\t")
                if len(header) < 10:
                    raise ValueError("VCF has no sample columns")
                n_samples = len(header) - 9
                continue
            if n_samples is None and line.strip():
                raise ValueError("VCF data before #CHROM header")
            if line.strip():
                M += 1
    if n_samples is None:
        raise ValueError("Not a VCF file (no #CHROM header)")
    return n_samples, M


def read_vcf_packed_rows(path: str, start: int, end: int,
                         lane_multiple: int = 2048
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Parse only sample COLUMNS [start, end) into the packed row layout.

    The per-host VCF input path, mirroring io/bed.py read_bed_packed_rows
    and io/pgen.py read_pgen_packed_rows: no validation or minor-allele
    flip (both need global counts); returns (packed_rows,
    local_code_counts). Samples are columns in a VCF, so each host makes
    one streaming pass (_stream_packed_cols) whose tab-split is BOUNDED at
    its own column slice: per-host parse work is O(slice), not O(N).
    """
    from .bed import packed_code_counts

    packed, _, M = _stream_packed_cols(path, start, end, lane_multiple)
    return packed, packed_code_counts(packed, M)

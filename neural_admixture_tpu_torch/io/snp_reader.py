"""Dense genotype reading with the reference's normalisation (the JAX
package's io/snp_reader.py):

  * dispatch on the file suffix (.bed / .pgen / .vcf); any other suffix
    logs the reference's error and exits 1;
  * validate biallelic coding: min == 0 and max in (2, 3);
  * flip to minor-allele coding when the matrix-wide mean (missing
    included, as in the reference) is >= 1.

The reference flips with ``2 - G`` on uint8, which turns missing genotypes
(3) into 255; as in the JAX package, missing stays 3 under the flip (on
data without missing genotypes the outputs are identical).

The training and inference entry points read through the packed readers
(io/bed.py, io/pgen.py, io/vcf.py); this dense path serves what the
reference's API returns, an (N, M) uint8 matrix.
"""
import sys
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from ..utils.logger import log, setup_logging
from .bed import read_bed


def input_format(file: str) -> Optional[str]:
    """"BED", "PGEN" or "VCF" by the suffixes of ``file`` (in that order,
    as the reference dispatches), None for any other."""
    suffixes = Path(file).suffixes
    for suffix, name in ((".bed", "BED"), (".pgen", "PGEN"), (".vcf", "VCF")):
        if suffix in suffixes:
            return name
    return None


def exit_unrecognized() -> None:
    """Log the reference's error for an unknown suffix and exit 1."""
    setup_logging()
    log.error("    Invalid format. Unrecognized file format. Make sure file "
              "ends with .bed, .pgen or .vcf .")
    sys.exit(1)


class SNPReader:
    """Reads genotype data from BED / PGEN / VCF into (N, M) uint8 dosages."""

    def _read_bed(self, file: str) -> np.ndarray:
        log.info("    Input format is BED.")
        return read_bed(file)

    def _read_pgen(self, file: str) -> np.ndarray:
        log.info("    Input format is PGEN.")
        from .pgen import read_pgen
        try:
            return read_pgen(file)
        except NotImplementedError as exc:
            log.error(f"    {exc}")
            sys.exit(1)

    def _read_vcf(self, file: str) -> np.ndarray:
        log.info("    Input format is VCF.")
        try:
            import allel
        except ImportError:
            from .vcf import read_vcf  # built-in dependency-free parser
            return read_vcf(file)
        calls = allel.read_vcf(file, fields=["calldata/GT"],
                               fills={"calldata/GT": -1})["calldata/GT"]
        # Dosage = allele-code sum with missing alleles as -1; a negative
        # sum (fully missing call, or half-missing with a ref allele)
        # becomes 3. Not to_n_alt: that would remap half-missing calls
        # ('./1' -> 3 instead of 0) and multiallelic codes ('2/2' -> 2,
        # evading the biallelic check) away from the reference.
        dosage = calls.astype(np.int16).sum(axis=2)  # (M, N)
        dosage[dosage < 0] = 3
        return np.ascontiguousarray(dosage.T).astype(np.uint8)

    def read_data(self, file: str) -> np.ndarray:
        fmt = input_format(file)
        if fmt is None:
            exit_unrecognized()
        G = {"BED": self._read_bed, "PGEN": self._read_pgen,
             "VCF": self._read_vcf}[fmt](file)
        if not (int(G.min()) == 0 and int(G.max()) in (2, 3)):
            raise ValueError("Only biallelic SNPs are supported. Please make "
                             "sure multiallelic sites have been removed.")
        if G.mean() >= 1:
            missing = G == 3
            G = (2 - G.astype(np.int16)).astype(np.uint8)
            G[missing] = 3
        return G


def read_data(tr_file: str, tr_pops_f: Optional[str] = None
              ) -> Tuple[np.ndarray, Optional[List[str]], int, int]:
    """Genotypes (N, M) uint8, the per-sample population labels of
    ``tr_pops_f`` (or None), N and M."""
    setup_logging()
    data = SNPReader().read_data(tr_file)
    log.info(f"    Data contains {data.shape[0]} samples and "
             f"{data.shape[1]} SNPs.")
    if tr_pops_f:
        log.info("    Population file provided!")
        with open(tr_pops_f, "r") as fb:
            pops = [p.strip() for p in fb.readlines()]
    else:
        pops = None
    return data, pops, data.shape[0], data.shape[1]

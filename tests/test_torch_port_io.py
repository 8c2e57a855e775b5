"""Host I/O of the PyTorch port against the JAX package: BED decoding, 2-bit
packing, minor-allele flip, code counts, the u32 view and the missing check
must give identical bytes and values on the same inputs."""
import shutil

import numpy as np
import pytest

from neural_admixture_tpu.io import bed as jbed
from neural_admixture_tpu.io import packed as jpacked
from neural_admixture_tpu.ops import pack as jpk
from neural_admixture_tpu_torch.io import bed as tbed
from neural_admixture_tpu_torch.io import packed as tpacked
from neural_admixture_tpu_torch.ops import pack as tpk
from tests.conftest import DEMO_BED


@pytest.mark.parametrize("block_m", [None, 1000])
def test_read_bed_packed_demo_byte_identical(block_m):
    want, n_w, m_w = jbed.read_bed_packed(DEMO_BED, block_m=block_m)
    got, n_g, m_g = tbed.read_bed_packed(DEMO_BED, block_m=block_m)
    assert (n_g, m_g) == (n_w, m_w) == (105, 8451)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_read_bed_dims_skips_blank_fam_lines(tmp_path):
    for ext in (".bed", ".bim"):
        shutil.copy(DEMO_BED[:-4] + ext, tmp_path / f"d{ext}")
    with open(DEMO_BED[:-4] + ".fam") as f:
        fam = f.read()
    (tmp_path / "d.fam").write_text(fam.rstrip("\n") + "\n\n  \n")
    path = str(tmp_path / "d.bed")
    assert tbed.read_bed_dims(path) == jbed.read_bed_dims(path) == (105, 8451)


def test_decode_and_code_counts_match():
    B, N, M = jbed.read_bed_bytes(DEMO_BED)
    np.testing.assert_array_equal(tbed.decode_bed_numpy(B, N),
                                  jbed.decode_bed_numpy(B, N))
    np.testing.assert_array_equal(tbed.bed_code_counts(B, N),
                                  jbed.bed_code_counts(B, N))
    packed, _, _ = jbed.read_bed_packed(DEMO_BED)
    np.testing.assert_array_equal(tbed.packed_code_counts(packed, M),
                                  jbed.packed_code_counts(packed, M))


@pytest.mark.parametrize("M", [1, 3, 4, 7, 2048, 2051])
def test_pack_unpack_byte_identical(M):
    rng = np.random.default_rng(M)
    G = rng.integers(0, 4, size=(9, M)).astype(np.uint8)
    assert tpacked.packed_width(M) == jpacked.packed_width(M)
    for m_pad in (0, M + 10):
        got = tpacked.pack_2bit_rows(G, m_pad=m_pad)
        np.testing.assert_array_equal(got,
                                      jpacked.pack_2bit_rows(G, m_pad=m_pad))
        np.testing.assert_array_equal(tpacked.unpack_2bit_rows(got, M), G)
        np.testing.assert_array_equal(tpacked.unpack_2bit_rows(got, M),
                                      jpacked.unpack_2bit_rows(got, M))
    for lane in (2048, 16):
        got, m_got = tpacked.pack_with_padding(G, lane_multiple=lane)
        want, m_want = jpacked.pack_with_padding(G, lane_multiple=lane)
        assert m_got == m_want
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("M", [2048, 2051, 4093])
def test_flip_and_rezero_match(M):
    rng = np.random.default_rng(M)
    G = rng.integers(0, 4, size=(11, M)).astype(np.uint8)
    packed, _ = jpacked.pack_with_padding(G)
    got = tbed.flip_packed_minor_allele(packed)
    want = jbed.flip_packed_minor_allele(packed)
    np.testing.assert_array_equal(got, want)
    got = tbed.rezero_flip_padding(got.copy(), M)
    want = jbed.rezero_flip_padding(want.copy(), M)
    np.testing.assert_array_equal(got, want)
    flipped = tpacked.unpack_2bit_rows(got, packed.shape[1] * 4)
    np.testing.assert_array_equal(flipped[:, M:], 0)
    np.testing.assert_array_equal(flipped[:, :M],
                                  np.where(G == 3, 3, 2 - G.astype(int)))


@pytest.mark.parametrize("missing", [True, False])
def test_u32_view_and_missing_check_match(missing):
    rng = np.random.default_rng(7)
    G = rng.integers(0, 4 if missing else 3, size=(13, 3000)).astype(np.uint8)
    packed, _ = jpacked.pack_with_padding(G)
    np.testing.assert_array_equal(tpk.packed_view_u32(packed),
                                  jpk.packed_view_u32(packed))
    # blocks of 2 rows and of all rows
    for block_bytes in (2 * packed.shape[1], 1 << 24):
        assert tpk.packed_has_missing(packed, block_bytes) == missing
    assert jpk.packed_has_missing(packed, block_rows=4) == missing


def test_u32_view_rejects_ragged_width():
    with pytest.raises(ValueError, match="multiple of 4"):
        tpk.packed_view_u32(np.zeros((2, 3), np.uint8))

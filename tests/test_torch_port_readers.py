"""The port's readers (neural_admixture_tpu_torch/io: bed, pgen,
pgen_standard, vcf, snp_reader) against the JAX package's on the same
files, built in tmp_path by the JAX package's writers from numpy seeds:
the packed bytes, N and M, the per-host row reads and their code counts,
the dense matrices, every PGEN layout through the native and the pure
decoder, the same exceptions on bad files, the writers byte for byte, the
pgenlib and scikit-allel branches through fake modules, the dense
supervised init, and the port's CLI on PGEN and VCF against its BED run.

Where the JAX package rejects data with an AssertionError (the biallelic
check, a bad row range), the port raises a ValueError with the same
message: its checks do not vanish under ``python -O``."""
import gzip
import logging
import shutil
import sys
import types

import numpy as np
import pytest

from neural_admixture_tpu.io import bed as jbed
from neural_admixture_tpu.io import pgen as jpgen
from neural_admixture_tpu.io import pgen_standard as jstd
from neural_admixture_tpu.io import snp_reader as jsnp
from neural_admixture_tpu.io import vcf as jvcf
from neural_admixture_tpu.train import init as jinit
from neural_admixture_tpu_torch import entry as tentry
from neural_admixture_tpu_torch.io import bed as tbed
from neural_admixture_tpu_torch.io import pgen as tpgen
from neural_admixture_tpu_torch.io import pgen_standard as tstd
from neural_admixture_tpu_torch.io import snp_reader as tsnp
from neural_admixture_tpu_torch.io import vcf as tvcf
from neural_admixture_tpu_torch.io.packed import pack_2bit_rows
from neural_admixture_tpu_torch.native import bed_native
from neural_admixture_tpu_torch.train import init as tinit
from tests.test_pgen import _geno, _geno_mode16
from tests.test_pgen_fuzz import DIMS, REJECT, _fixture, _mutate

BIALLELIC = "Only biallelic SNPs are supported"
FORMAT_ERROR = ("    Invalid format. Unrecognized file format. Make sure file "
                "ends with .bed, .pgen or .vcf .")  # the JAX package's
GT = {0: "0/0", 1: "0/1", 2: "1/1", 3: "./."}


def _bed_bytes(G):
    """BED bytes (M, ceil(N/4)) of dosages G (N, M)."""
    return pack_2bit_rows(np.array([3, 2, 0, 1], np.uint8)[G.T])


def _write_bed(path, G):
    """A .bed/.fam fileset of dosages G (N, M); returns the .bed path."""
    with open(path, "wb") as fh:
        fh.write(b"\x6c\x1b\x01" + _bed_bytes(G).tobytes())
    path.with_suffix(".fam").write_text(
        "".join(f"f{i} s{i} 0 0 0 -9\n" for i in range(G.shape[0])))
    return str(path)


def _vcf_text(G, eol="\n"):
    n, m = G.shape
    header = "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t" + \
        "\t".join(f"S{i}" for i in range(n))
    lines = ["##fileformat=VCFv4.2", header]
    for v in range(m):
        lines.append(f"1\t{v}\trs{v}\tA\tG\t50\tPASS\t.\tGT\t"
                     + "\t".join(GT[int(G[s, v])] for s in range(n)))
    return eol.join(lines) + eol


def _same_or_same_rejection(jax_fn, port_fn):
    """Both give equal arrays (or tuples of them), or both reject: the JAX
    package's AssertionError is the port's ValueError, other exceptions
    must be of one type."""
    try:
        want = jax_fn()
    except AssertionError as exc:
        with pytest.raises(ValueError) as info:
            port_fn()
        assert (BIALLELIC in str(exc)) == (BIALLELIC in str(info.value))
        return None
    except REJECT as exc:
        with pytest.raises(type(exc)):
            port_fn()
        return None
    got = port_fn()
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w
    return got


@pytest.fixture(params=["native", "pure"])
def decoder(request, monkeypatch):
    """The port's PGEN record decoder: the native library, or the
    pure-Python path (the library's PGEN symbol switched off)."""
    if request.param == "pure":
        monkeypatch.setattr(bed_native, "pgen_available", lambda: False)
    else:
        assert bed_native.pgen_available()
    return request.param


# ---------------------------------- BED ------------------------------------


@pytest.mark.parametrize("path_native", [True, False])
@pytest.mark.parametrize("N,M,flip,block_m", [
    (37, 210, False, None), (37, 210, True, 20), (5, 3, True, None),
    (130, 2051, False, 1000), (4, 4096, True, 4)])
def test_bed_readers_match_jax(tmp_path, monkeypatch, path_native, N, M,
                               flip, block_m):
    """read_bed_packed (natively and through the NumPy twin, in SNP
    blocks), read_bed_packed_rows, read_bed and read_bed_bytes."""
    if not path_native:
        monkeypatch.setattr(bed_native, "available", lambda: False)
    G = _geno(N=N, M=M, seed=N + M, flip=flip)
    path = _write_bed(tmp_path / "g.bed", G)
    bed_native.reset_calls()
    _same_or_same_rejection(
        lambda: jbed.read_bed_packed(path, block_m=block_m),
        lambda: tbed.read_bed_packed(path, block_m=block_m))
    for start, end in ((0, N), (1, N - 1), (N // 2, N // 2), (3, min(N, 9))):
        if start <= end:
            _same_or_same_rejection(
                lambda: jbed.read_bed_packed_rows(path, start, end),
                lambda: tbed.read_bed_packed_rows(path, start, end))
    _same_or_same_rejection(lambda: jbed.read_bed(path),
                            lambda: tbed.read_bed(path))
    _same_or_same_rejection(lambda: jbed.read_bed_bytes(path),
                            lambda: tbed.read_bed_bytes(path))
    calls = bed_native.call_counts()
    if path_native:
        assert calls["bed_to_packed"] >= 5 and calls["decode_bed"] == 1
    else:
        assert set(calls.values()) == {0}


def test_bed_row_range_and_magic_rejections(tmp_path):
    G = _geno(N=9, M=20)
    path = _write_bed(tmp_path / "g.bed", G)
    with pytest.raises(ValueError, match="rows"):
        tbed.read_bed_packed_rows(path, 5, 10)
    with pytest.raises(AssertionError):
        jbed.read_bed_packed_rows(path, 5, 10)
    raw = bytearray((tmp_path / "g.bed").read_bytes())
    for i, byte, match in ((0, 0, "magic"), (2, 0, "SNP-major")):
        bad = raw.copy()
        bad[i] = byte
        (tmp_path / "g.bed").write_bytes(bytes(bad))
        for fn in (jbed.read_bed_packed, tbed.read_bed_packed,
                   jbed.read_bed_bytes, tbed.read_bed_bytes):
            with pytest.raises(ValueError, match=match):
                fn(path)


# ---------------------------------- PGEN -----------------------------------


def _mode1(tmp_path, G):
    """Mode 0x01: the 3 magic bytes and a BED body; N from the .psam."""
    path = tmp_path / "m1.pgen"
    path.write_bytes(b"\x6c\x1b\x01" + _bed_bytes(G).tobytes())
    (tmp_path / "m1.psam").write_text(
        "#IID\n" + "".join(f"s{i}\n" for i in range(G.shape[0])))
    return str(path)


def _aux_tracks(tmp_path, G):
    """8-bit vrtypes with high (track) bits set and junk bytes appended to
    each record, inside its length (tests/test_pgen.py's fixture)."""
    path = str(tmp_path / "aux.pgen")
    jstd.write_pgen_standard(path, G)
    raw = bytearray(open(path, "rb").read())
    M = G.shape[1]
    idx0 = 12 + 8
    vrt, lens = raw[idx0:idx0 + M], raw[idx0 + M:idx0 + 2 * M]
    out, pos = bytearray(raw[:idx0 + 2 * M]), idx0 + 2 * M
    for v in range(M):
        out += raw[pos:pos + lens[v]] + b"\xAB" * (v % 3)
        pos += lens[v]
        out[idx0 + v] = vrt[v] | 0x30
        out[idx0 + M + v] = lens[v] + v % 3
    aux = str(tmp_path / "aux2.pgen")
    open(aux, "wb").write(bytes(out))
    return aux


def _onebit(tmp_path, _G):
    """A hand-made onebit record (C = (1 << 2) | 2: values {1, 3}), then
    empty difflists against all hom-alt and all missing."""
    recs = [bytes([0x06, 0b00000101, 0x00]), bytes([0x00]), bytes([0x00])]
    path = tmp_path / "onebit.pgen"
    with open(path, "wb") as fh:
        fh.write(b"\x6c\x1b\x10" + np.asarray([3, 5], "<u4").tobytes()
                 + bytes([0x04]))
        fh.write(np.asarray([12 + 8 + 3 + 3], "<u8").tobytes())
        fh.write(bytes([1, 6, 7]) + bytes(len(r) for r in recs))
        for r in recs:
            fh.write(r)
    return str(path)


def _wide(n):
    def make(tmp_path, _G):
        rng = np.random.default_rng(n)
        G = np.zeros((n, 40), np.uint8)
        for v in range(40):
            if v % 3 == 0:  # a difflist of more than one 64-id group
                idx = rng.choice(n, size=max(65, n // 3), replace=False)
                G[idx, v] = rng.integers(1, 4, idx.size)
            elif v % 3 == 1:  # few ids, deltas >= 128: multi-byte vints
                idx = np.sort(rng.choice(n, size=3, replace=False))
                G[idx, v] = rng.integers(1, 4, 3)
            else:
                G[:, v] = rng.integers(0, 4, n)
        path = str(tmp_path / f"wide{n}.pgen")
        jstd.write_pgen_standard(path, G)
        return path
    return make


def _std(**kw):
    def make(tmp_path, G):
        path = str(tmp_path / "std.pgen")
        jstd.write_pgen_standard(path, G, **kw)
        return path
    return make


LAYOUTS = {
    "0x01": _mode1,
    "0x02": lambda tmp_path, G: (
        jpgen.write_pgen_mode2(str(tmp_path / "m2.pgen"), G),
        str(tmp_path / "m2.pgen"))[1],
    "0x10_idx0": _std(idx_enc=0),
    "0x10_idx4": _std(idx_enc=4),
    "0x10_idx5": _std(idx_enc=5),
    "0x10_no_ld": _std(ld_chain=False),
    "0x10_multiblock": _std(),  # VBLOCK 64 below
    "0x10_nonref1": _std(nonref_code=1),
    "0x10_nonref3_ac2": _std(nonref_code=3, allele_ct_bytes=2),
    "0x10_ac1": _std(allele_ct_bytes=1),
    "0x10_aux_tracks": _aux_tracks,
    "0x10_onebit": _onebit,
    "0x10_wide255": _wide(255),
    "0x10_wide256": _wide(256),
    "0x10_wide257": _wide(257),
    "0x10_wide700": _wide(700),
    "0x10_wide1500": _wide(1500),
    "storage8": _std(fixed_width=True),
    "storage8_0x11": _std(fixed_width=True, mode=0x11),
    "0x11": _std(mode=0x11),
    "0x11_idx0_multiblock": _std(mode=0x11, idx_enc=0),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_pgen_layouts_match_jax(tmp_path, monkeypatch, decoder, layout):
    """Every PGEN layout: the packed read (blocks of 64 variants), the
    per-host row reads with their counts, the dense read and the dims give
    the JAX package's bytes, through the port's native and pure decoders;
    the native calls are counted."""
    for mod in (jpgen, tpgen):
        monkeypatch.setattr(mod, "_BLOCK_VARIANTS", 64)
    if "multiblock" in layout:
        for mod in (jstd, tstd):
            monkeypatch.setattr(mod, "VBLOCK", 64)
    G = _geno_mode16(N=53, M=300, seed=len(layout))
    path = LAYOUTS[layout](tmp_path, G)
    bed_native.reset_calls()
    dense = _same_or_same_rejection(lambda: jpgen.read_pgen(path),
                                    lambda: tpgen.read_pgen(path))
    N, M = tpgen.pgen_dims(path)
    assert (N, M) == jpgen.pgen_dims(path) == dense.shape
    _same_or_same_rejection(lambda: jpgen.read_pgen_packed(path),
                            lambda: tpgen.read_pgen_packed(path))
    for start, end in ((0, N), (N // 3, N - 2), (N, N)):
        _same_or_same_rejection(
            lambda: jpgen.read_pgen_packed_rows(path, start, end),
            lambda: tpgen.read_pgen_packed_rows(path, start, end))
    if layout in ("0x01", "0x02"):
        np.testing.assert_array_equal(dense, G)
    compressed = layout not in ("0x01", "0x02")
    assert (bed_native.pgen_decode.calls > 0) == (
        compressed and decoder == "native")


def test_pgen_random_access_rebuilds_the_ld_state(tmp_path, decoder):
    """Blocks read in order carry the LD base across calls; a read that
    starts on an LD variant, or goes backwards, rewinds to the nearest
    non-LD variant. The port's StandardPgen matches the JAX package's on
    every call of one sequence."""
    G = _geno_mode16(N=41, M=250, seed=9)
    path = str(tmp_path / "ra.pgen")
    vrtypes = jstd.write_pgen_standard(path, G)
    ld = [v for v in range(100, 200) if (vrtypes[v] & 7) in (2, 3)]
    assert ld
    calls = [(0, 64), (64, 128), (128, 250), (ld[0], ld[0] + 40), (10, 30),
             (ld[-1], 250), (ld[-1], ld[-1] + 1), (0, 250)]
    r_port, r_jax = tstd.StandardPgen(path), jstd.StandardPgen(path)
    for v0, v1 in calls:
        got = r_port.read_block(v0, v1)
        np.testing.assert_array_equal(got, r_jax.read_block(v0, v1))
        np.testing.assert_array_equal(got.T, G[:, v0:v1])


def _bad_pgen(kind, tmp_path):
    """A malformed PGEN of ``kind``; returns its path."""
    path = tmp_path / "bad.pgen"
    G = _geno(N=17, M=40, seed=2)
    if kind == "bad_magic":
        path.write_bytes(b"\x00\x00\x02" + b"\x00" * 16)
    elif kind == "unknown_mode":
        path.write_bytes(b"\x6c\x1b\x20" + b"\x00" * 64)
    elif kind == "truncated_0x02":
        jpgen.write_pgen_mode2(str(path), G)
        path.write_bytes(path.read_bytes()[:-3])
    elif kind == "truncated_0x01":
        _mode1(tmp_path, G)
        raw = (tmp_path / "m1.pgen").read_bytes()
        shutil.move(str(tmp_path / "m1.psam"), str(tmp_path / "bad.psam"))
        path.write_bytes(raw[:-1])
    elif kind == "no_psam_0x01":
        path.write_bytes(b"\x6c\x1b\x01" + _bed_bytes(G).tobytes())
    elif kind == "truncated_storage8":
        path.write_bytes(b"\x6c\x1b\x10" + np.asarray([1, 4], "<u4")
                         .tobytes() + bytes([0x88]))
    elif kind == "storage9":
        path.write_bytes(b"\x6c\x1b\x10" + np.asarray([1, 4], "<u4")
                         .tobytes() + bytes([0x09]))
    elif kind == "truncated_0x10_records":
        jstd.write_pgen_standard(str(path), _geno_mode16(N=29, M=60))
        path.write_bytes(path.read_bytes()[:-5])
    elif kind == "truncated_0x10_header":
        path.write_bytes(b"\x6c\x1b\x10" + b"\x01\x00")
    elif kind == "missing_pgi":
        jstd.write_pgen_standard(str(path), G, mode=0x11)
        (tmp_path / "bad.pgen.pgi").unlink()
    elif kind == "impossible_variant_count":
        jstd.write_pgen_standard(str(path), G)
        raw = bytearray(path.read_bytes())
        raw[3:7] = np.asarray([10 ** 8], "<u4").tobytes()
        path.write_bytes(bytes(raw))
    return str(path)


@pytest.mark.parametrize("kind", [
    "bad_magic", "unknown_mode", "truncated_0x02", "truncated_0x01",
    "no_psam_0x01", "truncated_storage8", "storage9",
    "truncated_0x10_records", "truncated_0x10_header", "missing_pgi",
    "impossible_variant_count"])
def test_bad_pgen_raises_as_in_jax(tmp_path, kind):
    """Bad magic, an unknown mode, truncated files and a missing index
    raise the JAX package's exception type, with its message."""
    path = _bad_pgen(kind, tmp_path)
    for fn in ("read_pgen_packed", "read_pgen", "pgen_dims"):
        with pytest.raises(Exception) as want:
            getattr(jpgen, fn)(path)
        with pytest.raises(type(want.value)) as got:
            getattr(tpgen, fn)(path)
        assert str(got.value) == str(want.value)


def _decode_all(reader_mod, path, how):
    """(outcome, bytes) of decoding every variant of ``path`` with the
    StandardPgen of ``reader_mod``: 'pure' (the per-variant decoder),
    'native' (the C++ block decoder) or 'public' (read_block, native with
    the pure path behind it)."""
    try:
        r = reader_mod.StandardPgen(path)
        if how == "pure":
            out = np.empty((r.M, r.N), np.uint8)
            with open(r.path, "rb") as fh:
                for v in range(r.M):
                    out[v] = r._decode_one(fh, v)
        elif how == "native":
            out = r._read_block_native(bed_native, 0, r.M)
        else:
            out = r.read_block(0, r.M)
        return "ok", out.tobytes()
    except REJECT:
        return "reject", None


@pytest.mark.parametrize("fixture_kw", [
    {}, {"idx_enc": 0}, {"nonref_code": 3}, {"fixed_width": True},
    {"fixed_width": True, "mode": 0x11}])
def test_pgen_decoders_agree_on_mutated_records(tmp_path, fixture_kw):
    """Corrupted files (bit flips, truncations, scrambles, junk, bad record
    lengths; tests/test_pgen_fuzz.py's mutations): the port's pure and
    native decoders and its public read_block agree with the JAX package's
    decoder on every file, the same bytes or the same rejection."""
    import os
    path, G = _fixture(tmp_path, **fixture_kw)
    raw = open(path, "rb").read()
    assert _decode_all(tstd, path, "native") == \
        ("ok", np.ascontiguousarray(G.T).tobytes())
    rng = np.random.default_rng(4321)
    mut_path = str(tmp_path / "mut.pgen")
    if os.path.exists(path + ".pgi"):
        shutil.copy(path + ".pgi", mut_path + ".pgi")
    outcomes = []
    for trial in range(200):
        with open(mut_path, "wb") as fh:
            fh.write(_mutate(rng, raw, trial % 5))
        want = _decode_all(jstd, mut_path, "pure")
        for how in ("pure", "native", "public"):
            assert _decode_all(tstd, mut_path, how) == want, (trial, how)
        outcomes.append(want[0])
    assert outcomes.count("reject") > 20 and outcomes.count("ok") > 5
    assert DIMS == (29, 60)


def test_wrapping_difflist_deltas_reject_in_every_decoder(tmp_path):
    """Four 2^62 deltas wrap the running sample id back in bounds: every
    decoder rejects the record cleanly."""
    rec = bytes([5, 0, 0b01010101, 0b00000001]) + \
        (b"\x80" * 8 + b"\x40") * 4
    path = str(tmp_path / "wrap.pgen")
    with open(path, "wb") as fh:
        fh.write(b"\x6c\x1b\x10" + np.asarray([1, 100], "<u4").tobytes()
                 + bytes([0x04]) + np.asarray([22], "<u8").tobytes()
                 + bytes([4, len(rec)]) + rec)
    assert _decode_all(jstd, path, "pure") == ("reject", None)
    for how in ("pure", "native", "public"):
        assert _decode_all(tstd, path, how) == ("reject", None)


@pytest.mark.parametrize("kw", [
    {}, {"idx_enc": 0}, {"idx_enc": 1}, {"idx_enc": 5}, {"idx_enc": 7},
    {"ld_chain": False}, {"nonref_code": 3, "allele_ct_bytes": 2},
    {"nonref_code": 1, "allele_ct_bytes": 1}, {"mode": 0x11},
    {"mode": 0x11, "idx_enc": 0}, {"fixed_width": True},
    {"fixed_width": True, "mode": 0x11}, {"psam": False}, "mode2"])
def test_writers_match_jax_byte_for_byte(tmp_path, monkeypatch, kw):
    """write_pgen_standard (every option; two variant blocks) and
    write_pgen_mode2 write the JAX writers' files, .pgi and .psam
    included, and return the same record types."""
    for mod in (jstd, tstd):
        monkeypatch.setattr(mod, "VBLOCK", 128)
    G = _geno_mode16(N=45, M=200, seed=31)
    out = {}
    for tag, std, pg in (("jax", jstd, jpgen), ("port", tstd, tpgen)):
        d = tmp_path / tag
        d.mkdir()
        if kw == "mode2":
            out[tag] = pg.write_pgen_mode2(str(d / "w.pgen"), G)
        else:
            out[tag] = std.write_pgen_standard(str(d / "w.pgen"), G, **kw)
    assert out["port"] == out["jax"]
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name


def _fake_pgenlib(G):
    class FakePgenReader:
        def __init__(self, path_bytes):
            assert isinstance(path_bytes, bytes)

        def get_variant_ct(self):
            return G.shape[1]

        def get_raw_sample_ct(self):
            return G.shape[0]

        def read_range(self, v0, v1, out):
            block = G.T[v0:v1].astype(np.int8)
            block[block == 3] = -9
            out[:] = block

    fake = types.ModuleType("pgenlib")
    fake.PgenReader = FakePgenReader
    return fake


@pytest.mark.parametrize("flip", [False, True])
def test_pgenlib_branch_matches_jax(tmp_path, monkeypatch, flip):
    """With pgenlib importable (a fake module whose reader fills int8
    blocks with -9 for missing), both packages read through it: the same
    dense matrix (missing 3), packed rows and row reads."""
    G = _geno(N=11, M=40, flip=flip)
    monkeypatch.setitem(sys.modules, "pgenlib", _fake_pgenlib(G))
    for mod in (jpgen, tpgen):
        monkeypatch.setattr(mod, "_BLOCK_VARIANTS", 16)
    path = str(tmp_path / "any.pgen")
    assert isinstance(tpgen.open_pgen(path), tpgen._PgenlibPgen)
    dense = _same_or_same_rejection(lambda: jpgen.read_pgen(path),
                                    lambda: tpgen.read_pgen(path))
    np.testing.assert_array_equal(dense, G)
    _same_or_same_rejection(lambda: jpgen.read_pgen_packed(path),
                            lambda: tpgen.read_pgen_packed(path))
    _same_or_same_rejection(lambda: jpgen.read_pgen_packed_rows(path, 2, 9),
                            lambda: tpgen.read_pgen_packed_rows(path, 2, 9))


def test_compressed_pgen_without_pgenlib_logs_the_jax_warning(tmp_path,
                                                             caplog):
    path = str(tmp_path / "s.pgen")
    jstd.write_pgen_standard(path, _geno_mode16(N=20, M=30))
    caplog.set_level(logging.WARNING)
    assert isinstance(tpgen.open_pgen(path), tstd.StandardPgen)
    msgs = [r.getMessage() for r in caplog.records
            if r.name == "neural_admixture_tpu_torch"]
    assert len(msgs) == 1 and "pgenlib is not installed" in msgs[0] \
        and "mode-0x10" in msgs[0]


# ---------------------------------- VCF ------------------------------------

VCF_TEXT = """##fileformat=VCFv4.2
##INFO=<ID=DP,Number=1,Type=Integer,Description="Depth">
#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1\tS2\tS3
1\t100\trs1\tA\tG\t50\tPASS\t.\tGT:DP\t0/0:10\t0/1:12\t1/1:9
1\t200\trs2\tC\tT\t50\tPASS\t.\tGT\t0|1\t1|1\t0|0
1\t300\trs3\tG\tA\t50\tPASS\t.\tGT\t./.\t0/0\t1/0
"""


def _vcf_case(kind, tmp_path):
    if kind == "plain":
        p = tmp_path / "t.vcf"
        p.write_text(VCF_TEXT)
    elif kind == "gz":
        p = tmp_path / "t.vcf.gz"
        with gzip.open(p, "wt") as f:
            f.write(VCF_TEXT)
    elif kind == "crlf_missing_last":
        p = tmp_path / "crlf.vcf"
        p.write_bytes(VCF_TEXT.replace("\n", "\r\n").encode())
    elif kind == "half_missing":
        p = tmp_path / "half.vcf"
        p.write_text(VCF_TEXT + "1\t400\trs4\tT\tC\t50\tPASS\t.\tGT\t./1\t"
                     "1/.\t.|.\n")
    elif kind in ("random", "random_gz"):
        rng = np.random.default_rng(4)
        G = rng.integers(0, 3, size=(23, 170)).astype(np.uint8)
        G[rng.uniform(size=G.shape) < 0.04] = 3
        if kind == "random":
            p = tmp_path / "r.vcf"
            p.write_text(_vcf_text(G))
        else:
            p = tmp_path / "r.vcf.gz"
            with gzip.open(p, "wt") as f:
                f.write(_vcf_text(G, eol="\r\n"))
    elif kind == "flipped":
        G = np.random.default_rng(5).choice(
            [0, 1, 2, 2, 3], size=(9, 41)).astype(np.uint8)
        p = tmp_path / "f.vcf"
        p.write_text(_vcf_text(G))
    return str(p)


@pytest.mark.parametrize("kind", ["plain", "gz", "crlf_missing_last",
                                  "half_missing", "random", "random_gz",
                                  "flipped"])
def test_vcf_readers_match_jax(tmp_path, monkeypatch, kind):
    """read_vcf, read_vcf_packed (flushed every 8 variants), vcf_dims and
    read_vcf_packed_rows (column slices, the empty slice too) give the JAX
    package's results; './1' is 0 and './.' is 3 in both."""
    for mod in (jvcf, tvcf):
        monkeypatch.setattr(mod, "_PACK_BLOCK", 8)
    path = _vcf_case(kind, tmp_path)
    dense = _same_or_same_rejection(lambda: jvcf.read_vcf(path),
                                    lambda: tvcf.read_vcf(path))
    if kind == "half_missing":
        np.testing.assert_array_equal(dense[:, 3], [0, 0, 3])
    n, m = tvcf.vcf_dims(path)
    assert (n, m) == jvcf.vcf_dims(path) == dense.shape
    _same_or_same_rejection(lambda: jvcf.read_vcf_packed(path),
                            lambda: tvcf.read_vcf_packed(path))
    for start, end in ((0, n), (1, n - 1), (n // 2, n), (n, n)):
        _same_or_same_rejection(
            lambda: jvcf.read_vcf_packed_rows(path, start, end),
            lambda: tvcf.read_vcf_packed_rows(path, start, end))


@pytest.mark.parametrize("kind", ["headerless", "no_samples", "multiallelic",
                                  "short_row", "data_before_header",
                                  "bad_slice"])
def test_bad_vcf_rejected_as_in_jax(tmp_path, kind):
    p = tmp_path / "bad.vcf"
    header = "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT"
    text = {
        "headerless": "1\t100\trs1\tA\tG\t50\tPASS\t.\tGT\t0/0\n",
        "no_samples": header + "\n",
        "multiallelic": VCF_TEXT + "1\t400\trs4\tT\tC\t50\tPASS\t.\tGT\t2/2"
                                   "\t0/0\t0/0\n",
        "short_row": VCF_TEXT + "1\t400\trs4\tT\tC\t50\tPASS\t.\tGT\t0/0\n",
        "data_before_header": "1\t100\trs1\tA\tG\t50\tPASS\t.\tGT\t0/0\n"
                              + VCF_TEXT,
        "bad_slice": VCF_TEXT}[kind]
    p.write_text(text)
    path = str(p)
    rows = (2, 7) if kind == "bad_slice" else (0, 1)
    fns = [("read_vcf_packed", (path,)),
           ("read_vcf_packed_rows", (path, *rows))]
    if kind != "bad_slice":
        fns += [("read_vcf", (path,)), ("vcf_dims", (path,))]
    results = [_same_or_same_rejection(
        lambda: getattr(jvcf, fn)(*args), lambda: getattr(tvcf, fn)(*args))
        for fn, args in fns]
    # the packed read rejects every case, the row read a slice out of range
    assert results[1 if kind == "bad_slice" else 0] is None


# --------------------------- SNPReader, dense init -------------------------


def _fake_allel(calls):
    fake = types.ModuleType("allel")

    def read_vcf(file, fields, fills):
        assert fields == ["calldata/GT"] and fills == {"calldata/GT": -1}
        return {"calldata/GT": calls}

    fake.read_vcf = read_vcf
    return fake


@pytest.mark.parametrize("fmt", ["bed", "pgen", "vcf", "vcf_allel",
                                 "vcf_allel_multiallelic"])
def test_snp_reader_dispatches_and_flips_as_jax(tmp_path, monkeypatch,
                                                caplog, fmt):
    """SNPReader.read_data and read_data by suffix: the same matrix (the
    flip keeps missing at 3), labels and log lines as the JAX package; the
    scikit-allel branch through a fake module (allele sums, a negative sum
    is 3, '2/2' fails the biallelic check)."""
    G = _geno(N=13, M=30, seed=8, flip=True)
    if fmt == "bed":
        path = _write_bed(tmp_path / "g.bed", G)
    elif fmt == "pgen":
        path = str(tmp_path / "g.pgen")
        jpgen.write_pgen_mode2(path, G)
    else:
        path = str(tmp_path / "g.vcf")
        (tmp_path / "g.vcf").write_text(_vcf_text(G))
    if fmt.startswith("vcf_allel"):
        alleles = {0: (0, 0), 1: (0, 1), 2: (1, 1), 3: (-1, -1)}
        calls = np.array([[alleles[int(g)] for g in row] for row in G.T],
                         np.int8)
        calls[0, 0] = (-1, 1)  # half missing: sum 0
        if fmt.endswith("multiallelic"):
            calls[1, 1] = (2, 2)
        monkeypatch.setitem(sys.modules, "allel", _fake_allel(calls))
    pops = tmp_path / "pops.txt"
    pops.write_text("".join(f"P{i % 3}\n" for i in range(13)))
    caplog.set_level(logging.INFO)
    got = _same_or_same_rejection(
        lambda: jsnp.read_data(path, str(pops)),
        lambda: tsnp.read_data(path, str(pops)))
    lines = {name: [r.getMessage() for r in caplog.records if r.name == name]
             for name in ("neural_admixture_tpu",
                          "neural_admixture_tpu_torch")}
    assert lines["neural_admixture_tpu_torch"] == lines["neural_admixture_tpu"]
    if got is not None:
        assert got[2:] == (13, 30)
        miss = got[0] == 3
        if fmt in ("bed", "pgen", "vcf"):
            np.testing.assert_array_equal(miss, G == 3)
            np.testing.assert_array_equal(got[0][~miss], 2 - G[~miss])


@pytest.mark.parametrize("name", ["g.txt", "g.bim", "g"])
def test_unknown_suffix_exits_1_as_in_jax(tmp_path, caplog, name):
    path = str(tmp_path / name)
    caplog.set_level(logging.INFO)
    for mod in (jsnp, tsnp):
        with pytest.raises(SystemExit) as info:
            mod.SNPReader().read_data(path)
        assert info.value.code == 1
    msgs = [(r.levelno, r.getMessage()) for r in caplog.records]
    assert msgs == [(logging.ERROR, FORMAT_ERROR)] * 2


def test_pgen_mode_needing_pgenlib_exits_1_in_snp_reader(tmp_path):
    path = _bad_pgen("unknown_mode", tmp_path)
    for mod in (jsnp, tsnp):
        with pytest.raises(SystemExit) as info:
            mod.SNPReader().read_data(path)
        assert info.value.code == 1


@pytest.mark.parametrize("N,M,K", [(41, 53, 3), (7, 300, 2), (60, 9, 5)])
def test_init_p_supervised_matches_jax(N, M, K):
    rng = np.random.default_rng(N * M)
    G = rng.integers(0, 4, size=(N, M)).astype(np.uint8)
    y = rng.permutation(np.arange(N) % K)
    got = tinit.init_p_supervised(G, y, K)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jinit.init_p_supervised(G, y, K))
    np.testing.assert_allclose(
        got, tinit.init_p_supervised_packed(pack_2bit_rows(G), y, K, M),
        rtol=1e-6)


# ------------------------------ the port's CLI -----------------------------


@pytest.fixture(scope="module")
def cli_data(tmp_path_factory):
    """One data set as BED, mode-0x10 PGEN and gzipped VCF, and the port's
    CLI run on the BED: ``train`` (model "BED") and ``infer`` of it
    (``inf_BED``)."""
    d = tmp_path_factory.mktemp("cli")
    G = _geno(N=48, M=400, seed=12)
    paths = {"BED": _write_bed(d / "g.bed", G),
             "PGEN": str(d / "g.pgen"), "VCF": str(d / "g.vcf.gz")}
    jstd.write_pgen_standard(paths["PGEN"], G)
    with gzip.open(paths["VCF"], "wt") as f:
        f.write(_vcf_text(G))
    assert _train(d, paths["BED"], "BED") == 0
    assert _infer(d, paths["BED"], "inf_BED") == 0
    return d, paths


def _train(d, path, name):
    return tentry.main([
        "train", "--k", "3", "--data_path", path, "--save_dir", str(d),
        "--name", name, "--epochs", "2", "--seed", "42", "--batch_size",
        "16", "--hidden_size", "16", "--num_gpus", "0", "--no_progress"])


def _infer(d, path, out):
    return tentry.main([
        "infer", "--name", "BED", "--save_dir", str(d), "--data_path", path,
        "--out_name", out, "--num_gpus", "0"])


@pytest.mark.parametrize("fmt", ["PGEN", "VCF"])
def test_cli_train_and_infer_on_pgen_and_vcf_match_bed(cli_data, caplog,
                                                       fmt):
    """``train`` on the PGEN and on the gzipped VCF writes the .Q and .P of
    its run on the BED byte for byte, logging the input format before the
    data line; ``infer`` of the BED model on them writes the BED's .Q."""
    d, paths = cli_data
    caplog.set_level(logging.INFO)
    assert _train(d, paths[fmt], fmt) == 0
    lines = [r.getMessage() for r in caplog.records]
    i = lines.index(f"    Input format is {fmt}.")
    assert lines[i + 1:].index(
        "    Data contains 48 samples and 400 SNPs.") <= 1
    for m in ("Q", "P"):
        assert (d / f"{fmt}.3.{m}").read_bytes() == \
            (d / f"BED.3.{m}").read_bytes()
    assert _infer(d, paths[fmt], f"inf_{fmt}") == 0
    assert (d / f"inf_{fmt}.3.Q").read_bytes() == \
        (d / "inf_BED.3.Q").read_bytes()


@pytest.mark.parametrize("mode", ["train", "infer"])
def test_cli_unknown_suffix_exits_1(cli_data, caplog, mode):
    d, _ = cli_data
    path = str(d / "g.txt")
    caplog.set_level(logging.INFO)
    with pytest.raises(SystemExit) as info:
        if mode == "train":
            _train(d, path, "none")
        else:
            _infer(d, path, "none")
    assert info.value.code == 1
    assert (logging.ERROR, FORMAT_ERROR) in [
        (r.levelno, r.getMessage()) for r in caplog.records]
    assert not list(d.glob("none*"))

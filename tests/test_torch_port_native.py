"""The port's native host library (neural_admixture_tpu_torch/native) against
the JAX package's library and against the port's NumPy twins, on the same
inputs: every entry point byte for byte (the log-likelihood within 1e-12
relative), the library built into the port's own directory and never the
JAX package's, a library without the PGEN symbol, a failed build, and
concurrent builds."""
import logging
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from neural_admixture_tpu.io.pgen_standard import write_pgen_standard
from neural_admixture_tpu.native import bed_native as jnative
from neural_admixture_tpu_torch.io import bed as tbed
from neural_admixture_tpu_torch.io import packed as tpacked
from neural_admixture_tpu_torch.io.pgen_standard import (StandardPgen,
                                                         _sample_id_bytes)
from neural_admixture_tpu_torch.native import bed_native, build
from neural_admixture_tpu_torch.ops import loglikelihood as tll
from tests.conftest import DEMO_BED
from tests.test_io import _encode_bed_bytes
from tests.test_pgen import _geno_mode16

REPO = Path(__file__).resolve().parents[1]
PORT_BUILD = REPO / "neural_admixture_tpu_torch" / "native" / "build"
SHAPES = [(1, 1), (5, 9), (37, 53), (130, 301), (4100, 7)]


@pytest.fixture(scope="module", autouse=True)
def _both_libraries():
    assert bed_native.available() and bed_native.pgen_available()
    assert jnative.available() and jnative.pgen_available()


def _codes(N, M, seed):
    return np.random.default_rng(seed).integers(0, 4, size=(N, M)).astype(
        np.uint8)


def test_library_is_built_into_the_port():
    """The library lies in the port's native/build/, named by the hash of
    its source and flags; the JAX package's library is another file."""
    path = Path(bed_native.library_path()).resolve()
    assert path.parent == PORT_BUILD
    assert path == build.lib_path() and path.exists()
    assert path.name.startswith("libna_native_")
    assert "neural_admixture_tpu/" not in str(path)
    assert path != Path(jnative._load()._name).resolve()


def test_port_process_never_maps_the_jax_library():
    """A process that reads BED, PGEN and VCF through the port maps the
    port's library and no file of the JAX package."""
    code = (
        "import sys\n"
        "from neural_admixture_tpu_torch.infer import read_packed\n"
        f"read_packed({DEMO_BED!r})\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert 'neural_admixture_tpu_torch/native/build/libna_native_' "
        "in maps\n"
        "assert 'neural_admixture_tpu/' not in maps\n"
        "assert not [m for m in sys.modules\n"
        "            if m.split('.')[0] in ('jax', 'neural_admixture_tpu')]\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


@pytest.mark.parametrize("N,M", SHAPES)
def test_decode_bed_matches_jax_and_numpy(N, M):
    G = _codes(N, M, N + M)
    B = _bed_bytes_fast(G)
    if N * M < 5000:
        np.testing.assert_array_equal(B, _encode_bed_bytes(G))
    got = bed_native.decode_bed(B, N)
    np.testing.assert_array_equal(got, jnative.decode_bed(B, N))
    np.testing.assert_array_equal(got, tbed.decode_bed_numpy(B, N))
    np.testing.assert_array_equal(got, G)


def _bed_bytes_fast(G):
    """BED bytes (M, ceil(N/4)) of dosages G (N, M), vectorised."""
    code = np.array([3, 2, 0, 1], np.uint8)[G.T]  # dosage -> PLINK code
    return tpacked.pack_2bit_rows(code)


@pytest.mark.parametrize("N,M", SHAPES)
@pytest.mark.parametrize("extra", [0, 3, 2048])
def test_bed_to_packed_matches_jax_and_numpy(N, M, extra):
    G = _codes(N, M, 7 * N + M)
    B = _bed_bytes_fast(G)
    m_pad = -(-(M + extra) // 4) * 4
    got = bed_native.bed_to_packed(B, N, m_pad)
    np.testing.assert_array_equal(got, jnative.bed_to_packed(B, N, m_pad))
    np.testing.assert_array_equal(
        got, tpacked.pack_2bit_rows(tbed.decode_bed_numpy(B, N), m_pad=m_pad))


@pytest.mark.parametrize("N,M", SHAPES)
def test_pack_2bit_matches_jax_and_numpy(N, M):
    G = _codes(N, M, 3 * N + M)
    m_pad = -(-M // 4) * 4 + 8
    got = bed_native.pack_2bit(G, m_pad)
    np.testing.assert_array_equal(got, jnative.pack_2bit(G, m_pad))
    np.testing.assert_array_equal(got, tpacked.pack_2bit_rows(G, m_pad))


@pytest.mark.parametrize("N,M,K", [(20, 31, 4), (300, 700, 7), (3, 2000, 2)])
def test_loglikelihood_matches_jax_and_numpy(N, M, K):
    """Native against the JAX library (the same code: equal) and the NumPy
    twin (another summation order: within 1e-12 relative); the port's
    ``loglikelihood`` takes the native path at the default eps and the
    twin at any other."""
    rng = np.random.default_rng(N + M + K)
    G = _codes(N, M, K)
    Q = rng.dirichlet(np.ones(K), size=N)
    P = rng.uniform(0.0, 1.0, size=(M, K))
    bed_native.reset_calls()
    got = tll.loglikelihood(G, P, Q, K)
    assert bed_native.loglikelihood.calls == 1
    assert got == jnative.loglikelihood(G, P, Q)
    np.testing.assert_allclose(got, tll.loglikelihood_numpy(G, P, Q),
                               rtol=1e-12)
    assert tll.loglikelihood(G, P, Q, K, eps=1e-5) == \
        tll.loglikelihood_numpy(G, P, Q, eps=1e-5)
    assert bed_native.loglikelihood.calls == 1


@pytest.mark.parametrize("N", [53, 256, 700])
@pytest.mark.parametrize("skip", [0, 5])
def test_pgen_decode_matches_jax(tmp_path, N, skip):
    """na_pgen_decode2 on the records of a fixture of every record type:
    the port's library gives the JAX library's bytes and LD state."""
    G = _geno_mode16(N=N, M=120, seed=N)
    path = str(tmp_path / "f.pgen")
    write_pgen_standard(path, G, psam=False)
    r = StandardPgen(path)
    with open(path, "rb") as fh:
        fh.seek(int(r.rec_pos[0]))
        recs = np.fromfile(fh, np.uint8, int(r.rec_pos[-1] - r.rec_pos[0]))
    rec_off = (r.rec_pos - r.rec_pos[0]).astype(np.int64)
    outs = []
    for lib in (bed_native, jnative):
        base, valid = np.zeros(N, np.uint8), np.zeros(1, np.int64)
        outs.append((lib.pgen_decode(recs, rec_off, r.vrtypes, skip, N,
                                     _sample_id_bytes(N), base, valid),
                     base, valid))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(outs[0][0], G[:, skip:].T)


def test_counters_count_the_calls_that_reach_the_library():
    bed_native.reset_calls()
    assert set(bed_native.call_counts().values()) == {0}
    tbed.read_bed_packed(DEMO_BED, block_m=4000)  # 8451 SNPs: 3 blocks
    tbed.read_bed(DEMO_BED)
    assert bed_native.call_counts() == {
        "decode_bed": 1, "bed_to_packed": 3, "pack_2bit": 0,
        "loglikelihood": 0, "pgen_decode": 0}


def test_failed_build_logs_one_warning_and_still_reads(monkeypatch, caplog):
    """No compiler: one warning with the build error, then the NumPy twins
    give the JAX package's bytes, and no call reaches a library."""
    def no_compiler(force=False):
        raise RuntimeError("native build failed (g++ ...): no compiler")

    monkeypatch.setattr(bed_native, "_lib", None)
    monkeypatch.setattr(bed_native, "_tried", False)
    monkeypatch.setattr(build, "build", no_compiler)
    bed_native.reset_calls()
    caplog.set_level(logging.WARNING)
    from neural_admixture_tpu.io import bed as jbed
    want, _, _ = jbed.read_bed_packed(DEMO_BED)
    for _ in range(2):
        got, _, _ = tbed.read_bed_packed(DEMO_BED)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tbed.read_bed(DEMO_BED),
                                  jbed.read_bed(DEMO_BED))
    warnings = [r for r in caplog.records if r.levelno == logging.WARNING]
    assert len(warnings) == 1
    assert "no compiler" in warnings[0].getMessage()
    assert "NumPy" in warnings[0].getMessage()
    assert not bed_native.available() and not bed_native.pgen_available()
    assert set(bed_native.call_counts().values()) == {0}


def test_library_without_the_pgen_symbol_disables_only_pgen(monkeypatch,
                                                            tmp_path):
    """A library lacking na_pgen_decode2 keeps the BED kernels and leaves
    PGEN records to the pure-Python decoder."""
    fake = types.SimpleNamespace(**{
        name: types.SimpleNamespace() for name in (
            "na_decode_bed", "na_bed_to_packed", "na_pack_2bit",
            "na_loglikelihood")})
    lib = bed_native._bind(fake)
    assert lib._has_pgen is False
    monkeypatch.setattr(bed_native, "_lib", lib)
    monkeypatch.setattr(bed_native, "_tried", True)
    assert bed_native.available() and not bed_native.pgen_available()
    G = _geno_mode16(N=31, M=90, seed=4)
    path = str(tmp_path / "p.pgen")
    write_pgen_standard(path, G, psam=False)
    bed_native.reset_calls()
    np.testing.assert_array_equal(StandardPgen(path).read_block(0, 90).T, G)
    assert bed_native.pgen_decode.calls == 0


def test_concurrent_builds_all_load(tmp_path):
    """Three processes build at once into one directory (as test workers or
    two CLI runs on a fresh checkout do): each compiles to its own
    temporary name and renames it into place, so every one loads a whole
    library and no temporary is left."""
    code = (
        "import ctypes, sys\n"
        "from pathlib import Path\n"
        "from neural_admixture_tpu_torch.native import build\n"
        "build.BUILD_DIR = Path(sys.argv[1])\n"
        "path = build.build(force=True)\n"
        "ctypes.CDLL(str(path)).na_pgen_decode2\n"
        "print(path)\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=REPO, stdout=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=300)[0].strip() for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0]
    assert len(set(outs)) == 1 and Path(outs[0]).parent == tmp_path
    assert sorted(p.name for p in tmp_path.iterdir()) == [Path(outs[0]).name]


def test_march_candidates_keep_the_jax_order():
    from neural_admixture_tpu.native import build as jbuild
    assert build._march_flags() == jbuild._march_flags()
    assert build._march_flags()[-1] == ""

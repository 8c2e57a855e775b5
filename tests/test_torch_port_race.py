"""The race check of the port's native host decoder
(neural_admixture_tpu_torch/native/tsan.py and tsan_test.cpp): the harness
under ThreadSanitizer passes on the port's bed_decode.cpp with every
threaded entry point on two or more chunks and threads, its canary and a
copy of the source with a data race fail it, and its chunking is held
against the source's.

The ThreadSanitizer tests skip only where the compiler cannot link and run a
trivial -fsanitize=thread program, and say why."""
import importlib.util
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest

from neural_admixture_tpu_torch.native import tsan
from neural_admixture_tpu_torch.native.build import _cxx

REPO = Path(__file__).resolve().parents[1]
THREADED = {"na_decode_bed": ("N", 4096), "na_bed_to_packed": ("N", 4096),
            "na_pack_2bit": ("N", 256), "na_loglikelihood": ("M", 256)}


def _tsan_links():
    """None when the compiler links and runs a trivial -fsanitize=thread
    program here, else why not."""
    with tempfile.TemporaryDirectory() as d:
        src, exe = Path(d) / "t.cpp", Path(d) / "t"
        src.write_text("#include <thread>\nint main() { std::thread t([] {});"
                       " t.join(); return 0; }\n")
        try:
            res = subprocess.run([_cxx(), *tsan.TSAN_FLAGS, str(src), "-o",
                                  str(exe)], capture_output=True, text=True)
        except (OSError, RuntimeError) as exc:
            return f"no C++ compiler: {exc}"
        if res.returncode != 0:
            return ("the compiler cannot link -fsanitize=thread: "
                    + res.stderr.strip()[-500:])
        res = subprocess.run([str(exe)], capture_output=True, text=True)
        if res.returncode != 0:
            return ("a -fsanitize=thread program does not run here: "
                    + res.stderr.strip()[-500:])
    return None


@pytest.fixture(scope="module")
def tsan_ok():
    why = _tsan_links()
    if why is not None:
        print(f"ThreadSanitizer unavailable: {why}")
        pytest.skip(f"ThreadSanitizer unavailable: {why}")


@pytest.fixture(scope="module")
def runner(tsan_ok):
    """The runner as a user calls it, once for the module."""
    return subprocess.run(
        [sys.executable, "-m", "neural_admixture_tpu_torch.native.tsan"],
        cwd=REPO, capture_output=True, text=True, timeout=600)


def test_runner_passes_on_the_port_source(runner):
    """Exit 0: the canary reported, the harness clean and checked, the
    chunking held against the source."""
    assert runner.returncode == 0, runner.stderr[-4000:]
    assert "tsan: canary reported" in runner.stdout
    assert "tsan harness ok" in runner.stdout
    assert "tsan: no data race in bed_decode.cpp (5 calls" in runner.stdout
    assert tsan.REPORT not in runner.stderr


def test_every_threaded_entry_point_runs_two_or_more_chunks(runner):
    """Each threaded call's shape gives 2 or more chunks on a pool of 2 or
    more, so it starts 2 or more threads; na_pgen_decode2 is called too."""
    calls = tsan.harness_calls(runner.stdout)
    assert set(calls) == set(THREADED) | {"na_pgen_decode2"}
    for name, (dim, chunk) in THREADED.items():
        c = calls[name]
        assert (c["dim"], int(c["chunk"])) == (dim, chunk)
        assert int(c["chunks"]) >= 2 and int(c["pool"]) >= 2, c
        assert int(c["threads"]) == min(int(c["chunks"]), int(c["pool"]))
        assert int(c["threads"]) >= 2
    assert calls["na_pgen_decode2"]["rc"] == "0"


def test_canary_makes_the_runner_fail(tsan_ok):
    """``--canary``: ThreadSanitizer reports the deliberate race and the
    runner exits non-zero."""
    res = subprocess.run(
        [sys.executable, "-m", "neural_admixture_tpu_torch.native.tsan",
         "--canary"], cwd=REPO, capture_output=True, text=True, timeout=600)
    assert res.returncode != 0
    assert "WARNING: ThreadSanitizer: data race" in res.stderr


def test_a_race_in_the_source_fails_the_harness(tsan_ok, tmp_path):
    """A copy of bed_decode.cpp whose na_bed_to_packed splits the SNPs in
    blocks of 1023 (neighbouring blocks share an output byte of every row:
    the race a cut by SNP blocks can bring) fails under the harness."""
    src = tsan.SRC.read_text()
    old = ("    const int64_t MT = 2048, NT = 4096;\n"
           "    parallel_chunks(N, NT, [=](int64_t n0, int64_t n1) {\n"
           "        for (int64_t m0 = 0; m0 < M; m0 += MT) {\n"
           "            const int64_t m1 = std::min(m0 + MT, M);\n")
    new = ("    parallel_chunks(M, 1023, [=](int64_t m0, int64_t m1) {\n"
           "        const int64_t n0 = 0, n1 = N;\n"
           "        {\n")
    assert src.count(old) == 1
    racy = tmp_path / "bed_decode.cpp"
    racy.write_text(src.replace(old, new))
    exe, _ = tsan.build(racy, tmp_path)
    res = tsan.run(exe)
    assert res.returncode != 0
    assert "WARNING: ThreadSanitizer: data race" in res.stderr
    assert f"{racy}:" in res.stderr  # the report points into the copy


def test_source_chunking_reads_the_port_source():
    """The dimension and chunk of every parallel_chunks call, from the
    source: the four threaded entry points, and not na_pgen_decode2."""
    assert tsan.source_chunking() == THREADED


def _line(name, dim="N", total=9001, chunk=4096, pool=8):
    chunks = -(-total // chunk)
    return (f"call {name} dim={dim} total={total} chunk={chunk} "
            f"chunks={chunks} pool={pool} threads={min(chunks, pool)}")


GOOD = [_line("na_decode_bed"), _line("na_bed_to_packed"),
        _line("na_pack_2bit", chunk=256),
        _line("na_loglikelihood", dim="M", total=2500, chunk=256)]


@pytest.mark.parametrize("case,fault", [
    ("good", None),
    ("one_chunk", "na_decode_bed: 1 chunk(s) on a pool of 8: one thread"),
    ("one_core", "na_pack_2bit: 36 chunk(s) on a pool of 1: one thread"),
    ("other_chunk", "na_bed_to_packed: the harness assumes chunks of 2048 "
     "over N, the source passes 4096 over N"),
    ("not_called", "na_loglikelihood: threaded in the source, not called by "
     "the harness"),
])
def test_check_chunking_refuses_a_vacuous_harness(case, fault):
    """The runner's own check of the harness's output: the JAX harness's
    N = 1031 (one 4096-sample chunk), a one-core pool, a chunk the source
    does not use and an entry point left out each fail it."""
    lines = list(GOOD)
    if case == "one_chunk":
        lines[0] = _line("na_decode_bed", total=1031)
    elif case == "one_core":
        lines[2] = _line("na_pack_2bit", chunk=256, pool=1)
    elif case == "other_chunk":
        lines[1] = _line("na_bed_to_packed", chunk=2048)
    elif case == "not_called":
        lines.pop()
    faults = tsan.check_chunking("\n".join(lines))
    assert faults == ([] if fault is None else [fault])


# ---- phase 3's cases against the kernels' dispatch rules ----
#
# chip_smoke.py's phase 3 holds every kernel against its plain version on
# the card. Its case lists are mapped here through the dispatchers of
# csrc/*.cu (the rules below, read from na_xv, na_dq_dp/dispatch, na_dv and
# na_bce_sum/dispatch) to the template instances they launch, and to the
# tile edges each case crosses, with the kernels' geometry read from the
# sources.

CSRC = REPO / "neural_admixture_tpu_torch" / "csrc"


def _const(source, name):
    text = (CSRC / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _nt(D):  # xv.cu na_xv: n-tiles of 8 columns
    return 1 if D <= 8 else 2 if D <= 16 else 4


def _kt(k):  # dq_dp.cu na_dq_dp
    return 4 if k <= 4 else 8 if k <= 8 else 16


def _ks(k):  # bce_sum.cu na_bce_sum
    return 1 if k <= 8 else 2


def _vec16(m_pad, offset):  # xv.cu and dv.cu launch: 16-byte loads
    return (m_pad // 16) % 4 == 0 and offset % 16 == 0


@pytest.fixture(scope="module")
def launches():
    """Every kernel call of phase 3's cases: {kernel: [dict]}, each with its
    instance and the shape it runs at."""
    cs = _chip_smoke()
    out = {"xv": [], "dq_dp": [], "dv": [], "bce_sum": []}
    for B, M, D, _, nm, _, off in cs.XV_CASES:
        out["xv"].append(dict(inst=(_nt(D), nm, False), B=B, m=M, D=D,
                              vec16=_vec16(M, off)))
    for B, m, k, _, nm, _ in cs.DQ_DP_CASES:
        for masked in (True, False):
            for wl in (False, True):
                out["dq_dp"].append(dict(inst=(_kt(k), masked, nm, wl, False),
                                         B=B, m=m, k=k))
    for B, m, D, _, nm, _, off in cs.DV_CASES:
        out["dv"].append(dict(inst=(nm, False), B=B, m=m, D=D,
                              vec16=_vec16(m, off),
                              W4_ragged=(m // 16) % 4 != 0))
    for B, m, k in cs.BCE_SUM_CASES:  # bce_sum and loss_dq_dp
        for missing in (True, False):
            for masked in (True, False):
                out["bce_sum"].append(dict(inst=(_ks(k), masked, not missing),
                                           indexed=False, B=B, m=m, k=k))
                out["dq_dp"].append(dict(
                    inst=(_kt(k), masked, not missing, True, False), B=B,
                    m=m, k=k))
    for n_rows, blk, nbk, m, k, D, missing, masked, off in cs.INDEXED_CASES:
        assert nbk * blk <= n_rows
        B, nm = nbk * blk, not missing
        out["xv"].append(dict(inst=(_nt(D), nm, True), B=B, m=m, D=D,
                              vec16=_vec16(m, off)))
        out["dv"].append(dict(inst=(nm, True), B=B, m=m, D=D,
                              vec16=_vec16(m, off),
                              W4_ragged=(m // 16) % 4 != 0))
        for wl in (False, True):
            out["dq_dp"].append(dict(inst=(_kt(k), masked, nm, wl, True),
                                     B=B, m=m, k=k))
        out["bce_sum"].append(dict(inst=(_ks(k), masked, nm), indexed=True,
                                   B=B, m=m, k=k))
    return out


def test_phase3_reaches_every_xv_instance(launches):
    """K2: NT {1, 2, 4} x NO_MISSING x INDEXED, 12 instances; B ragged
    against the 16-row tile, M against the 512-SNP chunk, every NT past
    one launch's rows (kMaxSums / 8 NT), 16-byte loads on and off."""
    calls = launches["xv"]
    assert {c["inst"] for c in calls} == {
        (nt, nm, ix) for nt in (1, 2, 4) for nm in (False, True)
        for ix in (False, True)}
    assert any(c["B"] % 16 for c in calls)
    assert any(c["m"] % 512 for c in calls)
    max_sums = _const("xv.cu", "kMaxSums")
    for nt in (1, 2, 4):
        assert any(c["inst"][0] == nt and c["B"] > max_sums // (8 * nt)
                   for c in calls), nt
    assert {c["vec16"] for c in calls} == {False, True}


def test_phase3_reaches_every_dq_dp_instance(launches):
    """K3/K4: KT {4, 8, 16} x MASKED x NO_MISSING x WITH_LOSS x INDEXED, 48
    instances; k short of every KT, B ragged against the 16-row groups,
    m_pad against the 128-SNP tile, and a batch over one launch's rows at
    KT = 8 and 16."""
    calls = launches["dq_dp"]
    assert {c["inst"] for c in calls} == {
        (kt, ma, nm, wl, ix) for kt in (4, 8, 16) for ma in (False, True)
        for nm in (False, True) for wl in (False, True)
        for ix in (False, True)}
    for kt in (4, 8, 16):
        assert any(c["inst"][0] == kt and c["k"] % kt for c in calls), kt
    assert any(c["B"] % 16 for c in calls)
    assert any(c["m"] % 128 for c in calls)
    cap, warps = _const("dq_dp.cu", "kSmemCap"), _const("dq_dp.cu", "kWarps")
    for kt in (8, 16):  # dq_dp.cu Geom<KT>::kRows
        sq, ns = max(kt, 8), 1 if kt == 16 else 2
        rows = (cap // 4 - warps * kt * 8 * ns) // (2 * sq + 2) // 16 * 16
        assert any(c["inst"][0] == kt and c["B"] > rows for c in calls), kt


def test_phase3_reaches_every_dv_instance_at_every_edge(launches):
    """K5: NO_MISSING x INDEXED, 4 instances, each past one launch's rows
    (kRowsPerLaunch) with D > 8 (two passes of col0), with its 16-byte
    loads on, off by W4 % 4 != 0, and off by rows 4 bytes past an aligned
    address (W4 % 4 == 0)."""
    calls = launches["dv"]
    rows = _const("dv.cu", "kRowsPerLaunch")
    for inst in [(nm, ix) for nm in (False, True) for ix in (False, True)]:
        big = [c for c in calls
               if c["inst"] == inst and c["B"] > rows and c["D"] > 8]
        assert any(c["vec16"] for c in big), inst
        assert any(c["W4_ragged"] for c in big), inst
        assert any(not c["vec16"] and not c["W4_ragged"] for c in big), inst


def test_phase3_reaches_every_bce_sum_instance(launches):
    """K6: KS {1, 2} x MASKED x NO_MISSING, 8 instances, each gathered and
    indexed; B ragged against 16 rows, and over one pass's rows at both
    KS."""
    calls = launches["bce_sum"]
    every = {(ks, ma, nm) for ks in (1, 2) for ma in (False, True)
             for nm in (False, True)}
    for indexed in (False, True):
        assert {c["inst"] for c in calls if c["indexed"] == indexed} == every
    assert any(c["B"] % 16 for c in calls)
    cap, warps = _const("bce_sum.cu", "kSmemCap"), _const("bce_sum.cu",
                                                         "kWarps")
    for ks in (1, 2):  # bce_sum.cu Geom<KS>::kRows
        ns = 8 if ks == 1 else 4
        fixed = warps * ns * ks * 32 * 16 + warps * ns * 32 * 8
        rows = (cap - fixed) // ((16 * ks + 2) * 4) // 16 * 16
        assert any(c["inst"][0] == ks and c["B"] > rows for c in calls), ks

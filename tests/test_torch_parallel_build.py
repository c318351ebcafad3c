"""The kernel library's parallel build (ops/build.py) and the instance table
of csrc/string_step.cu it relies on.

There is no nvcc on this host: a stand-in script records each call's
arguments and times and writes the files nvcc would, so that the build's
commands, their concurrency, the link and the collected ptxas messages are
checked here; the card's build runs in chip_smoke.py phase 2.
"""

import os
import re
import stat
import time

import pytest

import chip_smoke as cs
from torch_fdtd_string_tpu_torch.ops import build

CU = os.path.join(build.CSRC_DIR, "string_step.cu")

# the stand-in nvcc: logs "<start> <end> <args>" per call, writes -o's file,
# reports one ptxas entry per part on stderr, and fails the part named by
# FAKE_NVCC_FAIL
FAKE_NVCC = r"""#!/bin/sh
start=$(date +%s.%N)
out=""; part=""; prev=""
for a in "$@"; do
  [ "$prev" = "-o" ] && out="$a"
  case "$a" in -DBUILD_PART=*) part="${a#-DBUILD_PART=}";; esac
  prev="$a"
done
if [ -n "$part" ] && [ "$part" = "$FAKE_NVCC_FAIL" ]; then
  echo "error in part $part" >&2; exit 2
fi
sleep "${FAKE_NVCC_SLEEP:-0}"
[ -n "$out" ] && echo "object" > "$out"
if [ -n "$part" ]; then
  echo "ptxas info    : Compiling entry function 'part$part' for 'sm_90a'" >&2
  echo "ptxas info    : Used $part registers" >&2
fi
echo "$start $(date +%s.%N) $*" >> "$FAKE_NVCC_LOG"
"""


def instances():
    """The (index, bow, hammer, surface, gmres, mms, fixed) rows of the
    source's STRING_STEP_INSTANCES table."""
    with open(CU) as f:
        src = f.read()
    table = src[src.index("#define STRING_STEP_INSTANCES(X)"):]
    table = table[:table.index("#define STRING_STEP_NUM_INSTANCES")]
    rows = re.findall(r"X\((\d+), (\w+), (\w+), (\w+), (\w+), (\w+), (\w+)\)", table)
    return [(int(r[0]),) + tuple(v == "true" for v in r[1:]) for r in rows]


def test_instance_table_covers_the_22_instances():
    """One row per instance, indexed 0..21 in order, all distinct; the
    build compiles one part per row and one for the dispatch; every row
    names an instance of chip_smoke.py's ptxas report."""
    rows = instances()
    assert [r[0] for r in rows] == list(range(22))
    assert len({r[1:] for r in rows}) == 22
    with open(CU) as f:
        assert "#define STRING_STEP_NUM_INSTANCES 22" in f.read()
    assert build.PARTS["string_step"] == len(rows) + 1
    # gmres / bow / hammer / surface bits for 0-15, as instance_index reads them
    for i, bow, hammer, surface, gmres, mms, fixed in rows[:16]:
        assert (gmres, bow, hammer, surface) == (bool(i & 8), bool(i & 4), bool(i & 2),
                                                 bool(i & 1))
        assert not (mms or fixed)
    assert [(r[3], r[4], r[5], r[6]) for r in rows[16:]] == [
        (False, False, True, False), (True, False, True, False),
        (False, True, True, False), (True, True, True, False),
        (False, False, False, True), (True, False, False, True)]
    names = set()
    for i, bow, hammer, surface, gmres, mms, fixed in rows:
        b = lambda v: "1" if v else "0"
        entry = (f"ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118string_step_"
                 f"kernelILb{b(bow)}ELb{b(hammer)}ELb{b(surface)}ELb{b(gmres)}ELb{b(mms)}E"
                 f"Lb{b(fixed)}EEEvNS_6ParamsE' for 'sm_90a'\nptxas info    : Used 99 registers")
        names |= set(cs.ptxas_report(entry))
    assert len(names) == 22 and set(cs.REPLACES) - {"bucketed"} <= names


@pytest.fixture()
def fake_nvcc(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    log = tmp_path / "calls.log"
    monkeypatch.setenv("FAKE_NVCC_LOG", str(log))
    monkeypatch.setattr(build, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "kernels"))
    monkeypatch.setattr(build, "build_log", {})
    monkeypatch.setattr(build, "build_seconds", {})

    def calls():
        with open(log) as f:
            return [(float(a), float(b), rest.split())
                    for a, b, rest in (line.rstrip("\n").split(" ", 2) for line in f)]

    return calls


def test_parts_compile_at_once_and_link(fake_nvcc, monkeypatch):
    """23 compiles of the one source, each with its -DBUILD_PART and the
    same flags, all started before any ended, then one link of their 23
    objects into the library; the parts' messages in part order."""
    monkeypatch.setenv("FAKE_NVCC_SLEEP", "1")
    t0 = time.perf_counter()
    path = build.build_kernel_library("string_step")
    wall = time.perf_counter() - t0
    assert path == os.path.join(build.BUILD_DIR, "libstring_step.so")
    assert os.path.exists(path)
    calls = fake_nvcc()
    compiles, links = calls[:-1], calls[-1]
    assert len(compiles) == 23
    parts = sorted(int(a.split("=")[1]) for _, _, args in compiles for a in args
                   if a.startswith("-DBUILD_PART="))
    assert parts == list(range(23))
    for _, _, args in compiles:
        assert args[-1] == CU and "-c" in args and "-shared" not in args
        assert [a for a in args if not a.startswith("-DBUILD_PART=")][:len(
            build.COMPILE_FLAGS)] == build.COMPILE_FLAGS
    assert max(start for start, _, _ in compiles) < min(end for _, end, _ in compiles)
    assert wall < 12, wall  # 23 one-second compiles side by side
    objs = [a for a in links[2] if a.endswith(".o")]
    assert len(objs) == 23 and "-shared" in links[2] and links[1] >= max(
        end for _, end, _ in compiles)
    log = build.build_log["string_step"]
    assert [int(m) for m in re.findall(r"entry function 'part(\d+)'", log)] == list(range(23))
    # the objects' directory is gone, the library is reused
    assert os.listdir(build.BUILD_DIR) == ["libstring_step.so"]
    assert build.build_kernel_library("string_step") == path
    assert len(fake_nvcc()) == 24


def test_a_failing_part_fails_the_build(fake_nvcc, monkeypatch):
    """A part's nvcc error raises with its part and messages; no library is
    written and no object is left."""
    monkeypatch.setenv("FAKE_NVCC_FAIL", "7")
    with pytest.raises(RuntimeError, match=r"part 7 \(exit 2\):\nerror in part 7"):
        build.build_kernel_library("string_step")
    assert os.listdir(build.BUILD_DIR) == []
    assert all("-c" in args for _, _, args in fake_nvcc())


def test_a_source_without_parts_builds_in_one_call(fake_nvcc, tmp_path, monkeypatch):
    """A source not in PARTS: one nvcc call with the shared-library flags
    and the defines."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "other.cu").write_text("// nothing\n")
    monkeypatch.setattr(build, "CSRC_DIR", str(csrc))
    build.build_kernel_library("other_x", "other", defines=("X=1",))
    (call,) = fake_nvcc()
    assert call[2][:len(build.NVCC_FLAGS)] == build.NVCC_FLAGS
    assert "-DX=1" in call[2] and call[2][-1] == str(csrc / "other.cu")

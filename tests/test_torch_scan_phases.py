"""The copies of the scan kernels' source that tools/scan_phases.py builds:
the chain cut takes out exactly the marked lines and feeds the next level
from the same inputs; the yardsticks use only what the source defines."""

import re
from pathlib import Path

from alphagomoku_tpu_torch.tools import scan_phases as T

ROOT = Path(__file__).resolve().parents[1]
SOURCE = (ROOT / T.SOURCE).read_text()


def test_chain_is_marked_once():
    assert SOURCE.count("// >> chain\n") == 1 and SOURCE.count("// << chain\n") == 1
    assert SOURCE.index("// >> chain") < SOURCE.index("// << chain")


def test_cut_replaces_the_chain_and_keeps_the_rest():
    cut = T.cut_chain(SOURCE)
    marked = SOURCE[SOURCE.index("// >> chain"):SOURCE.index("// << chain")]
    assert "q = invert_up(p);" in marked and "q = invert_up(p);" not in cut
    assert "// >> chain" not in cut and "// << chain" not in cut
    assert T.CHAIN_CUT in cut
    outside = SOURCE.replace(marked, "")
    for line in outside.splitlines():
        if line.strip() and "// << chain" not in line:
            assert line in cut


def test_chain_cut_reads_what_the_chain_reads():
    body = SOURCE[SOURCE.index("// >> chain"):SOURCE.index("// << chain")]
    for name in re.findall(r"[a-z_]+(?=\[d\])", T.CHAIN_CUT):
        assert f"{name}[d]" in body, name
        assert re.search(rf"\b{name}\[kL\]", SOURCE), name


def test_variants_of_a_source_without_marks_are_whole_only(tmp_path):
    (tmp_path / T.SOURCE).parent.mkdir(parents=True)
    (tmp_path / T.SOURCE).write_text("// a kernel\n")
    assert list(T.variants(tmp_path)) == ["whole"]
    assert list(T.variants(ROOT)) == ["whole", "no_chain", "one_kL"]


def test_one_kl_runs_every_wide_chunk_at_full_depth():
    calls = re.findall(r"AG_WIDE(?:_BACKUP)?_LEVELS\((\w+)\);", SOURCE)
    assert sorted(calls) == sorted(["kWideD", "8", "4"] * 2)
    one = T.one_kl(SOURCE)
    assert re.findall(r"AG_WIDE(?:_BACKUP)?_LEVELS\((\w+)\);", one) == ["kWideD"] * 6
    assert not T.WIDE_DISPATCH.search(one)
    pairs = list(zip(SOURCE.splitlines(), one.splitlines(), strict=True))
    changed = [new for old, new in pairs if old != new]
    assert len(changed) == 4 and all(new.endswith("_LEVELS(kWideD);") for new in changed)
    assert "AG_BACKUP_LEVELS(4)" in SOURCE and "AG_BACKUP_LEVELS(4)" in one


def test_yardsticks_use_the_source_definitions():
    for name in ("invert_up", "kWarps"):
        assert name in T.YARDSTICKS and re.search(rf"\b{name}\b", SOURCE)
    assert "extern \"C\" int ag_scan_floor" in T.YARDSTICKS
    assert "extern \"C\" int ag_invert_chain" in T.YARDSTICKS

"""The measuring tools' copies of the trunk kernel's source: the phase
split's cuts (alphagomoku_tpu_torch/tools/trunk_phases.py), where each phase
is marked and cutting it takes out exactly its marked lines, and the settle
study's variants (tools/trunk_settle.py), each one change to the source."""

from pathlib import Path

import pytest

from alphagomoku_tpu_torch.tools import trunk_phases as T

SOURCE = (Path(__file__).resolve().parents[1] / "alphagomoku_tpu_torch" / "csrc"
          / "convnext_trunk.cu").read_text()


@pytest.mark.parametrize("phase", T.PHASES)
def test_cut_takes_out_the_marked_lines(phase):
    opened = SOURCE.count(f"// >> {phase}\n")
    assert opened >= 1 and opened == SOURCE.count(f"// << {phase}\n")
    cut = T.cut(SOURCE, phase)
    assert f"// >> {phase}" not in cut and f"// << {phase}" not in cut
    assert len(cut.splitlines()) < len(SOURCE.splitlines()) - 2 * opened
    for other in T.PHASES:
        if other != phase:
            assert cut.count(f"// >> {other}\n") == SOURCE.count(f"// >> {other}\n")


def test_cut_of_unmarked_source_uses_the_phase_comments():
    src = "\n".join([
        "for (l) {", "    // stage this layer's taps", "    { copy(); }", "    __syncthreads();",
        "    // channel scale (bf16) in place", "    scale();", "    __syncthreads();", "}", "",
    ])
    assert "copy" not in T.cut(src, "staging") and "scale();" in T.cut(src, "staging")
    assert T.cut(src, "scale").count("__syncthreads();") == 2
    assert "scale();" not in T.cut(src, "scale")


def test_settle_variants_each_change_one_thing():
    from alphagomoku_tpu_torch.tools import trunk_settle as TS

    found = TS.variants(SOURCE)
    assert found["as_is"] == SOURCE
    for name, text in found.items():
        if name != "as_is":
            assert text != SOURCE, name
    assert "kExact = false" in found["tc_only"] and "kExact = false" in found["reversed"]
    assert "mma.sync.aligned" in SOURCE and "mma.sync.aligned" not in found["reversed"]
    assert "k = 15; k >= 0" in found["reversed"]
    assert TS.counted(SOURCE).count("atomicAdd(&ag_settled") == 1

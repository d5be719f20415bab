"""The dry run of DeepSeek-V2-Lite's serving cells on fake process groups
of 256 and 512 ranks: ``prefill_32k`` (MLA and the MoE FFN, costed from
the probes) and ``decode_32k`` (one token a step on the sequence-sharded
flash-decode core), each in a subprocess so its fake group never meets
another test; both meshes traced, the parameters' bytes per device the
reference's specs' (``tests/test_torch_dryrun.py`` holds the rest)."""

import pytest

torch = pytest.importorskip("torch")

from test_torch_dryrun import check_cell, run_dryrun  # noqa: E402


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_deepseek_serving_cells_on_fake_groups(shape, tmp_path):
    arch = "deepseek-v2-lite-16b"
    rec = run_dryrun(tmp_path, arch, shape)
    check_cell(rec, arch, shape)
    pod = rec["meshes"]["pod"]
    if shape == "decode_32k":
        # the flash-decode combine: all-reduces of (B, H, 1, D) partials,
        # beside the per-layer parameter gathers
        per = pod["cost"]["per_collective"]
        assert per["all-reduce"] > 0 and per["all-gather"] > 0
        assert pod["cost_parts"] == {}
    else:
        assert set(pod["cost_parts"]) == {"group0_x1", "group1_x26",
                                          "boundary"}

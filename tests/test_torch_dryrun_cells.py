"""The dry run of DeepSeek-V2-Lite's serving cells on fake process groups
of 256 and 512 ranks: ``prefill_32k`` (MLA and the MoE FFN, costed from
the probes) and ``decode_32k`` (one token a step on the sequence-sharded
flash-decode core, MLA's latent read where it lies), each in a subprocess so its fake group never meets
another test; both meshes traced, the parameters' bytes per device the
reference's specs' (``tests/test_torch_dryrun.py`` holds the rest);
llama4-maverick's ``decode_32k``, its experts sharded over ``model``;
and llama3.2-1b's ``prefill_32k``, its GQA heads over ``model``."""

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
        # each rank expands every head over its own positions of the
        # latent cache, where they lie: at most the reference's 2.92 GiB
        # a device (4.79 while each layer's latent was gathered whole and
        # expanded over every position), and the 2.417e12 B of
        # all-gathers less most of the latent's 0.9e12
        assert pod["memory"]["peak_bytes_per_device"] / 2**30 <= 2.92
        assert per["all-gather"] <= 1.6e12
    else:
        assert set(pod["cost_parts"]) == {"group0_x1", "group1_x26",
                                          "boundary"}
        # each MoE layer sums its experts' and its MLA heads' partial
        # outputs over ``model``: two all-reduces of a rank's (T, D) rows
        # (T = 32 768 tokens, D = 2048, bf16) a layer, on every device
        moe = pod["cost_parts"]["group1_x26"]["per_collective"]
        assert moe["all-reduce"] >= 26 * 256 * 2 * 32768 * 2048 * 2
        # at most half the peak a device predicted while every expert and
        # head was gathered whole on each rank (21.26 and 611.18 GiB)
        peaks = {k: m["memory"]["peak_bytes_per_device"] / 2**30
                 for k, m in rec["meshes"].items()}
        assert peaks["pod"] <= 21.26 / 2 and peaks["multipod"] <= 611.18 / 2


def test_maverick_decode_cell_holds_its_ranks_experts(tmp_path):
    """llama4-maverick's 128 experts (30 GiB a MoE layer in bf16) are
    sharded over ``model`` and each rank computes its 16: a decode step's
    temporary bytes a device stay at least 20 GiB under the 54.46 and
    59.15 GiB predicted while each rank gathered them all."""
    arch, shape = "llama4-maverick-400b-a17b", "decode_32k"
    rec = run_dryrun(tmp_path, arch, shape)
    check_cell(rec, arch, shape)
    temp = {k: m["memory"]["temp_bytes_per_device"] / 2**30
            for k, m in rec["meshes"].items()}
    assert temp["pod"] <= 54.46 - 20 and temp["multipod"] <= 59.15 - 20


def test_llama_prefill_cell_computes_its_ranks_heads(tmp_path):
    """llama3.2-1b's prefill computes 4 of 32 query heads and 1 of 8 KV
    heads a rank on ``(32, 8)``, each layer's keys and values moved
    between its heads and the cache's sequence shard by an all-to-all:
    the peak a device is at most half the 17.96 GiB predicted while each
    rank computed every head."""
    arch, shape = "llama3.2-1b", "prefill_32k"
    rec = run_dryrun(tmp_path, arch, shape)
    check_cell(rec, arch, shape)
    pod = rec["meshes"]["pod"]
    assert pod["memory"]["peak_bytes_per_device"] / 2**30 <= 17.96 / 2
    # the traced step's own collectives (the probes run without caches)
    assert pod["runtime_cost"]["per_collective"]["all-to-all"] > 0

"""Raw2Zarr ingest in the port against the reference package.

The port's ``etl`` keeps the reference's formats: the raw volume format
byte for byte, the append order fixed from the headers before any decode,
the archive layout and the catalog document.  So the same raw files
ingested by ``repro.etl.ingest`` and ``repro_torch.etl.ingest`` give the
same snapshot ids at any worker count, and a ``LiveFeed`` of the same
scans commits the same snapshots in both packages.  The last part mirrors
``tests/test_ingest_parallel.py`` on the port alone.
"""

import json
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from repro import catalog as jcat  # noqa: E402
from repro import etl as jetl  # noqa: E402
from repro.core import RadarArchive as JArchive  # noqa: E402
from repro.store import ObjectStore as JStore  # noqa: E402
from repro.store import Repository as JRepo  # noqa: E402
from repro_torch import catalog as tcat  # noqa: E402
from repro_torch import etl  # noqa: E402
from repro_torch.core import RadarArchive  # noqa: E402
from repro_torch.etl import level2  # noqa: E402
from repro_torch.etl.pipeline import (build_tree_order, extract,  # noqa: E402
                                      transform)
from repro_torch.store import ObjectStore, Repository  # noqa: E402

N_SCANS = 5
GEOM = dict(n_az=36, n_gates=64, n_sweeps=3)
FEED = dict(n_az=24, n_gates=40, n_sweeps=2)


@pytest.fixture(scope="module")
def raw_archive(tmp_path_factory):
    """Raw files written by the port's generator."""
    raw = ObjectStore(str(tmp_path_factory.mktemp("raw")))
    keys = etl.generate_raw_archive(raw, n_scans=N_SCANS, seed=13, **GEOM)
    return raw, keys


def _ingest(raw, path, workers, **kw):
    repo = Repository.create(str(path))
    return repo, etl.ingest(raw, repo, workers=workers, batch_size=2, **kw)


def _jingest(raw_root, path, workers, **kw):
    repo = JRepo.create(str(path))
    return repo, jetl.ingest(JStore(raw_root), repo, workers=workers,
                             batch_size=2, **kw)


# ---------------------------------------------------------------------------
# the raw volume format
# ---------------------------------------------------------------------------

def _volume(seed=3):
    from repro_torch.core import fm301
    from repro_torch.etl.generator import StormSimulator

    vcp = fm301.VCPS["VCP-212"]
    vcp = fm301.VCPDef(vcp.vcp_id, vcp.elevations[:3], 36, 64, vcp.gate_m,
                       vcp.interval_s)
    return StormSimulator(seed=seed).volume(fm301.SITES["KVNX"], vcp,
                                            1305849600.0)


def _assert_same_volume(a, b):
    assert a["site"].site_id == b["site"].site_id
    assert a["vcp"].name == b["vcp"].name and a["time"] == b["time"]
    assert len(a["sweeps"]) == len(b["sweeps"])
    for sa, sb in zip(a["sweeps"], b["sweeps"]):
        assert sa["elevation"] == sb["elevation"]
        np.testing.assert_array_equal(sa["azimuth"], sb["azimuth"])
        np.testing.assert_array_equal(sa["range"], sb["range"])
        assert list(sa["moments"]) == list(sb["moments"])
        for name in sa["moments"]:
            np.testing.assert_array_equal(sa["moments"][name],
                                          sb["moments"][name])


@pytest.mark.parametrize("codec", ["zlib", "lzma", "raw"])
def test_level2_bytes_equal_the_reference_and_cross_decode(codec):
    from repro.etl import level2 as jlevel2

    vol = _volume()
    blob = level2.encode_volume(vol, codec=codec)
    assert blob == jlevel2.encode_volume(vol, codec=codec)
    back = level2.decode_volume(blob)
    _assert_same_volume(back, jlevel2.decode_volume(blob))
    assert level2.peek_header(blob) == jlevel2.peek_header(blob) == (
        "KVNX", "VCP-212", 1305849600.0)
    # the packing rounds to the moment's scale: a second round trip is exact
    again = level2.decode_volume(level2.encode_volume(back, codec=codec))
    _assert_same_volume(again, back)


def test_level2_rejects_what_it_cannot_read():
    blob = level2.encode_volume(_volume(), codec="zlib")
    with pytest.raises(ValueError, match="not an RDT2"):
        level2.decode_volume(b"XXXX" + blob[4:])
    bad = blob[:4] + (9).to_bytes(2, "little") + blob[6:]
    with pytest.raises(ValueError, match="unsupported version"):
        level2.decode_volume(bad)
    with pytest.raises(ValueError, match="unsupported version"):
        level2.peek_header(bad)


def test_generated_raw_files_equal_the_reference(raw_archive, tmp_path):
    raw, keys = raw_archive
    jraw = JStore(str(tmp_path / "jraw"))
    jkeys = jetl.generate_raw_archive(jraw, n_scans=N_SCANS, seed=13, **GEOM)
    assert keys == jkeys
    for key in keys:
        assert raw.get(key) == jraw.get(key)


# ---------------------------------------------------------------------------
# ingest against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("workers", [1, 4])
def test_ingest_snapshot_ids_and_coverage_equal_the_reference(
        raw_archive, tmp_path, workers):
    raw, _keys = raw_archive
    repo, rep = _ingest(raw, tmp_path / "port", workers)
    jrepo, jrep = _jingest(raw.root, tmp_path / "ref", workers)
    assert rep.snapshot_ids == jrep.snapshot_ids
    assert (rep.n_files, rep.n_volumes, rep.n_commits, rep.bytes_read) == (
        jrep.n_files, jrep.n_volumes, jrep.n_commits, jrep.bytes_read)
    assert json.dumps(rep.coverage, sort_keys=True) == json.dumps(
        jrep.coverage, sort_keys=True)
    assert [c.snapshot_id for c in repo.history()] == [
        c.snapshot_id for c in jrepo.history()]


def test_ingest_with_compaction_and_codec_equals_the_reference(raw_archive,
                                                               tmp_path):
    raw, _keys = raw_archive
    kw = dict(codec="lzma", time_chunk=1, auto_compact_every=2)
    _repo, rep = _ingest(raw, tmp_path / "port", 3, **kw)
    _jrepo, jrep = _jingest(raw.root, tmp_path / "ref", 3, **kw)
    assert rep.snapshot_ids == jrep.snapshot_ids
    assert rep.compaction_ids == jrep.compaction_ids
    assert len(rep.compaction_ids) >= 1


def test_each_package_reads_the_others_ingest(raw_archive, tmp_path):
    raw, _keys = raw_archive
    repo, _ = _ingest(raw, tmp_path / "port", 2)
    jtree = JArchive(JRepo.open(str(tmp_path / "port"))).tree()
    tree = RadarArchive(repo).tree()
    for path in ("VCP-212/time", "VCP-212/sweep_2/DBZH",
                 "VCP-212/sweep_0/ZDR"):
        np.testing.assert_array_equal(tree[path].values(),
                                      jtree[path].values())


def test_catalogued_ingest_writes_the_reference_document(raw_archive,
                                                         tmp_path):
    raw, _keys = raw_archive
    cat = tcat.Catalog.create(str(tmp_path / "cat"))
    jc = jcat.Catalog.create(str(tmp_path / "jcat"))
    repo = Repository.create(str(tmp_path / "repo"))
    rep = etl.ingest(raw, repo, workers=2, batch_size=2, catalog=cat)
    jrepo = JRepo.create(str(tmp_path / "repo2"))
    jetl.ingest(JStore(raw.root), jrepo, workers=2, batch_size=2, catalog=jc)
    entry = cat.entry("KVNX")
    assert entry.snapshot_id == rep.snapshot_ids[-1] == repo.branch_head()
    assert entry.vcps["VCP-212"]["n_times"] == N_SCANS
    doc, jdoc = cat.to_doc(), jc.to_doc()
    for d in (doc, jdoc):
        d["repositories"]["KVNX"]["uri"] = ""
        d.pop("updated_at", None)
    assert json.dumps(doc, sort_keys=True) == json.dumps(jdoc, sort_keys=True)


def test_update_from_report_merges_incrementally(raw_archive, tmp_path):
    raw, keys = raw_archive
    cat = tcat.Catalog.create(str(tmp_path / "cat"))
    repo = Repository.create(str(tmp_path / "repo"))
    first = etl.ingest(raw, repo, keys=keys[:2])
    cat.update_from_report(first, repo=repo)
    assert cat.entry("KVNX").vcps["VCP-212"]["n_times"] == 2
    second = etl.ingest(raw, repo, keys=keys[2:])
    entry = cat.update_from_report(second, repo=repo)
    assert entry.vcps["VCP-212"]["n_times"] == N_SCANS
    assert entry.snapshot_id == repo.branch_head()
    t = [v["time_max"] for v in entry.vcps.values()]
    assert t == [RadarArchive(repo).tree()["VCP-212/time"].values().max()]
    with pytest.raises(ValueError, match="no coverage"):
        cat.update_from_report(etl.IngestReport())


def test_first_registration_by_uri_covers_history(raw_archive, tmp_path):
    raw, keys = raw_archive
    repo = Repository.create(str(tmp_path / "repo"))
    etl.ingest(raw, repo, keys=keys[:3])
    later = etl.ingest(raw, repo, keys=keys[3:])
    cat = tcat.Catalog.create(str(tmp_path / "cat"))
    cat.update_from_report(later, uri=repo.store.root)
    assert cat.entry("KVNX").vcps["VCP-212"]["n_times"] == N_SCANS
    assert cat.entry("KVNX").snapshot_id == repo.branch_head()


def test_mixed_site_feed_ingests_but_is_refused_registration(tmp_path):
    raw = ObjectStore(str(tmp_path / "raw"))
    for site in ("KVNX", "KTLX"):
        etl.generate_raw_archive(raw, site_id=site, n_scans=1, n_az=8,
                                 n_gates=64, n_sweeps=1)
    repo = Repository.create(str(tmp_path / "store"))
    report = etl.ingest(raw, repo)
    assert report.n_volumes == 2
    assert sorted(report.coverage["sites_seen"]) == ["KTLX", "KVNX"]
    cat = tcat.Catalog.create(str(tmp_path / "cat"))
    with pytest.raises(ValueError, match="one site"):
        cat.update_from_report(report, uri=repo.store.root)


# ---------------------------------------------------------------------------
# the live feed
# ---------------------------------------------------------------------------

def test_live_scan_feed_equals_the_reference_and_resumes():
    from repro.etl import live_scan_feed as jfeed

    a = etl.live_scan_feed(seed=7, **FEED)
    b = jfeed(seed=7, **FEED)
    vols = [next(a) for _ in range(3)]
    for v in vols:
        _assert_same_volume(v, next(b))
    resumed = etl.live_scan_feed(seed=7, start=2, **FEED)
    _assert_same_volume(next(resumed), vols[2])


def test_live_feed_ids_do_not_depend_on_workers_and_equal_the_reference(
        tmp_path):
    ids = {}
    for w in (1, 2, 4):
        repo = Repository.create(str(tmp_path / f"w{w}"))
        feed = etl.LiveFeed(repo, etl.live_scan_feed(**FEED), workers=w)
        assert len(feed.ingest_next(3)) == 3
        ids[w] = list(feed.report.snapshot_ids)
    assert ids[1] == ids[2] == ids[4]
    jrepo = JRepo.create(str(tmp_path / "ref"))
    jf = jetl.LiveFeed(jrepo, jetl.live_scan_feed(**FEED), workers=2)
    jf.ingest_next(3)
    assert list(jf.report.snapshot_ids) == ids[1]


def test_live_feed_catalog_heads_advance_per_scan(tmp_path):
    cat = tcat.Catalog.create(str(tmp_path / "cat"))
    repo = Repository.create(str(tmp_path / "r"))
    feed = etl.LiveFeed(repo, etl.live_scan_feed(**FEED), catalog=cat,
                        repo_id="KVNX")
    feed.ingest_next(1)
    h1 = cat.entry("KVNX").snapshot_id
    assert h1 == repo.branch_head()
    feed.ingest_next(1)
    h2 = cat.entry("KVNX").snapshot_id
    assert h2 == repo.branch_head() and h2 != h1
    assert cat.entry("KVNX").vcps["VCP-212"]["n_times"] == 2


def test_live_feed_background_run_and_validation(tmp_path):
    repo = Repository.create(str(tmp_path / "r"))
    feed = etl.LiveFeed(repo, etl.live_scan_feed(**FEED))
    feed.start(max_scans=3)
    assert feed.wait(timeout=60.0)
    assert feed.report.n_commits == 3
    with pytest.raises(RuntimeError, match="already running"):
        feed.start(max_scans=100, interval_s=0.02)
        feed.start()
    time.sleep(0.05)
    feed.stop()
    assert feed.report.n_commits >= 3
    with pytest.raises(ValueError, match="workers"):
        etl.LiveFeed(repo, iter(()), workers=0)
    with pytest.raises(ValueError, match="auto_compact_every"):
        etl.LiveFeed(repo, iter(()), auto_compact_every=0)


def test_live_feed_commits_nothing_without_a_scan_and_compacts(tmp_path):
    repo = Repository.create(str(tmp_path / "r"))
    head = repo.branch_head()
    dry = etl.LiveFeed(repo, iter(()), auto_compact_every=1)
    assert dry.ingest_next(3) == [] and dry.run() == 0
    assert repo.branch_head() == head
    live = etl.LiveFeed(repo, etl.live_scan_feed(**FEED),
                        auto_compact_every=2)
    live.ingest_next(4)
    rep = live.report
    assert rep.n_commits == 4 and len(rep.compaction_ids) >= 1
    assert repo.branch_head() == rep.compaction_ids[-1]


# ---------------------------------------------------------------------------
# the port's mirror of tests/test_ingest_parallel.py
# ---------------------------------------------------------------------------

def test_workers_1_vs_4_identical_snapshots(raw_archive, tmp_path):
    raw, _keys = raw_archive
    repo1, rep1 = _ingest(raw, tmp_path / "w1", 1)
    repo4, rep4 = _ingest(raw, tmp_path / "w4", 4)
    assert rep1.snapshot_ids == rep4.snapshot_ids
    assert rep1.n_volumes == rep4.n_volumes == N_SCANS
    assert rep1.n_commits == rep4.n_commits
    h1, h4 = list(repo1.history()), list(repo4.history())
    assert [c.snapshot_id for c in h1] == [c.snapshot_id for c in h4]
    assert [c.message for c in h1] == [c.message for c in h4]


def test_workers_1_vs_4_identical_data(raw_archive, tmp_path):
    raw, _keys = raw_archive
    repo1, _ = _ingest(raw, tmp_path / "w1", 1)
    repo4, _ = _ingest(raw, tmp_path / "w4", 4)
    t1, t4 = RadarArchive(repo1).tree(), RadarArchive(repo4).tree()
    np.testing.assert_array_equal(t1["VCP-212/sweep_0/DBZH"].values(),
                                  t4["VCP-212/sweep_0/DBZH"].values())
    np.testing.assert_array_equal(t1["VCP-212/time"].values(),
                                  t4["VCP-212/time"].values())


def test_parallel_ingest_report_timings(raw_archive, tmp_path):
    raw, _keys = raw_archive
    _repo, report = _ingest(raw, tmp_path / "r", 4)
    assert report.workers == 4
    for stage in ("extract_s", "decode_s", "load_s", "wall_s"):
        assert report.stage_seconds[stage] >= 0.0


def test_explicit_key_subset_and_order_independence(raw_archive, tmp_path):
    raw, keys = raw_archive
    _repo_a, rep_a = _ingest(raw, tmp_path / "a", 1, keys=keys)
    repo_b = Repository.create(str(tmp_path / "b"))
    rep_b = etl.ingest(raw, repo_b, workers=3, batch_size=2,
                       keys=list(reversed(keys)))
    assert rep_a.snapshot_ids == rep_b.snapshot_ids


def test_header_sort_key_matches_decoded_sort_key(raw_archive):
    raw, keys = raw_archive
    blobs = list(extract(raw, reversed(keys)))
    by_header = [level2.peek_header(b)[1:] for b in sorted(
        (b for _k, b in blobs), key=lambda b: level2.peek_header(b)[1:])]
    by_decoded = [(v["vcp"].name, v["time"])
                  for v in build_tree_order(transform(iter(blobs)))]
    assert by_header == by_decoded


def test_load_stage_commits_batches_and_skips_empty_ones(raw_archive,
                                                         tmp_path):
    raw, keys = raw_archive
    vols = build_tree_order(transform(extract(raw, keys)))
    repo = Repository.create(str(tmp_path / "r"))
    head = repo.branch_head()
    from repro_torch.etl.pipeline import load

    assert load(RadarArchive(repo), [], batch_size=2).n_commits == 0
    assert repo.branch_head() == head
    rep = load(RadarArchive(repo), vols, batch_size=2)
    assert rep.n_commits == 3 and rep.n_volumes == N_SCANS
    ref_repo, ref_rep = _ingest(raw, tmp_path / "piped", 1)
    np.testing.assert_array_equal(
        RadarArchive(repo).tree()["VCP-212/sweep_1/DBZH"].values(),
        RadarArchive(ref_repo).tree()["VCP-212/sweep_1/DBZH"].values())


def test_workers_validation(raw_archive, tmp_path):
    raw, _keys = raw_archive
    repo = Repository.create(str(tmp_path / "bad"))
    with pytest.raises(ValueError, match="workers"):
        etl.ingest(raw, repo, workers=0)
    with pytest.raises(ValueError, match="auto_compact_every"):
        etl.ingest(raw, repo, auto_compact_every=0)


def test_ingest_with_explicit_codec(raw_archive, tmp_path):
    raw, _keys = raw_archive
    repo = Repository.create(str(tmp_path / "lzma"))
    etl.ingest(raw, repo, workers=2, batch_size=3, codec="lzma")
    arr = repo.readonly_session().array("VCP-212/sweep_0/DBZH")
    assert arr.meta.codec == "lzma"
    assert arr.shape[0] == N_SCANS
    assert np.isfinite(arr.read()).any()

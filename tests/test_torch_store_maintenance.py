"""The port's store maintenance and remote layers against the reference's.

Mirrors, on ``repro_torch.store``, the maintenance cases of
``tests/test_store.py`` (abort, a crash before the commit's swap,
disjoint-commit rebase, conflicts, a group attr surviving a rebase, gc's
grace window, rollback, history and tags), ``tests/test_store_compaction.py``
(all but the ingest and live-feed cases, whose ETL is not ported yet) and
the ``SimulatedLatencyStore`` and snapshot-hint cases of
``tests/test_remote_store.py``.  Three cases hold the two packages
together: the same sequence of commits, compactions and rollbacks on
byte-identical copies gives the same snapshot ids; each package reads
the other's compacted archive bitwise; and a commit that loses the swap
to a disjoint writer rebases instead of raising.
"""

import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.store import Repository as RefRepository  # noqa: E402
from repro.store import compact as ref_compact  # noqa: E402
from repro_torch.catalog import Catalog  # noqa: E402
from repro_torch.store import (CommitInfo, ConflictError,  # noqa: E402
                               NotFound, ObjectStore, Repository,
                               SimulatedLatencyStore, compact,
                               plan_compaction)
from repro_torch.store.backends import Backend  # noqa: E402
from repro_torch.store.chunks import plan_time_chunks  # noqa: E402
from repro_torch.store.compaction import (PROFILES,  # noqa: E402
                                          CompactionProfile,
                                          resolve_profile)


@pytest.fixture
def repo(tmp_path):
    return Repository.create(str(tmp_path / "repo"))


def _series_repo(root, *, n=20, width=8, chunks=(1, 8), manifest_format=3,
                 cls=Repository):
    """A fragmented append-per-commit archive: n rows, one per commit."""
    repo = cls.create(str(root), manifest_format=manifest_format)
    tx = repo.writable_session()
    tx.create_array("x", shape=(0, width), dtype="float32", chunks=chunks)
    tx.commit("init")
    for i in range(n):
        tx = repo.writable_session()
        a = tx.resize_array("x", (i + 1, width))
        a[i] = np.full(width, i, dtype="float32")
        tx.commit(f"append {i}")
    return repo


def _chunk_objects(repo):
    return set(repo.store.list("chunks/"))


# ---------------------------------------------------------------------------
# transactions: abort, crash, rebase, conflicts (tests/test_store.py)
# ---------------------------------------------------------------------------

def test_uncommitted_writes_invisible_and_abortable(repo):
    tx = repo.writable_session()
    tx.create_array("x", shape=(4,), dtype="int32", chunks=(4,)).write_full(
        np.arange(4, dtype="int32"))
    assert not repo.readonly_session().has_array("x"), "leak before commit"
    tx.abort()
    assert not repo.readonly_session().has_array("x")
    with pytest.raises(RuntimeError, match="committed/aborted"):
        tx.commit("after abort")


def test_atomicity_under_simulated_crash(tmp_path):
    """Crash after chunks staged but before the ref swap: old head intact."""
    repo = Repository.create(str(tmp_path / "r"))
    tx = repo.writable_session()
    tx.create_array("x", shape=(4,), dtype="int32", chunks=(2,)).write_full(
        np.arange(4, dtype="int32"))
    sid1 = tx.commit("v1")
    tx2 = repo.writable_session()
    tx2.array("x").write_full(np.full(4, 5, dtype="int32"))
    tx2._flush_staged_arrays()     # payloads written ahead, no swap
    del tx2
    assert repo.branch_head() == sid1
    np.testing.assert_array_equal(repo.readonly_session().array("x").read(),
                                  np.arange(4))
    repo.gc()
    np.testing.assert_array_equal(repo.readonly_session().array("x").read(),
                                  np.arange(4))


def test_disjoint_commits_rebase(repo):
    t1 = repo.writable_session()
    t2 = repo.writable_session()
    t1.create_array("a", shape=(2,), dtype="int32", chunks=(2,)).write_full(
        np.array([1, 2], dtype="int32"))
    t2.create_array("b", shape=(2,), dtype="int32", chunks=(2,)).write_full(
        np.array([3, 4], dtype="int32"))
    t1.commit("a")
    t2.commit("b")  # must rebase, not conflict
    s = repo.readonly_session()
    np.testing.assert_array_equal(s.array("a").read(), [1, 2])
    np.testing.assert_array_equal(s.array("b").read(), [3, 4])


def test_overlapping_commits_conflict(repo):
    tx = repo.writable_session()
    tx.create_array("x", shape=(2,), dtype="int32", chunks=(2,)).write_full(
        np.zeros(2, dtype="int32"))
    tx.commit("init")
    t1 = repo.writable_session()
    t2 = repo.writable_session()
    t1.array("x").write_full(np.ones(2, dtype="int32"))
    t2.array("x").write_full(np.full(2, 2, dtype="int32"))
    t1.commit("w1")
    with pytest.raises(ConflictError):
        t2.commit("w2")


def test_group_attr_update_conflicts_with_concurrent_writer(repo):
    tx = repo.writable_session()
    tx.create_group("site", {"name": "KVNX"})
    tx.commit("init")
    t1 = repo.writable_session()
    t2 = repo.writable_session()
    t1.update_group_attrs("site", {"name": "KABC"})
    t2.update_group_attrs("site", {"name": "KXYZ"})
    t1.commit("rename 1")
    with pytest.raises(ConflictError):
        t2.commit("rename 2")
    assert repo.readonly_session().group_attrs("site")["name"] == "KABC"


def test_group_attr_update_survives_disjoint_rebase(repo):
    t1 = repo.writable_session()
    t2 = repo.writable_session()
    t1.update_group_attrs("meta", {"calibrated": True})
    t2.create_array("other/x", shape=(2,), dtype="int32",
                    chunks=(2,)).write_full(np.array([1, 2], dtype="int32"))
    t2.commit("other")          # lands first; t1 must rebase
    t1.commit("meta attrs")
    s = repo.readonly_session()
    assert s.group_attrs("meta")["calibrated"] is True
    np.testing.assert_array_equal(s.array("other/x").read(), [1, 2])


def test_commit_losing_the_swap_on_a_disjoint_array_rebases(tmp_path):
    # the swap itself is raced: a disjoint writer commits between this
    # transaction's snapshot write and its ref swap, so the first swap
    # fails and the commit rebases onto the winner (no ConflictError)
    repo = _series_repo(tmp_path / "r", n=2)
    other = Repository.open(str(tmp_path / "r"))
    orig_cas = repo.store.compare_and_swap
    raced = []

    def racing_cas(key, expected, new):
        if key.startswith("refs/branch.") and not raced:
            raced.append(True)
            t = other.writable_session()
            t.create_array("y", shape=(2,), dtype="float32",
                           chunks=(2,)).write_full(np.ones(2, np.float32))
            raced.append(t.commit("disjoint winner"))
        return orig_cas(key, expected, new)

    tx = repo.writable_session()
    a = tx.resize_array("x", (3, 8))
    a[2] = np.full(8, 7.0, np.float32)
    repo.store.compare_and_swap = racing_cas
    try:
        sid = tx.commit("append 2")
    finally:
        repo.store.compare_and_swap = orig_cas
    assert repo.branch_head() == sid
    info = next(repo.history())
    assert info.parent_id == raced[1] and info.message == "append 2"
    s = repo.readonly_session()
    np.testing.assert_array_equal(s.array("y").read(), [1.0, 1.0])
    np.testing.assert_array_equal(s.array("x")[2], np.full(8, 7.0))


def test_stage_chunk_writes_ahead_and_drops_stale_stats(repo):
    tx = repo.writable_session()
    tx.create_array("x", shape=(4,), dtype="float32", chunks=(4,)).write_full(
        np.arange(4, dtype="float32"))
    tx.commit("v1")
    blob = repo.readonly_session().get_blob(
        repo.readonly_session().chunk_ref("x", (0,)))
    tx = repo.writable_session()
    tx.stage_chunk("x", (0,), blob)
    assert tx.chunk_stats("x", (0,)) is None     # unknown while staged
    tx.commit("raw stage")
    s = repo.readonly_session()
    np.testing.assert_array_equal(s.array("x").read(), np.arange(4))
    assert s.chunk_stats("x", (0,)) is None      # dropped, never stale
    with pytest.raises(PermissionError):
        s.stage_chunk("x", (0,), blob)


# ---------------------------------------------------------------------------
# gc, rollback, history, tags (tests/test_store.py)
# ---------------------------------------------------------------------------

def test_gc_grace_protects_inflight_commit(repo):
    tx = repo.writable_session()
    data = np.arange(8, dtype="float32")
    tx.create_array("wal", shape=(8,), dtype="float32",
                    chunks=(2,)).write_full(data)
    tx._flush_staged_arrays()       # chunks persisted, commit still pending
    repo.gc()                       # concurrent sweep with the grace window
    tx.commit("after gc")
    np.testing.assert_array_equal(repo.readonly_session().array("wal").read(),
                                  data)


def test_gc_grace_survives_dedup_against_old_orphan(repo):
    data = np.arange(6, dtype="float32")
    orphan = repo.writable_session()
    orphan.create_array("x", shape=(6,), dtype="float32",
                        chunks=(6,)).write_full(data)
    orphan._flush_staged_arrays()
    orphan.abort()                     # chunk object left behind
    (chunk_key,) = list(repo.store.list("chunks/"))
    old = repo.store.mtime(chunk_key) - 7200
    os.utime(repo.store._path(chunk_key), (old, old))
    tx = repo.writable_session()
    tx.create_array("x", shape=(6,), dtype="float32",
                    chunks=(6,)).write_full(data)
    tx._flush_staged_arrays()
    removed = repo.gc()                # concurrent gc, default grace
    assert removed["chunks"] == 0, "swept a write-ahead chunk mid-commit"
    tx.commit("after gc")
    np.testing.assert_array_equal(repo.readonly_session().array("x").read(),
                                  data)


def test_gc_zero_grace_sweeps_orphans(repo):
    tx = repo.writable_session()
    tx.create_array("keep", shape=(2,), dtype="int32",
                    chunks=(2,)).write_full(np.array([1, 2], dtype="int32"))
    tx.commit("keep")
    orphan = repo.writable_session()
    orphan.array("keep").write_full(np.array([8, 9], dtype="int32"))
    orphan._flush_staged_arrays()
    orphan.abort()
    before = len(list(repo.store.list("chunks/")))
    removed = repo.gc(grace_seconds=0)
    after = len(list(repo.store.list("chunks/")))
    assert removed["chunks"] >= 1 and after < before
    np.testing.assert_array_equal(repo.readonly_session().array("keep").read(),
                                  [1, 2])


def test_rollback_and_bitwise_reproducibility(repo):
    rng = np.random.default_rng(7)
    day1 = rng.standard_normal((3, 8)).astype("float32")
    day2 = rng.standard_normal((2, 8)).astype("float32")
    tx = repo.writable_session()
    a = tx.create_array("z", shape=(3, 8), dtype="float32", chunks=(1, 8))
    a.write_full(day1)
    sid1 = tx.commit("day1")
    tx = repo.writable_session()
    a = tx.resize_array("z", (5, 8))
    a[3:5] = day2
    sid2 = tx.commit("day2")
    before = repo.readonly_session().array("z").read().tobytes()
    repo.rollback("main", sid1)
    assert repo.branch_head() == sid1
    tx = repo.writable_session()
    a = tx.resize_array("z", (5, 8))
    a[3:5] = day2
    sid2_replayed = tx.commit("day2")
    after = repo.readonly_session().array("z").read().tobytes()
    assert before == after, "replay must be bitwise identical"
    s_a = repo.readonly_session(snapshot_id=sid2)
    s_b = repo.readonly_session(snapshot_id=sid2_replayed)
    assert s_a._doc["manifests"] == s_b._doc["manifests"]
    with pytest.raises(NotFound):
        repo.rollback("main", "no-such-snapshot")


def test_history_and_tags(repo):
    tx = repo.writable_session()
    tx.create_array("x", shape=(1,), dtype="int32", chunks=(1,)).write_full(
        np.array([1], dtype="int32"))
    sid = tx.commit("first")
    repo.tag("v1.0", sid)
    infos = list(repo.history())
    assert all(isinstance(c, CommitInfo) for c in infos)
    assert [c.message for c in infos] == ["first", "repository created"]
    assert infos[0].snapshot_id == sid and infos[0].touched == ["x"]
    assert infos[0].parent_id == infos[1].snapshot_id
    assert repo.tag_head("v1.0") == sid
    np.testing.assert_array_equal(
        repo.readonly_session(tag="v1.0").array("x").read(), [1])
    with pytest.raises(RuntimeError, match="already exists"):
        repo.tag("v1.0", sid)
    with pytest.raises(NotFound):
        repo.tag_head("v2.0")


def test_branches(repo):
    head = repo.branch_head()
    repo.create_branch("dev", head)
    assert repo.branches() == ["dev", "main"]
    tx = repo.writable_session("dev")
    tx.create_array("d", shape=(1,), dtype="int32", chunks=(1,)).write_full(
        np.array([5], dtype="int32"))
    tx.commit("on dev")
    assert repo.branch_head("main") == head
    assert repo.readonly_session(branch="dev").has_array("d")
    assert not repo.readonly_session().has_array("d")
    with pytest.raises(RuntimeError, match="already exists"):
        repo.create_branch("dev", head)


def test_gc_keeps_all_reachable_history(repo):
    tx = repo.writable_session()
    tx.create_array("x", shape=(2,), dtype="int32", chunks=(2,)).write_full(
        np.array([1, 1], dtype="int32"))
    sid1 = tx.commit("v1")
    tx = repo.writable_session()
    tx.array("x").write_full(np.array([2, 2], dtype="int32"))
    tx.commit("v2")
    repo.gc()
    np.testing.assert_array_equal(
        repo.readonly_session(snapshot_id=sid1).array("x").read(), [1, 1])


# ---------------------------------------------------------------------------
# compaction (tests/test_store_compaction.py)
# ---------------------------------------------------------------------------

def test_plan_time_chunks_merges_under_budget():
    assert plan_time_chunks((20, 8), (1, 8), 4, 128) == (4, 8)
    assert plan_time_chunks((20, 8), (1, 8), 4, 1 << 20) == (20, 8)
    assert plan_time_chunks((100, 8), (3, 8), 4, 32 * 10) == (9, 8)
    assert plan_time_chunks((20, 8), (1, 8), 4, 1) == (1, 8)
    assert plan_time_chunks((6, 8), (16, 8), 4, 1 << 20) == (16, 8)
    assert plan_time_chunks((0, 8), (2, 8), 4, 1 << 20) == (2, 8)


def test_volume_profile_is_scan_aligned(tmp_path):
    repo = Repository.create(str(tmp_path / "r"))
    tx = repo.writable_session()
    a = tx.create_array("m", shape=(6, 8, 16), dtype="float32",
                        chunks=(4, 8, 4))
    a.write_full(np.arange(6 * 8 * 16, dtype="float32").reshape(6, 8, 16))
    tx.commit("w")
    before = repo.readonly_session().array("m").read()
    compact(repo, "volume")
    s = repo.readonly_session()
    assert s.array("m").chunks == (1, 8, 16)
    np.testing.assert_array_equal(s.array("m").read(), before)


def test_unknown_profile_and_paths_fail_loudly(tmp_path):
    repo = _series_repo(tmp_path / "r", n=2)
    with pytest.raises(ValueError, match="unknown compaction profile"):
        compact(repo, "nope")
    with pytest.raises(NotFound, match="no such arrays"):
        compact(repo, "timeseries", paths=["y"])
    assert resolve_profile(PROFILES["volume"]) is PROFILES["volume"]


def test_compact_merges_chunks_reads_bitwise(tmp_path):
    repo = _series_repo(tmp_path / "r", n=20)
    s0 = repo.readonly_session()
    before = s0.array("x").read()
    shards_before = len(s0._doc["manifests"]["x"])
    report = repo.compact("timeseries")
    assert report.committed
    (ac,) = report.arrays
    assert ac.reason == "rechunk"
    assert ac.n_chunks_after < ac.n_chunks_before
    s = repo.readonly_session()
    np.testing.assert_array_equal(s.array("x").read(), before)  # bitwise
    assert s.array("x").chunks == (20, 8)
    assert len(s._doc["manifests"]["x"]) < shards_before
    assert s.has_stats("x")
    pruned = s.array("x").scan(value_gt=10.0, prune=True)
    blind = s.array("x").scan(value_gt=10.0, prune=False, pushdown=False)
    np.testing.assert_array_equal(pruned.values, blind.values)
    for a, b in zip(pruned.coords, blind.coords):
        np.testing.assert_array_equal(a, b)


def test_compact_is_noop_second_time_same_snapshot_id(tmp_path):
    repo = _series_repo(tmp_path / "r", n=12)
    first = compact(repo, "timeseries")
    assert first.committed
    second = compact(repo, "timeseries")
    assert not second.committed and not second.arrays
    assert second.snapshot_id == first.snapshot_id
    assert repo.branch_head() == first.snapshot_id


def test_compact_preserves_unwritten_holes(tmp_path):
    repo = Repository.create(str(tmp_path / "r"))
    tx = repo.writable_session()
    a = tx.create_array("x", shape=(8, 4), dtype="float32", chunks=(1, 4))
    a[0] = np.ones(4, dtype="float32")  # rows 1..7 never written
    tx.commit("sparse")
    prof = CompactionProfile("test", target_chunk_bytes=4 * 4 * 4)
    compact(repo, prof)
    s = repo.readonly_session()
    assert s.array("x").chunks == (4, 4)
    assert s.chunk_ref("x", (0, 0)) is not None
    assert s.chunk_ref("x", (1, 0)) is None
    got = s.array("x").read()
    assert (got[0] == 1.0).all() and np.isnan(got[1:]).all()


def test_compact_restricted_to_paths(tmp_path):
    repo = _series_repo(tmp_path / "r", n=6)
    tx = repo.writable_session()
    tx.create_array("y", shape=(6, 8), dtype="float32",
                    chunks=(1, 8)).write_full(np.ones((6, 8), np.float32))
    tx.commit("y")
    _prof, jobs = plan_compaction(repo.readonly_session(), "timeseries",
                                  ["y"])
    assert [j.path for j in jobs] == ["y"]
    report = compact(repo, "timeseries", paths=["y"], read_workers=2)
    assert [a.path for a in report.arrays] == ["y"]
    s = repo.readonly_session()
    assert s.array("y").chunks == (6, 8) and s.array("x").chunks == (1, 8)


def test_rechunk_array_guards(tmp_path):
    repo = _series_repo(tmp_path / "r", n=4)
    tx = repo.writable_session()
    with pytest.raises(NotFound):
        tx.rechunk_array("missing", (4, 8))
    with pytest.raises(ValueError, match="rank"):
        tx.rechunk_array("x", (4,))
    with pytest.raises(ValueError, match="positive"):
        tx.rechunk_array("x", (0, 8))
    tx.array("x")[0] = np.zeros(8, dtype="float32")
    with pytest.raises(RuntimeError, match="staged writes"):
        tx.rechunk_array("x", (4, 8))


def test_compact_racing_append_keeps_both(tmp_path):
    repo = _series_repo(tmp_path / "r", n=6)
    other = Repository.open(str(tmp_path / "r"))
    orig_cas = repo.store.compare_and_swap
    raced = []

    def racing_cas(key, expected, new):
        if key.startswith("refs/branch.") and not raced:
            raced.append(True)
            tx = other.writable_session()
            a = tx.resize_array("x", (7, 8))
            a[6] = np.full(8, 99.0, dtype="float32")
            tx.commit("racing append")
        return orig_cas(key, expected, new)

    repo.store.compare_and_swap = racing_cas
    try:
        report = compact(repo, "timeseries")
    finally:
        repo.store.compare_and_swap = orig_cas
    assert report.committed and report.retries == 1
    got = repo.readonly_session().array("x").read()
    assert got.shape == (7, 8)
    np.testing.assert_array_equal(got[6], np.full(8, 99.0, dtype="float32"))
    np.testing.assert_array_equal(
        got[:6], np.repeat(np.arange(6, dtype="float32")[:, None], 8, axis=1))
    assert repo.readonly_session().array("x").chunks == (7, 8)


def test_compact_gives_up_after_max_retries(tmp_path):
    repo = _series_repo(tmp_path / "r", n=4)
    other = Repository.open(str(tmp_path / "r"))
    orig_cas = repo.store.compare_and_swap
    count = [0]

    def always_raced(key, expected, new):
        if key.startswith("refs/branch."):
            count[0] += 1
            tx = other.writable_session()
            i = repo.readonly_session().array("x").shape[0]
            a = tx.resize_array("x", (i + 1, 8))
            a[i] = np.zeros(8, dtype="float32")
            tx.commit("hot writer")
        return orig_cas(key, expected, new)

    repo.store.compare_and_swap = always_raced
    try:
        with pytest.raises(ConflictError, match="write-hot"):
            compact(repo, "timeseries", max_retries=2)
    finally:
        repo.store.compare_and_swap = orig_cas
    assert count[0] == 3  # initial attempt + max_retries


def test_compact_migrates_v1_flat_manifest(tmp_path):
    repo_v1 = _series_repo(tmp_path / "r", n=10, manifest_format=1)
    old_head = repo_v1.branch_head()
    old_raw = repo_v1.store.get(f"snapshots/{old_head}.json")
    before = repo_v1.readonly_session().array("x").read()
    repo = Repository.open(str(tmp_path / "r"))
    report = compact(repo, "timeseries")
    assert report.committed and report.arrays[0].reason == "rechunk"
    s = repo.readonly_session()
    np.testing.assert_array_equal(s.array("x").read(), before)
    assert isinstance(s._doc["manifests"]["x"], list)
    assert s.has_stats("x")
    assert repo.store.get(f"snapshots/{old_head}.json") == old_raw
    old = repo.readonly_session(snapshot_id=old_head).array("x").read()
    np.testing.assert_array_equal(old, before)


def test_compact_backfills_stats_when_grid_already_optimal(tmp_path):
    repo_v2 = Repository.create(str(tmp_path / "r"), manifest_format=2)
    tx = repo_v2.writable_session()
    a = tx.create_array("z", shape=(4, 4), dtype="float32", chunks=(4, 4))
    a.write_full(np.arange(16, dtype="float32").reshape(4, 4))
    tx.commit("v2 write")
    entry_before = repo_v2.readonly_session()._doc["manifests"]["z"]
    chunks_before = _chunk_objects(repo_v2)
    repo = Repository.open(str(tmp_path / "r"))
    report = compact(repo, "timeseries")
    assert report.committed and report.arrays[0].reason == "stats"
    s = repo.readonly_session()
    assert s.has_stats("z")
    assert s._doc["manifests"]["z"] == entry_before
    assert _chunk_objects(repo) == chunks_before
    pruned = s.array("z").scan(value_gt=14.0, prune=True)
    blind = s.array("z").scan(value_gt=14.0, prune=False, pushdown=False)
    np.testing.assert_array_equal(pruned.values, blind.values)


def test_gc_after_compaction_sweeps_only_superseded(tmp_path):
    repo = _series_repo(tmp_path / "r", n=16)
    before = repo.readonly_session().array("x").read()
    compact(repo, "timeseries")
    assert repo.gc(grace_seconds=0) == {
        "snapshots": 0, "manifests": 0, "stats": 0, "chunks": 0}
    head = repo.branch_head()
    live = {f"chunks/{key}"
            for key in repo.readonly_session()._manifest("x").values()}
    removed = repo.gc(grace_seconds=0, keep_history=False)
    assert removed["chunks"] > 0 and removed["snapshots"] > 0
    assert _chunk_objects(repo) == live
    assert repo.branch_head() == head
    np.testing.assert_array_equal(repo.readonly_session().array("x").read(),
                                  before)
    infos = list(repo.history())
    assert len(infos) == 1 and infos[0].snapshot_id == head


def test_commit_rebase_over_expired_ancestry_raises_conflict(tmp_path):
    repo = _series_repo(tmp_path / "r", n=2)
    other = Repository.open(str(tmp_path / "r"))
    tx = repo.writable_session()
    tx.create_array("y", shape=(1,), dtype="float32", chunks=(1,))
    for i in (2, 3):
        t2 = other.writable_session()
        a = t2.resize_array("x", (i + 1, 8))
        a[i] = np.zeros(8, dtype="float32")
        t2.commit(f"append {i}")
    other.gc(grace_seconds=0, keep_history=False)
    with pytest.raises(ConflictError, match="expired by gc"):
        tx.commit("stale transaction")


def test_gc_keep_history_respects_tags(tmp_path):
    repo = _series_repo(tmp_path / "r", n=8)
    repo.tag("pre-compact", repo.branch_head())
    compact(repo, "timeseries")
    repo.gc(grace_seconds=0, keep_history=False)
    got = repo.readonly_session(tag="pre-compact").array("x").read()
    np.testing.assert_array_equal(got,
                                  repo.readonly_session().array("x").read())


def test_catalog_note_snapshot_unknown_repo(tmp_path):
    catalog = Catalog.create(str(tmp_path / "cat"))
    with pytest.raises(KeyError, match="not in catalog"):
        catalog.note_snapshot("nope", "abc")


def test_compact_closes_every_attempt_transaction(tmp_path, monkeypatch):
    repo = _series_repo(tmp_path / "store", n=12)
    created, closed = [], []
    state = {"fail_once": True}
    real = Repository.writable_session

    def spying(self, branch="main", **kw):
        tx = real(self, branch, **kw)
        created.append(tx)
        orig_close, orig_commit = tx.close, tx.commit

        def close_():
            closed.append(tx)
            orig_close()

        def commit_(message=None):
            if state.pop("fail_once", None):
                raise ConflictError("injected: concurrent append won")
            return orig_commit(message)

        tx.close, tx.commit = close_, commit_
        return tx

    monkeypatch.setattr(Repository, "writable_session", spying)
    report = compact(repo, "timeseries", read_workers=2)
    assert report.committed and report.retries == 1
    compact(repo, "timeseries", read_workers=2)   # idempotent no-op path
    assert len(created) == 3                      # retry + commit + no-op
    assert [id(t) for t in closed] == [id(t) for t in created]
    assert all(t._own_pool is None for t in created)


# ---------------------------------------------------------------------------
# the two packages on the same operations
# ---------------------------------------------------------------------------

def _maintenance_script(cls, root, compact_fn):
    """Commits, a tag, a compaction, a rollback, a replay and a
    history-expiring gc; returns every snapshot id in order."""
    repo = _series_repo(root, n=10, cls=cls)
    ids = [c.snapshot_id for c in repo.history()]
    repo.tag("v1", repo.branch_head())
    report = compact_fn(repo, "timeseries")
    ids.append(report.snapshot_id)
    tx = repo.writable_session()
    a = tx.resize_array("x", (11, 8))
    a[10] = np.full(8, 10.0, np.float32)
    tx.update_group_attrs("meta", {"station": "KVNX"})
    ids.append(tx.commit("append after compaction"))
    repo.rollback("main", repo.tag_head("v1"))
    ids.append(repo.branch_head())
    tx = repo.writable_session()
    a = tx.resize_array("x", (11, 8))
    a[10] = np.full(8, 10.0, np.float32)
    ids.append(tx.commit("replay"))
    ids.append(compact_fn(repo, "volume").snapshot_id)
    repo.gc(grace_seconds=0, keep_history=False)
    ids.append(repo.branch_head())
    return ids


def test_both_packages_give_the_same_snapshot_ids(tmp_path):
    ref_ids = _maintenance_script(RefRepository, tmp_path / "ref",
                                  ref_compact)
    port_ids = _maintenance_script(Repository, tmp_path / "port", compact)
    assert port_ids == ref_ids
    assert len(set(port_ids)) > 10
    # and the objects left after gc are the same, byte for byte
    ref_store, port_store = (ObjectStore(str(tmp_path / w))
                             for w in ("ref", "port"))
    ref_keys = sorted(k for k in ref_store.list("")
                      if not k.startswith("snapshots/"))
    assert ref_keys == sorted(k for k in port_store.list("")
                              if not k.startswith("snapshots/"))
    for key in ref_keys:
        assert ref_store.get(key) == port_store.get(key), key


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_each_package_reads_the_others_compacted_archive(tmp_path, writer):
    src = tmp_path / "src"
    cls, fn = ((RefRepository, ref_compact) if writer == "ref"
               else (Repository, compact))
    repo = _series_repo(src, n=12, cls=cls)
    before = repo.readonly_session().array("x").read()
    fn(repo, "timeseries", read_workers=2)
    shutil.copytree(src, tmp_path / "copy")
    head = repo.branch_head()
    for reader in (RefRepository, Repository):
        other = reader.open(str(tmp_path / "copy"))
        assert other.branch_head() == head
        s = other.readonly_session()
        got = s.array("x").read()
        assert got.tobytes() == before.tobytes()
        assert s.array("x").chunks == (12, 8)
        assert [c.message for c in other.history()][:2] == [
            "compact profile=timeseries arrays=1", "append 11"]


# ---------------------------------------------------------------------------
# SimulatedLatencyStore and the snapshot hint (tests/test_remote_store.py)
# ---------------------------------------------------------------------------

def sim_store(tmp_path, name="store", **kw):
    kw.setdefault("sleep", False)
    return SimulatedLatencyStore(ObjectStore(str(tmp_path / name)), **kw)


def build_repo(store, *, n_time=12, n_cols=32, time_chunk=2, paths=("x",)):
    repo = Repository.create(store)
    tx = repo.writable_session()
    rng = np.random.default_rng(7)
    data = {}
    for p in paths:
        a = tx.create_array(p, shape=(n_time, n_cols), dtype="float32",
                            chunks=(time_chunk, n_cols))
        data[p] = rng.standard_normal((n_time, n_cols)).astype(np.float32)
        a.write_full(data[p])
    tx.commit("seed")
    return repo, data


def test_backends_satisfy_the_protocol(tmp_path):
    assert isinstance(ObjectStore(str(tmp_path / "a")), Backend)
    assert isinstance(sim_store(tmp_path), Backend)


def test_sim_store_delegates_backend_semantics(tmp_path):
    sim = sim_store(tmp_path)
    assert sim.put("a/b", b"one") is True
    assert sim.put("a/b", b"one", if_not_exists=True) is False
    assert sim.get("a/b") == b"one"
    assert sim.exists("a/b") and not sim.exists("a/c")
    assert sim.mtime("a/b") > 0
    assert sorted(sim.list("a/")) == ["a/b"]
    assert sim.compare_and_swap("ref", None, b"v1") is True
    assert sim.compare_and_swap("ref", b"stale", b"v2") is False
    assert sim.compare_and_swap("ref", b"v1", b"v2") is True
    assert sim.get("ref") == b"v2"
    sim.delete("a/b")
    sim.delete("a/b")                       # idempotent
    with pytest.raises(KeyError):
        sim.get("a/b")
    with pytest.raises(KeyError):
        sim.mtime("a/b")


def test_sim_store_counts_round_trips(tmp_path):
    sim = sim_store(tmp_path, rtt_s=0.05, bandwidth_bps=100.0)
    sim.put("k1", b"xxxx")
    sim.put("k2", b"yyyy")
    sim.reset_stats()
    sim.get("k1")
    got = sim.get_many(["k1", "k2"])
    assert list(got) == ["k1", "k2"]
    stats = sim.stats()
    assert stats["get_requests"] == 2
    assert stats["keys_fetched"] == 3
    assert stats["bytes_fetched"] == 12
    assert stats["coalesce_keys_per_get"] == pytest.approx(1.5)
    assert stats["simulated_s"] == pytest.approx(2 * 0.05 + 12 / 100.0)
    sim.exists("k1")
    sim.mtime("k1")
    sim.delete("k2")
    assert sim.stats()["meta_requests"] == 3
    sim.reset_stats()
    zero = sim.stats()
    assert zero["get_requests"] == zero["keys_fetched"] == 0
    assert zero["simulated_s"] == 0.0
    assert zero["coalesce_keys_per_get"] == 0.0


def test_sim_store_empty_batch_is_free(tmp_path):
    sim = sim_store(tmp_path)
    assert sim.get_many([]) == {}
    assert sim.stats()["get_requests"] == 0


def test_repository_accepts_backend_objects(tmp_path):
    repo, data = build_repo(sim_store(tmp_path))
    assert isinstance(repo.store, SimulatedLatencyStore)
    again = Repository.open(str(tmp_path / "store"))
    with again.readonly_session() as s:
        np.testing.assert_array_equal(s.array("x")[:], data["x"])


def test_snapshot_hint_opens_in_one_round_trip(tmp_path):
    sim = sim_store(tmp_path)
    repo, data = build_repo(sim)
    head = repo.branch_head()
    sim.reset_stats()
    with repo.readonly_session(snapshot_hint=head) as s:
        assert s.snapshot_id == head
        assert sim.stats()["get_requests"] == 1
        np.testing.assert_array_equal(s.array("x")[:], data["x"])
    sim.reset_stats()
    with repo.readonly_session() as s:            # unhinted: two serial GETs
        assert s.snapshot_id == head
        assert sim.stats()["get_requests"] == 2


def test_stale_snapshot_hint_degrades_to_head(tmp_path):
    sim = sim_store(tmp_path)
    repo, _ = build_repo(sim)
    stale = repo.branch_head()
    tx = repo.writable_session()
    tx.array("x").write_full(np.zeros((12, 32), np.float32))
    tx.commit("advance")
    head = repo.branch_head()
    sim.reset_stats()
    with repo.readonly_session(snapshot_hint=stale) as s:
        assert s.snapshot_id == head
        assert sim.stats()["get_requests"] == 2
        assert float(s.array("x")[0, 0]) == 0.0


def test_vanished_snapshot_hint_falls_back(tmp_path):
    sim = sim_store(tmp_path)
    repo, data = build_repo(sim)
    head = repo.branch_head()
    with repo.readonly_session(snapshot_hint="no-such-snapshot") as s:
        assert s.snapshot_id == head
        np.testing.assert_array_equal(s.array("x")[:], data["x"])


def test_catalog_open_session_uses_entry_hint(tmp_path):
    sim = sim_store(tmp_path)
    repo, _ = build_repo(sim)
    catalog = Catalog.create(str(tmp_path / "catalog"))
    catalog.register_repository(repo, repo_id="R")
    head = repo.branch_head()
    sim.reset_stats()
    with catalog.open_session("R") as s:
        assert s.snapshot_id == head
        assert sim.stats()["get_requests"] == 1


@pytest.mark.parametrize("read_workers", [1, 4])
def test_remote_read_equals_the_local_read_bitwise(tmp_path, read_workers):
    sim = sim_store(tmp_path)
    repo, data = build_repo(sim, n_time=16, time_chunk=2)
    local = Repository.open(str(tmp_path / "store"))
    with local.readonly_session() as s:
        want = s.array("x")[:]
    sim.reset_stats()
    with repo.readonly_session(read_workers=read_workers) as s:
        s.prefetch(["x"])
        got = s.array("x")[:]
    assert got.tobytes() == want.tobytes() == data["x"].tobytes()
    stats = sim.stats()
    # 8 chunks in one coalesced batch, beside the ref, snapshot and shard
    assert stats["keys_fetched"] >= 8
    assert stats["get_requests"] < stats["keys_fetched"]

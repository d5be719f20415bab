"""The port's own store against the reference package's: same bytes.

For this system an archive takes the place of a model's weights: the
state the port carries across.  The same simulator volumes appended
through ``repro.core.RadarArchive`` and ``repro_torch.core.RadarArchive``
must give identical snapshot ids, and each package must read the other's
archive back bitwise.
"""

import shutil

import pytest

pytest.importorskip("torch")

from repro.core import RadarArchive as RefArchive  # noqa: E402
from repro.core import fm301 as ref_fm301  # noqa: E402
from repro.etl import StormSimulator as RefSimulator  # noqa: E402
from repro.store import Repository as RefRepository  # noqa: E402
from repro_torch.core import RadarArchive, fm301  # noqa: E402
from repro_torch.etl import StormSimulator  # noqa: E402
from repro_torch.store import ConflictError, Repository  # noqa: E402

T0 = 1305849600.0
N_SCANS = 20
# 24 azimuths x 300 gates: two range chunks (256 + a ragged 44)
VCP = fm301.VCPDef(212, (0.5, 19.5), 24, 300, 250.0, 270.0)
REF_VCP = ref_fm301.VCPDef(212, (0.5, 19.5), 24, 300, 250.0, 270.0)


def _volumes(sim, site, vcp, n=N_SCANS, start=0):
    return [sim.volume(site, vcp, T0 + i * vcp.interval_s)
            for i in range(start, start + n)]


@pytest.fixture(scope="module")
def ref_volumes():
    return _volumes(RefSimulator(seed=5), ref_fm301.SITES["KVNX"], REF_VCP)


@pytest.fixture(scope="module")
def port_volumes():
    return _volumes(StormSimulator(seed=5), fm301.SITES["KVNX"], VCP)


def test_simulator_volumes_bitwise_identical(ref_volumes, port_volumes):
    for ref_vol, vol in zip(ref_volumes, port_volumes):
        assert ref_vol["time"] == vol["time"]
        for ref_sw, sw in zip(ref_vol["sweeps"], vol["sweeps"]):
            for key in ("azimuth", "range"):
                assert ref_sw[key].tobytes() == sw[key].tobytes()
            assert ref_sw["moments"].keys() == sw["moments"].keys()
            for name, arr in ref_sw["moments"].items():
                assert arr.tobytes() == sw["moments"][name].tobytes(), name


@pytest.mark.parametrize("time_chunk", [None, 2])
def test_per_scan_commits_give_identical_snapshot_ids(
        tmp_path, ref_volumes, port_volumes, time_chunk):
    """time_chunk=2 spreads the time axis over two manifest shards."""
    ref_arch = RefArchive(RefRepository.create(str(tmp_path / "ref")),
                          time_chunk=time_chunk)
    arch = RadarArchive(Repository.create(str(tmp_path / "port")),
                        time_chunk=time_chunk)
    assert ref_arch.repo.branch_head() == arch.repo.branch_head()
    for ref_vol, vol in zip(ref_volumes, port_volumes):
        assert ref_arch.append_scan(ref_vol) == arch.append_scan(vol)


@pytest.mark.parametrize("codec, encode_workers", [(None, 1), ("lzma", 4)])
def test_batched_commit_gives_identical_snapshot_id(
        tmp_path, ref_volumes, port_volumes, codec, encode_workers):
    ref_repo = RefRepository.create(str(tmp_path / "ref"))
    repo = Repository.create(str(tmp_path / "port"))
    ref_tx = ref_repo.writable_session()
    tx = repo.writable_session()
    tx.encode_workers = encode_workers
    for ref_vol, vol in zip(ref_volumes, port_volumes):
        RefArchive(ref_repo, codec=codec).append_scan(ref_vol, tx=ref_tx,
                                                      commit=False)
        assert RadarArchive(repo, codec=codec).append_scan(
            vol, tx=tx, commit=False) is None
    assert ref_tx.commit("batch") == tx.commit("batch")


@pytest.fixture(scope="module")
def two_archives(tmp_path_factory, ref_volumes, port_volumes):
    """The same volumes as one archive per package (time_chunk=4, so reads
    cross time-chunk and range-chunk edges)."""
    root = tmp_path_factory.mktemp("archives")
    ref_arch = RefArchive(RefRepository.create(str(root / "ref")),
                          time_chunk=4)
    arch = RadarArchive(Repository.create(str(root / "port")), time_chunk=4)
    for ref_vol, vol in zip(ref_volumes, port_volumes):
        ref_arch.append_scan(ref_vol)
        arch.append_scan(vol)
    return str(root / "ref"), str(root / "port")


ARRAYS = ["VCP-212/time"] + [
    f"VCP-212/sweep_{s}/{name}" for s in (0, 1)
    for name in ("DBZH", "RHOHV", "azimuth", "range")
]
GROUPS = ["", "VCP-212", "VCP-212/sweep_0", "VCP-212/sweep_1"]


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_each_package_reads_the_others_archive_bitwise(two_archives, writer):
    ref_path, port_path = two_archives
    path = ref_path if writer == "ref" else port_path
    ref_session = RefRepository.open(path).readonly_session()
    session = Repository.open(path).readonly_session(read_workers=3)
    assert session.snapshot_id == ref_session.snapshot_id
    assert session.list_arrays() == ref_session.list_arrays()
    for group in GROUPS:
        assert session.group_attrs(group) == ref_session.group_attrs(group)
    for apath in ARRAYS:
        ref_arr, arr = ref_session.array(apath), session.array(apath)
        assert arr.meta.to_doc() == ref_arr.meta.to_doc()
        want = ref_arr.read()
        got = arr.read()
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes(), apath
        if got.ndim == 3:  # a partial read across chunk edges
            sel = (slice(3, 13), slice(None), slice(250, 290))
            assert arr[sel].tobytes() == ref_arr[sel].tobytes()
            assert arr[7].tobytes() == ref_arr[7].tobytes()
    session.close()


@pytest.mark.parametrize("manifest_format", [1, 2])
def test_port_reads_and_extends_older_formats(tmp_path, ref_volumes,
                                              port_volumes, manifest_format):
    """An archive written in snapshot format v1/v2 reads back bitwise, and
    appending to it (shard split + stat backfill) lands on the snapshot id
    the reference's own writer produces."""
    base = tmp_path / "old"
    old = RefArchive(RefRepository.create(str(base),
                                          manifest_format=manifest_format),
                     time_chunk=4)
    for vol in ref_volumes[:6]:
        old.append_scan(vol)
    ref_copy, port_copy = tmp_path / "ref", tmp_path / "port"
    shutil.copytree(base, ref_copy)
    shutil.copytree(base, port_copy)
    session = Repository.open(str(port_copy)).readonly_session()
    ref_session = RefRepository.open(str(base)).readonly_session()
    for apath in ARRAYS:
        assert (session.array(apath).read().tobytes()
                == ref_session.array(apath).read().tobytes())
    ref_sid = RefArchive(RefRepository.open(str(ref_copy)),
                         time_chunk=4).append_scan(ref_volumes[6])
    sid = RadarArchive(Repository.open(str(port_copy)),
                       time_chunk=4).append_scan(port_volumes[6])
    assert sid == ref_sid


def test_losing_the_ref_swap_raises_conflict(tmp_path, port_volumes):
    repo = Repository.create(str(tmp_path / "port"))
    arch = RadarArchive(repo)
    first, second = repo.writable_session(), repo.writable_session()
    arch.append_scan(port_volumes[0], tx=first, commit=False)
    arch.append_scan(port_volumes[1], tx=second, commit=False)
    head = first.commit("first")
    with pytest.raises(ConflictError):
        second.commit("second")
    assert repo.branch_head() == head

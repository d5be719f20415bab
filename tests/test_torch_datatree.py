"""The port's lazy DataTree view against the reference package's.

``tree_from_session`` builds the same hierarchy over the same archive in
both packages (groups, variables, dims, attrs, shapes), reads the same
values, and ``Variable.where`` pushes its predicate down to the chunk
statistics and finds the same matches, lazily and eagerly.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import datatree as jdt  # noqa: E402
from repro.store import Repository as JRepo  # noqa: E402
from repro_torch import etl  # noqa: E402
from repro_torch.core import (DataTree, RadarArchive, Variable,  # noqa: E402
                              tree_from_session)
from repro_torch.store import ObjectStore, Repository  # noqa: E402


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    root = tmp_path_factory.mktemp("dt")
    raw = ObjectStore(str(root / "raw"))
    etl.generate_raw_archive(raw, n_scans=4, n_az=36, n_gates=64,
                             n_sweeps=3, seed=2)
    repo = Repository.create(str(root / "repo"))
    etl.ingest(raw, repo, workers=2, batch_size=2, time_chunk=2)
    return repo, str(root / "repo")


@pytest.fixture(scope="module")
def trees(archive):
    repo, path = archive
    return (tree_from_session(repo.readonly_session()),
            jdt.tree_from_session(JRepo.open(path).readonly_session()))


def _paths(tree):
    return [(p, sorted(n.variables), sorted(n.attrs)) for p, n in
            tree.subtree()]


def test_tree_structure_equals_the_reference(trees):
    tree, jtree = trees
    assert _paths(tree) == _paths(jtree)
    for (path, node), (_jp, jnode) in zip(tree.subtree(), jtree.subtree()):
        assert node.attrs == jnode.attrs and node.path == jnode.path
        for name, var in node.variables.items():
            jvar = jnode.variables[name]
            assert var.dims == jvar.dims and var.shape == jvar.shape
            assert var.dtype == jvar.dtype and var.attrs == jvar.attrs
            assert var.lazy and repr(var) == repr(jvar)
    assert repr(tree) == repr(jtree)


@pytest.mark.parametrize("path, key", [
    ("VCP-212/time", slice(None)),
    ("VCP-212/sweep_0/DBZH", (slice(1, 3), slice(None), slice(10, 40))),
    ("VCP-212/sweep_2/ZDR", (3,)),
    ("VCP-212/sweep_1/azimuth", slice(None)),
])
def test_reads_equal_the_reference(trees, path, key):
    tree, jtree = trees
    np.testing.assert_array_equal(tree[path][key], jtree[path][key])
    np.testing.assert_array_equal(tree[path].values(), jtree[path].values())


@pytest.mark.parametrize("selection, gt, lt", [
    (None, 30.0, None), (None, None, -5.0),
    ((slice(1, 4), slice(0, 20)), 10.0, 40.0),
    ((slice(0, 2),), None, None)])
@pytest.mark.parametrize("prune", [True, False])
def test_where_equals_the_reference_lazy_and_eager(trees, selection, gt, lt,
                                                   prune):
    tree, jtree = trees
    var, jvar = tree["VCP-212/sweep_0/DBZH"], jtree["VCP-212/sweep_0/DBZH"]
    coords, values = var.where(selection, value_gt=gt, value_lt=lt,
                               prune=prune)
    jcoords, jvalues = jvar.where(selection, value_gt=gt, value_lt=lt,
                                  prune=prune)
    for a, b in zip(coords, jcoords):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(values, jvalues)
    eager = Variable(var.dims, var.values(), dict(var.attrs))
    ecoords, evalues = eager.where(selection, value_gt=gt, value_lt=lt)
    jeager = jdt.Variable(jvar.dims, jvar.values(), dict(jvar.attrs))
    jecoords, jevalues = jeager.where(selection, value_gt=gt, value_lt=lt)
    for a, b in zip(ecoords, jecoords):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(evalues, jevalues)
    # lazy (chunk-major) and eager (row-major) find the same set
    assert set(zip(*coords)) == set(zip(*ecoords))
    assert sorted(values.tolist()) == sorted(evalues.tolist())


def test_where_strided_raises_on_both_backends(trees):
    tree, _jtree = trees
    var = tree["VCP-212/sweep_0/DBZH"]
    with pytest.raises(NotImplementedError):
        var.where((slice(0, 3, 2),), value_gt=0.0)
    eager = Variable(var.dims, var.values(), dict(var.attrs))
    with pytest.raises(NotImplementedError):
        eager.where((slice(0, 3, 2),), value_gt=0.0)


def test_archive_tree_follows_snapshots_and_tags(archive):
    repo, _path = archive
    arch = RadarArchive(repo)
    history = list(repo.history())
    old = arch.tree(snapshot_id=history[-2].snapshot_id)
    assert old["VCP-212/time"].shape == (2,)
    assert arch.tree()["VCP-212/time"].shape == (4,)
    repo.tag("first-batch", history[-2].snapshot_id)
    assert arch.tree(tag="first-batch")["VCP-212/sweep_0/DBZH"].shape[0] == 2


def test_datatree_navigation():
    root = DataTree("", attrs={"site": "KVNX"})
    node = root.add_child("VCP-212").add_child("sweep_0")
    assert root.add_child("VCP-212") is root["VCP-212"]
    node.set_variable("DBZH", Variable(("azimuth",), np.arange(3.0)))
    assert root["VCP-212/sweep_0/DBZH"].values().tolist() == [0.0, 1.0, 2.0]
    assert "VCP-212/sweep_0" in root and "VCP-31" not in root
    assert node.path == "VCP-212/sweep_0"
    assert [p for p, _n in root.subtree()] == ["", "VCP-212",
                                               "VCP-212/sweep_0"]
    assert not root["VCP-212/sweep_0/DBZH"].lazy
    with pytest.raises(KeyError, match="missing"):
        root["VCP-212/DBZH"]

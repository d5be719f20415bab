"""The port's sharding rules against the reference's, leaf by leaf.

For every architecture (``ARCHS`` and ``EXTRA_ARCHS``) on the reference's
meshes ``(16, 16)`` and ``(2, 16, 16)`` and the port's H100 production
meshes ``(32, 8)`` and ``(2, 32, 8)`` (device-less on both sides:
``repro.jaxcompat.abstract_mesh`` and ``repro_torch.launch.mesh.
abstract_mesh``): the parameter specs, the serving caches' specs and the
batches' specs equal the reference's entry by entry; a spec's placements
on a ``DeviceMesh``; and the bytes one device holds by the port's rules
equal the arithmetic of the reference's specs.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import EXTRA_ARCHS as JEXTRA  # noqa: E402
from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs.base import ParallelConfig as JaxPCfg  # noqa: E402
from repro.data.batches import input_specs as jinput_specs  # noqa: E402
from repro.distributed import sharding as JS  # noqa: E402
from repro.jaxcompat import abstract_mesh as jabstract_mesh  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import SHAPES, get_any_config  # noqa: E402
from repro_torch.configs.base import ParallelConfig  # noqa: E402
from repro_torch.data.batches import input_specs  # noqa: E402
from repro_torch.distributed import sharding as S  # noqa: E402
from repro_torch.launch.mesh import abstract_mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

ALL_ARCHS = sorted(JARCHS) + sorted(JEXTRA)
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "32x8": ((32, 8), ("data", "model")),
          "2x32x8": ((2, 32, 8), ("pod", "data", "model"))}
PCFG = ParallelConfig()
JPCFG = JaxPCfg()


def _meshes(name):
    sizes, names = MESHES[name]
    return jabstract_mesh(sizes, names), abstract_mesh(sizes, names)


def _ref_paths(tree):
    """``{path: spec tuple}`` of a reference sharding tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: hasattr(x, "spec"))
    out = {}
    for kp, sh in flat:
        parts = [str(k.key) if hasattr(k, "key") else str(k.idx) for k in kp]
        spec = tuple(sh.spec)
        out["/".join(parts)] = spec
    return out


def _port_paths(tree, prefix=""):
    """``{path: spec tuple}`` of a port spec tree."""
    out = {}
    if isinstance(tree, dict):
        for k in tree:
            out.update(_port_paths(tree[k], f"{prefix}/{k}" if prefix
                                   else str(k)))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(_port_paths(v, f"{prefix}/{i}" if prefix else str(i)))
    else:
        out[prefix] = tree
    return out


def _pad(spec, ndim):
    """The reference's PartitionSpec may be shorter than the rank."""
    return tuple(spec) + (None,) * (ndim - len(spec))


_PARAMS = {}


def _params(arch):
    if arch not in _PARAMS:
        jcfg = (JARCHS.get(arch) or JEXTRA[arch])
        _PARAMS[arch] = (jcfg, JM.param_specs(jcfg),
                         M.param_specs(get_any_config(arch)))
    return _PARAMS[arch]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_specs_equal_the_reference_leaf_by_leaf(arch, mesh):
    jcfg, jspecs, tspecs = _params(arch)
    jmesh, tmesh = _meshes(mesh)
    want = _ref_paths(JS.param_shardings(jcfg, JPCFG, jspecs, jmesh))
    got = _port_paths(S.param_shardings(get_any_config(arch), PCFG, tspecs,
                                        tmesh))
    assert set(got) == set(want)
    shapes = {p: tuple(t.shape) for p, t in _port_paths(tspecs).items()}
    n_model = 0
    for path, spec in want.items():
        assert got[path] == _pad(spec, len(shapes[path])), path
        n_model += "model" in str(spec)
    assert n_model >= 4, f"{arch}: only {n_model} TP leaves"


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cache_and_batch_specs_equal_the_reference(arch, mesh):
    jcfg = JARCHS.get(arch) or JEXTRA[arch]
    tcfg = get_any_config(arch)
    jmesh, tmesh = _meshes(mesh)
    for shape in ("decode_32k", "long_500k"):
        B, L = JSHAPES[shape].global_batch, JSHAPES[shape].seq_len
        jc = jax.eval_shape(lambda: JM.init_caches(jcfg, JPCFG, batch=B,
                                                   max_len=L))
        tc = M.init_caches(tcfg, PCFG, B, L, device="meta")
        want = _ref_paths(JS.cache_shardings(jmesh, jc))
        got = _port_paths(S.cache_shardings(tmesh, tc))
        tshapes = {p: tuple(t.shape) for p, t in _port_paths(tc).items()}
        assert set(got) == set(want)
        for path, spec in want.items():
            assert got[path] == _pad(spec, len(tshapes[path])), (shape, path)
    for shape in sorted(JSHAPES):
        want = _ref_paths(JS.batch_shardings(
            jmesh, jinput_specs(jcfg, JSHAPES[shape])))
        tb = input_specs(tcfg, SHAPES[shape])
        got = S.batch_shardings(tmesh, tb)
        assert set(got) == set(want)
        for k, spec in want.items():
            assert got[k] == _pad(spec, len(tb[k].shape)), (shape, k)


@pytest.mark.parametrize("mesh", ["32x8", "2x32x8"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_per_device_param_bytes_follow_the_reference_specs(arch, mesh):
    """The dry run's per-device parameter bytes (the port's rules) equal
    the bytes the reference's specs leave on one device."""
    jcfg, jspecs, tspecs = _params(arch)
    jmesh, tmesh = _meshes(mesh)
    sizes = dict(zip(MESHES[mesh][1], MESHES[mesh][0]))
    flat, _ = jax.tree_util.tree_flatten_with_path(jspecs)
    shard = _ref_paths(JS.param_shardings(jcfg, JPCFG, jspecs, jmesh))
    want = 0
    for kp, leaf in flat:
        path = "/".join(str(k.key) if hasattr(k, "key") else str(k.idx)
                        for k in kp)
        split = 1
        for entry in shard[path]:
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                split *= sizes[a] if a else 1
        want += math.prod(leaf.shape) * np.dtype(leaf.dtype).itemsize // split
    specs = S.param_shardings(get_any_config(arch), PCFG, tspecs, tmesh)
    assert S.per_device_bytes(tspecs, specs, tmesh) == want


def test_placements_shard_one_dim_over_two_axes_in_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    class _Mesh:                       # only the names placements reads
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 4, 2)

    spec = (None, ("pod", "data"), "model")
    assert S.placements(spec, _Mesh()) == [Shard(1), Shard(1), Shard(2)]
    assert S.placements((None, None), _Mesh()) == [Replicate()] * 3
    mesh = abstract_mesh((2, 4, 2), ("pod", "data", "model"))
    assert S.local_shape((6, 16, 10), spec, mesh) == (6, 2, 5)


def test_replicated_and_the_cache_dims_mirror_the_reference():
    assert S._CACHE_DIMS == JS._CACHE_DIMS
    assert (S._COL, S._ROW, S._BIAS_COL, S._HEAD_LEADING, S._MOE_EXPERT) == (
        JS._COL, JS._ROW, JS._BIAS_COL, JS._HEAD_LEADING, JS._MOE_EXPERT)
    tree = {"a": torch.zeros(2, 3), "b": [torch.zeros(4)]}
    assert S.replicated(None, tree) == {"a": (), "b": [()]}

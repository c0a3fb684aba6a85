"""``distributed/sharding.py`` against ``repro.distributed.sharding``, on
the production meshes' axis sizes (16 x 16 ``data, model`` and 2 x 16 x
16 ``pod, data, model``), for all 10 architectures:

  * every parameter: the port's spec of each per-block tensor equals the
    reference's ``param_pspec`` of the stacked leaf it stacks into
    (``models.convert.stack_plan``), less the stacked leaf's leading dims
    (which the reference's rules leave replicated);
  * every cache tensor at decode_32k and long_500k: ``cache_pspec``
    likewise, the port's cache leaf matched to the reference's by its
    path of keys;
  * ``input_pspec`` for the three replication modes;
  * the per-device argument bytes of ``launch/dryrun.py`` equal the sum
    over the reference's abstract leaves of each leaf's bytes over its
    sharded axes' sizes (the reference's cache also holds each ring's
    ``idx`` as an int32 array, the port's as a host int: those leaves are
    left out of the reference's sum);
  * the specs as DTensor placements, and ``constrain_batch`` a no-op
    without a mesh.

All exact (integer bookkeeping)."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.distributed import sharding as js
from repro.models import api as japi
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.configs.base import MULTI_POD, SINGLE_POD, MeshConfig
from repro_torch.distributed import parallel, sharding
from repro_torch.launch import dryrun
from repro_torch.models import api, convert

MESHES = {"16x16": SINGLE_POD, "2x16x16": MULTI_POD}
REPLICA_SPLIT = MeshConfig((2, 8, 16), ("rep", "data", "model"))


def _logical(mesh_cfg):
    return dryrun.LogicalMesh(mesh_cfg.axes, mesh_cfg.shape)


def _sizes(mesh_cfg):
    return dict(zip(mesh_cfg.axes, mesh_cfg.shape))


class _JaxMesh:
    """What the reference's spec functions read of a mesh."""

    def __init__(self, mesh_cfg):
        self.axis_names = tuple(mesh_cfg.axes)
        self.devices = np.empty(tuple(mesh_cfg.shape))


def _ref_specs(tree, fn):
    return {tuple(js._path_names(p)): (tuple(fn(p, leaf)), leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch, mesh):
    sizes = _sizes(MESHES[mesh])
    model = api.build_model(ARCHS[arch], device="meta")
    shapes = {k: tuple(p.shape) for k, p in model.state_dict().items()}
    ref = _ref_specs(japi.abstract_state(JARCHS[arch]),
                     lambda p, leaf: js.param_pspec(p, leaf, sizes))
    plan = convert.stack_plan(shapes)
    assert set(plan) == set(ref)
    n = 0
    for path, members in plan.items():
        spec, leaf = ref[path]
        for idx, name in members:
            mine = sharding.param_pspec(name, shapes[name], sizes)
            assert mine == spec[len(idx):], (name, mine, spec)
            assert leaf.shape[len(idx):] == shapes[name]
            n += 1
    assert n == len(shapes)


# long_500k is a cell only for the sub-quadratic archs
CACHE_CELLS = [(a, s) for a in ARCHS for s in ("decode_32k", "long_500k")
               if s == "decode_32k" or ARCHS[a].is_subquadratic]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch,shape", CACHE_CELLS)
def test_cache_specs_equal_the_reference(arch, shape, mesh):
    cfg = ARCHS[arch]
    sh = SHAPES[shape]
    sizes = _sizes(MESHES[mesh])
    jcache = japi.abstract_cache(JARCHS[arch], JSHAPES[shape])
    ref = _ref_specs(jcache, lambda p, leaf: js.cache_pspec(
        p, leaf, sizes, sh.global_batch))
    cache = api.build_model(cfg, device="meta").init_cache(
        sh.global_batch, sh.seq_len)
    mine = sharding.cache_pspecs(cache, _logical(MESHES[mesh]),
                                 sh.global_batch)
    assert mine
    for path, t in sharding.cache_leaves(cache):
        keys = tuple(k for k in path if isinstance(k, str))
        spec, leaf = ref[keys]
        lead = leaf.ndim - t.ndim
        assert tuple(leaf.shape[lead:]) == tuple(t.shape), keys
        assert mine[path] == spec[lead:], (keys, mine[path], spec)


@pytest.mark.parametrize("replication", ["none", "pod", "split"])
@pytest.mark.parametrize("shape", [(256, 4096), (32, 32768, 384), (1, 1),
                                   (128, 1), (48, 7)])
def test_input_specs_equal_the_reference(shape, replication):
    if replication == "split":
        cfg = REPLICA_SPLIT
    else:
        cfg = MULTI_POD if replication == "pod" else SINGLE_POD
    for c in {cfg, MULTI_POD}:
        want = tuple(js.input_pspec(shape, _JaxMesh(c), replication))
        got = sharding.input_pspec(shape, _logical(c),
                                   replication)
        assert got == want


def _ref_bytes(tree, fn, sizes):
    total = 0
    for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        if js._path_names(p)[-1:] == ["idx"]:
            continue
        spec = fn(p, leaf)
        n = 1
        for ax in spec:
            for a in (() if ax is None else
                      (ax if isinstance(ax, tuple) else (ax,))):
                n *= sizes[a]
        total += int(np.prod(leaf.shape)) * leaf.dtype.itemsize // n
    return total


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ["qwen3-8b", "mixtral-8x7b",
                                  "whisper-tiny", "xlstm-350m",
                                  "llama-3.2-vision-11b", "zamba2-7b"])
def test_argument_bytes_equal_the_reference(arch, mesh):
    sizes = _sizes(MESHES[mesh])
    logical = _logical(MESHES[mesh])
    abstract = japi.abstract_state(JARCHS[arch])
    params = _ref_bytes(abstract, lambda p, l: js.param_pspec(p, l, sizes),
                        sizes)
    jm = _JaxMesh(MESHES[mesh])
    for shape in ("train_4k", "decode_32k"):
        got = dryrun.argument_bytes(ARCHS[arch], SHAPES[shape], logical,
                                    "none")
        assert got["params"] == params
        specs = japi.input_specs(JARCHS[arch], JSHAPES[shape])
        assert got["inputs"] == sum(
            _ref_bytes(v, lambda p, l: js.input_pspec(l.shape, jm), sizes)
            for v in specs.values())
        if shape == "train_4k":
            # AdamW's f32 m and v, placed as the params, and the step
            moments = jax.tree.map(
                lambda l: jax.ShapeDtypeStruct(l.shape, np.float32), abstract)
            assert got["opt"] == 2 * _ref_bytes(
                moments, lambda p, l: js.param_pspec(p, l, sizes), sizes) + 4
        else:
            jcache = japi.abstract_cache(JARCHS[arch], JSHAPES[shape])
            assert got["cache"] == _ref_bytes(
                jcache, lambda p, l: js.cache_pspec(p, l, sizes, 128), sizes)


def test_placements_and_local_shapes():
    """A spec as DTensor placements on a mesh's names (the batch over pod
    and data on two mesh dims, or on the flattened ``pod+data``), and the
    shard's shape."""
    from torch.distributed.tensor import Replicate, Shard

    class M:
        def __init__(self, names):
            self.mesh_dim_names = names
    spec = (("pod", "data"), None, "model")
    assert sharding.placements(spec, M(("pod", "data", "model"))) == \
        (Shard(0), Shard(0), Shard(2))
    assert sharding.placements(spec, M(("pod+data", "model"))) == \
        (Shard(0), Shard(2))
    assert sharding.placements((None, "model"), M(("data", "model"))) == \
        (Replicate(), Shard(1))
    assert sharding.local_shape((256, 4096, 1024), spec,
                                {"pod": 2, "data": 16, "model": 16}) == \
        (8, 4096, 64)


def test_constrain_batch_is_a_no_op_without_a_mesh():
    x = torch.ones(4, 3)
    assert sharding.constrain_batch(x) is x
    assert parallel.to_local(x) is x
    g = {"a": x}
    assert parallel.reduce_grads(g, {"a": x})["a"] is x

"""``distributed/sharding.py``: the port's placement rules against the
reference's, exactly, and its shards.

* ``spec_for_param`` / ``param_specs`` give the reference's spec for every
  leaf of every family's REDUCED parameter tree (the reference's tree by
  ``jax.eval_shape``, the port's by its own ``Model.init``), and
  ``spec_for_cache`` for the cache leaves of the dense slab, the paged
  pool, the MLA latent and the SSM state, under the "tp", "dp" and "infer"
  layouts, on ``FakeMesh`` objects of (data, model) = (1, 1), (2, 4),
  (4, 2) and (1, 16) (``tests/test_sharding.py``'s kind: no process).
* ``local_shard`` cuts what ``NamedSharding`` places on each device: the
  shards of every coordinate, put back by the major-first rule of a dim
  split over several axes, give the tensor bit for bit (the all-gather of
  real ranks is ``test_torch_distributed.py``'s, bit for bit too).
"""

import itertools

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_reduced as j_get_reduced
from repro.distributed import sharding as jshd
from repro.models import build_model as j_build_model
from repro_torch.configs import get_reduced
from repro_torch.distributed import sharding as shd
from repro_torch.models import build_model

MESHES = [(1, 1), (2, 4), (4, 2), (1, 16)]
LAYOUTS = ["tp", "dp", "infer"]


class FakeMesh:
    def __init__(self, data, model, coords=None):
        self.axis_names = ("data", "model")
        self.shape = {"data": data, "model": model}
        self.coords = coords or {}

    def coordinate(self, name):
        return self.coords[name]


def _paths(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{path}/{k}" if path else str(k))
    else:
        yield path, tree


@pytest.fixture(scope="module")
def trees():
    out = {}
    for arch in ARCH_IDS:
        jtree = jax.eval_shape(lambda a=arch: j_build_model(
            j_get_reduced(a)).init(jax.random.PRNGKey(0)))
        ttree = build_model(get_reduced(arch), device="cpu").init(
            torch.Generator().manual_seed(0))
        out[arch] = (jtree, ttree)
    return out


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_param_specs_equal_the_reference(trees, monkeypatch, layout, mesh):
    monkeypatch.setenv("REPRO_LAYOUT", layout)
    fake = FakeMesh(*mesh)
    n = 0
    for arch, (jtree, ttree) in trees.items():
        jspecs = jshd.param_specs(jtree, fake)
        flat, _ = jax.tree_util.tree_flatten_with_path(
            jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                         for k in path): tuple(spec) for path, spec in flat}
        got = dict(_paths(shd.param_specs(ttree, fake)))
        assert sorted(got) == sorted(want), arch
        for path, leaf in _paths(ttree):
            assert got[path] == want[path], (arch, path)
            assert shd.spec_for_param(path.lower(), tuple(leaf.shape),
                                      fake) == want[path]
            n += 1
    assert n > 200


CACHE_LEAVES = [
    ("groups/blocks/pos0/k", (4, 16, 32, 16)),           # dense slab
    ("groups/blocks/pos0/v", (2, 4, 8, 32, 16)),         # stacked slab
    ("cache/k", (65, 8, 16, 128)),                       # paged pool
    ("cache/v", (2, 65, 2, 16, 128)),                    # stacked pool
    ("groups/blocks/pos0/k", (6, 3, 16)),                # heads off the axis
    ("groups/blocks/pos0/ckv", (4, 32, 512)),            # MLA latent
    ("groups/blocks/pos0/krope", (4, 32, 64)),
    ("groups/blocks/pos0/conv", (4, 3, 128)),            # SSM state
    ("groups/blocks/pos0/ssm", (4, 128, 16)),
    ("groups/blocks/pos0/attn/wkv_a", (64, 48)),         # not a cache leaf
    ("groups/blocks/pos0/k_norm", (64,)),
]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_cache_specs_equal_the_reference(monkeypatch, layout, mesh):
    monkeypatch.setenv("REPRO_LAYOUT", layout)
    fake = FakeMesh(*mesh)
    for path, shape in CACHE_LEAVES:
        want = jshd.spec_for_cache(path, shape, fake)
        got = shd.spec_for_cache(path, shape, fake)
        assert got == (None if want is None else tuple(want)), path
        assert shd.spec_for_param(path, shape, fake) == tuple(
            jshd.spec_for_param(path, shape, fake)), path


def test_fix_spec_equals_the_reference(monkeypatch):
    fake = FakeMesh(2, 4)
    for spec, shape in [((("data", "model"),), (16,)), ((("data", "model"),),
                        (4,)), (("model",), (6,)), (("pod", None), (4, 4)),
                        (("data",), (4, 8, 8)), ((None, "model"), (3, 8))]:
        assert shd._fix_spec(spec, shape, fake) == jshd._fix_spec(
            spec, shape, fake)
    assert shd.model_axis_size(fake) == jshd.model_axis_size(fake) == 4
    for layout in LAYOUTS:       # the activations' layout rule, for A13b
        monkeypatch.setenv("REPRO_LAYOUT", layout)
        for spec in [(shd.BATCH, None, "model"), (("data", "model"), None),
                     ("model", "data"), (None,)]:
            assert shd._apply_layout(spec) == tuple(jshd._apply_layout(spec))
    assert shd.heads_divide(8, fake) and not shd.heads_divide(6, fake)
    assert shd.model_axis_size(None) == 1


@pytest.mark.parametrize("spec", [(None, "data", "model"),
                                  ("model", None, "data"),
                                  (("data", "model"), None, None),
                                  (None, None, ("model", "data")),
                                  (None, None, None)])
def test_shard_then_reassemble_is_bit_for_bit(spec):
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, 16, 24)).astype(np.float32))
    data, model = 2, 4
    out = torch.full_like(x, float("nan"))
    for d, m in itertools.product(range(data), range(model)):
        mesh = FakeMesh(data, model, {"data": d, "model": m})
        shard = shd.local_shard(x, spec, mesh)
        assert tuple(shard.shape) == tuple(
            n // c for n, c in zip(x.shape, _counts(spec, mesh)))
        assert shd.global_shape(shard.shape, spec, mesh) == tuple(x.shape)
        index = []
        for dim, entry in enumerate(spec):
            names = entry if isinstance(entry, tuple) else (
                () if entry is None else (entry,))
            pos = 0
            for name in names:                  # major first
                pos = pos * mesh.shape[name] + mesh.coords[name]
            size = shard.shape[dim]
            index.append(slice(pos * size, (pos + 1) * size))
        out[tuple(index)] = shard
    assert torch.equal(out, x)
    assert shd.shard_count(spec, FakeMesh(data, model)) == int(np.prod(
        _counts(spec, FakeMesh(data, model))))


def _counts(spec, mesh):
    out = []
    for entry in spec:
        names = entry if isinstance(entry, tuple) else (
            () if entry is None else (entry,))
        out.append(int(np.prod([mesh.shape[n] for n in names])))
    return out


def test_a_spec_that_splits_nothing_keeps_the_tensor():
    x = torch.arange(12.0).reshape(3, 4)
    assert shd.local_shard(x, ("data", "model"), FakeMesh(1, 1)) is x
    assert shd.gather(x, ("data", "model"), FakeMesh(1, 1), ("data",)) is x
    assert shd.batch_mean(x) is x

"""The serving copy of the weights, built leaf by leaf
(``Model.init_serving``), against ``prepare(init(gen))``, on the CPU.

``init_serving`` makes each leaf with the draws ``init`` makes, in the same
order, and casts it by ``prepare``'s rule the moment it is made, so the f32
tree never exists (jamba-1.5-large-398b cut to 5 layers: 96.2 GB in f32,
48.1 GB as served). Held here, bit for bit (each leaf's dtype, shape and
bits; tolerance 0):

  * the serving copy equals ``prepare(init(gen))`` for every
    architecture's ``REDUCED`` config, under both of ``prepare``'s rules:
    the CPU's (the routed experts f32, for the plain MoE) and the card's
    (the experts bf16, for the grouped MoE), the latter through the same
    private helpers ``prepare`` uses;
  * no f32 leaf the rule casts outlives the draw of the next leaf;
  * ``layers.randn`` (now scaled in place) gives the bits of ``randn(...)
    * scale``;
  * the engine's ``prepare`` hands an already prepared copy back as the
    same tensor objects (no second copy).

A ``cuda`` case repeats the bit-equality on the card for a reduced
qwen2.5-3b and a reduced qwen3-moe-30b-a3b (bf16 experts); it skips
without a card. The full-width checks (qwen2.5-3b ``--full``, qwen3-moe
at 2 layers, jamba at 5 with its peak memory) are in ``chip_smoke.py``
phase 15.
"""

import weakref

import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_reduced
from repro_torch.models import api, build_model, layers
from repro_torch.serve.engine import Engine, EngineConfig

#: an integer dtype of each float width, to compare bits
_BITS = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def _leaves(tree, path=()):
    if torch.is_tensor(tree):
        yield path, tree
        return
    for name, sub in tree.items():
        yield from _leaves(sub, path + (name,))


def assert_same_bits(got, want) -> int:
    """Every leaf of ``got`` has ``want``'s dtype, shape and bits; returns
    how many leaves are bf16."""
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert list(got) == list(want)
    for path, g in got.items():
        w = want[path]
        assert (g.dtype, g.shape) == (w.dtype, w.shape), path
        as_int = _BITS[g.element_size()]
        assert torch.equal(g.contiguous().view(as_int),
                           w.contiguous().view(as_int)), path
    return sum(g.dtype == torch.bfloat16 for g in got.values())


def _gen(device="cpu"):
    return torch.Generator(device=device).manual_seed(0)


@pytest.mark.parametrize("rule", ["cpu", "card"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serving_copy_equals_prepare_of_init(arch, rule):
    model = build_model(get_reduced(arch), device="cpu")
    if rule == "cpu":
        got = model.init_serving(_gen())
        want = model.prepare(model.init(_gen()))
    else:
        leaf = api._serving_leaf(grouped_moe=True)
        got = model._draw(_gen(), leaf)
        want = api._cast_tree(model.init(_gen()), leaf)
    assert assert_same_bits(got, want) > 0
    experts = [t for path, t in _leaves(got) if path[-1].startswith("we_")]
    want_dtype = torch.float32 if rule == "cpu" else torch.bfloat16
    assert all(t.dtype == want_dtype for t in experts)


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b",
                                  "deepseek-v2-236b", "seamless-m4t-medium"])
def test_no_f32_leaf_outlives_the_next_draw(arch):
    """Each leaf the card's rule casts is dead (its f32 freed) by the time
    the next leaf reaches the hook."""
    model = build_model(get_reduced(arch), device="cpu")
    rule = api._serving_leaf(grouped_moe=True)
    cast, seen = [], []

    def leaf(name, x):
        for ref, prev in cast:
            assert ref() is None, f"{prev} still alive at {name}"
        cast.clear()
        out = rule(name, x)
        seen.append(name)
        if out is not x:
            cast.append((weakref.ref(x), name))
        return out

    model._draw(_gen(), leaf)
    assert seen[0] == "embed"
    assert len(seen) == len(list(_leaves(model.init(_gen()))))


@pytest.mark.parametrize("shape,scale", [((3, 5), 0.02), ((2, 64, 48), 0.125),
                                         ((4, 7, 9), 1 / 3 ** 0.5)])
def test_randn_scaled_in_place_same_bits(shape, scale):
    got = layers.randn(_gen(), shape, scale)
    want = torch.randn(shape, generator=_gen(), dtype=torch.float32) * scale
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "qwen3-moe-30b-a3b",
                                  "jamba-1.5-large-398b"])
def test_engine_keeps_a_prepared_copy(arch):
    model = build_model(get_reduced(arch), device="cpu")
    params = model.init_serving(_gen())
    engine = Engine(model, params, EngineConfig(max_len=32))
    mine, its = dict(_leaves(params)), dict(_leaves(engine.params))
    assert list(mine) == list(its)
    assert all(its[path] is leaf for path, leaf in mine.items())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "qwen3-moe-30b-a3b"])
def test_serving_copy_on_card(arch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    model = build_model(get_reduced(arch), device="cuda")
    got = model.init_serving(_gen("cuda"))
    want = model.prepare(model.init(_gen("cuda")))
    assert assert_same_bits(got, want) > 0
    experts = [t for path, t in _leaves(got) if path[-1].startswith("we_")]
    assert all(t.dtype == torch.bfloat16 for t in experts)

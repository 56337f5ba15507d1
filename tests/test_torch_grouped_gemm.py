"""The grouped_gemm kernel's launch plan and tile schedule, on the CPU.

The CUDA kernel (``kernels/csrc/grouped_gemm.cu``) cannot run here; what
decides its work can. :func:`launch_config` is a function of the shapes
alone: its regime, tile, rows' TMA box and persistent grid. ``schedule``
below is a numpy copy of the kernel's device-side schedule (the clamped
offsets, warp 0's scan into each expert's first tile, the grid-stride walk
over the work items, the binary search from item to expert): every row
below ``offs[E-1]`` must be written exactly once in every column, with
its own expert, and nothing at or past it, for each regime, at empty
experts, all rows in one expert, m = 0, E = 1 and E = 1024. The kernel
against its plain version runs in ``test_torch_moe.py``'s ``cuda`` tests.
"""

import inspect

import numpy as np
import pytest
import torch

from repro_torch.kernels import grouped_gemm as gg

SMS = 132


def schedule(offs: np.ndarray, m: int, n: int, conf) -> tuple:
    """Mirror of the kernel's schedule: (stores per output element (m, n),
    the expert each row was computed with (-1 if none), work items)."""
    e = len(offs)
    ends = np.minimum(np.maximum(offs, 0), m)
    starts = np.concatenate([[0], ends[:-1]])
    tiles = (np.maximum(ends - starts, 0) + conf.bm - 1) // conf.bm
    first = np.concatenate([[0], np.cumsum(tiles)])
    n_tiles = -(-n // conf.bn)
    items = int(first[e]) * n_tiles
    stores = np.zeros((m, n), np.int64)
    expert = np.full(m, -1)
    for cta in range(conf.grid):
        for item in range(cta, items, conf.grid):
            t, j = divmod(item, n_tiles)
            lo, hi = 0, e - 1                 # the last g with first[g] <= t
            while lo < hi:
                mid = (lo + hi + 1) // 2
                if first[mid] <= t:
                    lo = mid
                else:
                    hi = mid - 1
            g = lo
            row0 = starts[g] + (t - first[g]) * conf.bm
            rows = min(conf.bm, ends[g] - row0)
            assert 1 <= rows <= conf.a_rows   # the rows' TMA box holds them
            stores[row0:row0 + rows, j * conf.bn:(j + 1) * conf.bn] += 1
            seen = expert[row0:row0 + rows]
            assert np.all((seen == -1) | (seen == g))  # one expert a row
            expert[row0:row0 + rows] = g
    return stores, expert, items


def owner(offs: np.ndarray, m: int) -> np.ndarray:
    """The expert of each row (-1 at or past offs[E-1])."""
    rows = np.arange(m)
    g = np.searchsorted(offs, rows, side="right")
    return np.where(rows < (offs[-1] if len(offs) else 0), g, -1)


def check_schedule(offs, m, n, e):
    conf = gg.launch_config(m, 64, n, e, SMS)
    stores, expert, items = schedule(np.asarray(offs), m, n, conf)
    end = int(offs[-1])
    assert np.all(stores[:end] == 1), "a row below offs[E-1] not stored once"
    assert np.all(stores[end:] == 0), "a row at or past offs[E-1] stored"
    np.testing.assert_array_equal(expert, owner(np.asarray(offs), m))
    assert items <= conf.max_items
    return conf


def random_offsets(m, e, seed, skew=False):
    rng = np.random.RandomState(seed)
    p = rng.dirichlet(np.full(e, 0.2 if skew else 5.0))
    sel = np.sort(rng.choice(e, size=m, p=p))
    return np.searchsorted(sel, np.arange(e), side="right").astype(np.int32)


# ------------------------------------------------------------ launch_config

def test_launch_config_is_a_function_of_the_shapes_alone():
    """Its arguments are the shapes and the SM count; the wrapper passes
    nothing of the offsets; equal shapes give the same plan."""
    assert list(inspect.signature(gg.launch_config).parameters) == [
        "m", "k", "n", "e", "sms", "config"]
    src = inspect.getsource(gg.grouped_gemm)
    assert "launch_config(m, k, n, e, _sms(xs.device.index), config)" in src
    assert gg.launch_config(8192, 2048, 768, 128) == gg.launch_config(
        8192, 2048, 768, 128, SMS)


@pytest.mark.parametrize("m,e", [(32, 128), (8192, 128), (6144, 160),
                                 (0, 3)])
@pytest.mark.parametrize("config", sorted(gg.TILES))
def test_a_forced_tile_shape_keeps_the_plan_consistent(m, e, config):
    """A forced shape gets its own tiles, box and grid by the same rules,
    and its schedule still covers every row once."""
    conf = gg.launch_config(m, 2048, 768, e, SMS, config)
    bm, bn = gg.TILES[config]
    assert (conf.config, conf.bm, conf.bn) == (config, bm, bn)
    assert conf.regime == ("decode" if config == 0 else "admission")
    assert conf.a_rows == min(bm, -(-max(m, 1) // 8) * 8)
    assert conf.max_items == (m // bm + min(m, e)) * -(-768 // bn)
    assert conf.grid == max(1, min(SMS, conf.max_items))
    if m:
        offs = random_offsets(m, e, seed=config)
        stores, expert, _ = schedule(offs, m, 200, conf)
        assert np.all(stores == 1)
        np.testing.assert_array_equal(expert, owner(offs, m))


def test_an_unknown_tile_shape_is_refused():
    with pytest.raises(KeyError):
        gg.launch_config(32, 2048, 768, 128, SMS, 7)


@pytest.mark.parametrize("m,e,regime,bm,bn", [
    (1, 128, "decode", 64, 64), (32, 128, "decode", 64, 64),
    (63, 16, "decode", 64, 64), (64, 16, "decode", 64, 64),
    (65, 16, "admission", 64, 128), (767, 16, "admission", 64, 128),
    (768, 16, "admission", 128, 128), (769, 16, "admission", 128, 128),
    (8192, 128, "admission", 128, 128),   # qwen3-moe's 1024-token admission
    (6144, 160, "admission", 64, 128),    # deepseek-v2's
    (2048, 16, "admission", 128, 128),    # jamba's 16 experts x 128 rows
    (65, 1, "admission", 128, 128), (64, 1, "decode", 64, 64),
    (100, 3, "admission", 64, 128), (144, 3, "admission", 128, 128)])
def test_launch_config_regimes_at_their_thresholds(m, e, regime, bm, bn):
    """decode at m <= 64 (one side of the threshold and the other), an
    admission's 128-row tiles from 48 rows an expert on average."""
    conf = gg.launch_config(m, 2048, 768, e, SMS)
    assert (conf.regime, conf.bm, conf.bn) == (regime, bm, bn)
    assert gg.TILES[conf.config] == (bm, bn)
    assert conf.a_rows % 8 == 0 and min(m, bm) <= conf.a_rows <= bm
    assert conf.a_rows == min(bm, -(-m // 8) * 8)
    assert conf.max_items == (m // bm + min(m, e)) * -(-768 // bn)
    assert conf.grid == min(SMS, conf.max_items)


def test_launch_config_grid_follows_the_sm_count():
    assert gg.launch_config(32, 2048, 768, 128, 132).grid == 132
    assert gg.launch_config(32, 2048, 768, 128, 1000).grid == 32 * 12
    assert gg.launch_config(5, 16, 8, 3, 132).grid == 3   # <= 3 experts hit
    assert gg.launch_config(5, 16, 8, 8, 132).grid == 5   # <= 5 rows
    assert gg.launch_config(0, 16, 8, 3, 132) == gg.LaunchConfig(
        "decode", 0, 64, 64, 8, 0, 1)


# ------------------------------------------------------------ schedule

@pytest.mark.parametrize("m,e", [(1, 1), (5, 3), (32, 128), (63, 16),
                                 (64, 16), (65, 16), (200, 8), (767, 16),
                                 (768, 16), (1000, 4), (8192, 128),
                                 (6144, 160), (4096, 1024), (40, 1024)])
@pytest.mark.parametrize("skew", [False, True])
def test_schedule_covers_every_row_once(m, e, skew):
    """Random routes (skewed ones leave experts empty and crowd others):
    every row below offs[E-1] stored once in every column, with its own
    expert, in each regime."""
    offs = random_offsets(m, e, seed=m + e, skew=skew)
    check_schedule(offs, m, 200, e)


@pytest.mark.parametrize("m,e,g", [(64, 16, 0), (64, 16, 15), (65, 16, 7),
                                   (1000, 4, 2), (1000, 1024, 1023),
                                   (300, 1, 0)])
def test_schedule_all_rows_in_one_expert(m, e, g):
    offs = np.array([0] * g + [m] * (e - g), np.int32)
    conf = check_schedule(offs, m, 136, e)
    _, _, items = schedule(offs, m, 136, conf)
    assert items == -(-m // conf.bm) * -(-136 // conf.bn)


def test_schedule_with_rows_past_the_last_offset_and_empty_experts():
    """offs[E-1] < m (capacity drops): those rows are never stored."""
    offs = np.array([0, 3, 3, 3, 10, 10, 40, 40], np.int32)
    for m in (40, 41, 64, 100, 400):
        check_schedule(offs, m, 72, len(offs))


def test_schedule_at_m_zero_has_no_work():
    conf = gg.launch_config(0, 64, 40, 3, SMS)
    assert conf.max_items == 0
    stores, _, items = schedule(np.zeros(3, np.int32), 0, 40, conf)
    assert items == 0 and stores.size == 0


def test_schedule_at_e_1024_with_one_row_each():
    offs = np.arange(1, 1025, dtype=np.int32)
    conf = check_schedule(offs, 1024, 64, 1024)
    assert conf.regime == "admission" and conf.bm == 64


# ------------------------------------------------------------ checks

def test_checks_refuse_more_experts_than_the_kernel_holds():
    """The expert limit is checked before any launch, on any device."""
    w = torch.zeros((gg.MAX_EXPERTS + 1, 8, 8), dtype=torch.bfloat16)
    xs = torch.zeros((4, 8), dtype=torch.bfloat16)
    offs = torch.full((gg.MAX_EXPERTS + 1,), 4, dtype=torch.int32)
    with pytest.raises(ValueError):
        gg.check_inputs(xs, w, offs)
    assert gg.check_inputs(xs, w[:gg.MAX_EXPERTS],
                           offs[:gg.MAX_EXPERTS]) == (4, 8)


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.RandomState(0)
    xs = torch.from_numpy(rng.randn(10, 16).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.randn(3, 16, 24).astype(np.float32)).bfloat16()
    offs = torch.tensor([4, 4, 10], dtype=torch.int32)
    before = gg.grouped_gemm.launches
    got = gg.grouped_gemm(xs, w, offs)
    assert gg.grouped_gemm.launches == before
    want = torch.cat([xs[:4].float() @ w[0].float(),
                      xs[4:].float() @ w[2].float()])
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-5)

"""Port parity of tile binning: the port's plain binning (including the plain
version of the K4 expansion kernel) is fed the JAX reference's `Projected`
arrays, so float rounding in projection cannot move a tile boundary, and
every integer field must equal JAX `bin_gaussians` up to `num_pairs`."""

import bisect
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import example, given, settings, strategies as st

from test_torch_common import np_, port_projected
from test_binning_fallbacks import _fake_proj

from gaussiansplat_tpu.config import RasterConfig as JRasterConfig
from gaussiansplat_tpu.models import random_model as j_random_model
from gaussiansplat_tpu.ops import look_at as j_look_at
from gaussiansplat_tpu.ops.binning import bin_gaussians as j_bin
from gaussiansplat_tpu.ops.projection import project_gaussians as j_project
from gaussiansplat_tpu_torch.config import RasterConfig
from gaussiansplat_tpu_torch.ops.binning import bin_gaussians, compact_rects
from gaussiansplat_tpu_torch.ops.kernels.build import CSRC_DIR
from gaussiansplat_tpu_torch.ops.kernels.expand import (
    SLOTS_PER_BLOCK,
    SLOTS_PER_THREAD,
    _kth_set_bit,
    block_owners,
    expand_pairs_torch,
    popcount,
    warp_count_le,
)

FULL = ("depth_order", "tile_starts", "seg_offsets", "num_pairs", "overflow")
PAIRS = ("sorted_ranks", "sorted_tiles", "sorted_pos")


def _jax_proj(n=300, width=160, height=96, seed=3, sh_degree=3):
    m = j_random_model(jax.random.PRNGKey(seed), n, sh_degree=sh_degree,
                       extent=1.0)
    cam = j_look_at(eye=(0.5, 0.3, -6.0), target=(0, 0, 0), fx=220.0,
                    fy=220.0, width=width, height=height)
    return jax.jit(lambda m, c: j_project(
        m.means, m.quats, m.log_scales, m.logit_opacities, m.sh, c,
        JRasterConfig(), sh_degree=sh_degree, alive=m.alive))(m, cam)


def _assert_binning_equal(bt, bj):
    npairs = int(bj.num_pairs)
    assert npairs > 0
    for f in FULL:
        np.testing.assert_array_equal(np_(getattr(bt, f)),
                                      np.asarray(getattr(bj, f)), err_msg=f)
    for f in PAIRS:
        np.testing.assert_array_equal(np_(getattr(bt, f))[:npairs],
                                      np.asarray(getattr(bj, f))[:npairs],
                                      err_msg=f)


def _both(jproj, width, height, impl="xla", jcfg=None, tcfg=None, **kw):
    jcfg = jcfg or JRasterConfig()
    tcfg = tcfg or RasterConfig()
    bj = jax.jit(lambda p: j_bin(p, width, height, jcfg, impl=impl, **kw))(jproj)
    bt = bin_gaussians(port_projected(jproj), width, height, tcfg,
                       impl="torch", **kw)
    return bt, bj


@pytest.mark.parametrize("capacity", [None, 256], ids=["roomy", "overflow"])
def test_matches_jax(capacity):
    jp = _jax_proj()
    kw = dict(capacity=capacity) if capacity else {}
    bt, bj = _both(jp, 160, 96, **kw)
    _assert_binning_equal(bt, bj)
    assert (int(bt.overflow) > 0) == (capacity is not None)


def test_no_cull_matches_jax():
    jp = _jax_proj(seed=4)
    bt, bj = _both(jp, 160, 96, jcfg=JRasterConfig(tile_cull=False),
                   tcfg=RasterConfig(tile_cull=False))
    _assert_binning_equal(bt, bj)


def test_strip_matches_jax():
    jp = _jax_proj()
    bj = jax.jit(lambda p: j_bin(p, 160, 96, JRasterConfig(),
                                 tile_row0=jnp.int32(1), tile_rows=2,
                                 impl="xla"))(jp)
    bt = bin_gaussians(port_projected(jp), 160, 96, RasterConfig(),
                       tile_row0=1, tile_rows=2, impl="torch")
    _assert_binning_equal(bt, bj)


def test_matches_jax_pallas_interpret():
    """Against the reference's own expand kernel, run in interpret mode."""
    jp = _jax_proj(n=200, width=128, height=64, seed=5)
    bt, bj = _both(jp, 128, 64, impl="pallas_interpret")
    _assert_binning_equal(bt, bj)


def test_separate_stream_regime():
    """tile_bits + rank_bits > 31: 70k gaussians (rank_bits 17) over a
    255 x 127 tile grid (tile_bits 15), whose rect still packs in 30 bits,
    so the expansion emits separate tile and rank streams."""
    n, width, height = 70_000, 8160, 4064
    jp, *_ = _fake_proj(n, width, height, seed=5, n_valid=64, max_r=width / 16)
    c = compact_rects(port_projected(jp), width, height, RasterConfig(),
                      capacity=4096)
    assert not c.packed_keys
    bt, bj = _both(jp, width, height, capacity=4096)
    _assert_binning_equal(bt, bj)


def test_enormous_grid_int64_rects():
    """A tile grid whose rect needs more than 31 bits: the port packs it in
    int64 (plain version only) and still matches the reference."""
    n, width, height = 64, 8192, 8192
    jp, *_ = _fake_proj(n, width, height, max_r=400)
    jcfg = JRasterConfig(tile_size=16)
    c = compact_rects(port_projected(jp), width, height,
                      RasterConfig(tile_size=16), capacity=8192)
    assert c.rect_c.dtype == torch.int64
    bt, bj = _both(jp, width, height, jcfg=jcfg,
                   tcfg=RasterConfig(tile_size=16), capacity=8192)
    _assert_binning_equal(bt, bj)


@pytest.mark.parametrize("width,height,tile,n,packed", [
    (7680, 4320, 32, 64, True),        # 240 x 135 tiles: 32 rect bits
    (7680, 4320, 32, 70_000, False),   # 15 tile + 17 rank bits: two streams
    (3840, 2160, 16, 64, True),        # 240 x 135 tiles of 16 px
], ids=["8k-packed", "8k-streams", "4k-16px"])
def test_int64_rects_route_to_k4(width, height, tile, n, packed, monkeypatch):
    """expand_compacted sends int64 rects with impl='cuda' to K4's wrapper
    (never to the plain version), whose int64 instantiation is a launcher
    of expand.cu; the plain version, which stands in for the launch here,
    matches the reference on the same grid."""
    from gaussiansplat_tpu_torch.ops import binning
    from gaussiansplat_tpu_torch.ops.kernels.expand import RECT_SYMBOLS

    jp, *_ = _fake_proj(n, width, height, seed=7, n_valid=64, max_r=300)
    cfg = RasterConfig(tile_size=tile)
    c = compact_rects(port_projected(jp), width, height, cfg, capacity=8192)
    assert c.rect_c.dtype == torch.int64 and c.packed_keys == packed
    calls = []

    def k4(*args):
        calls.append(args[1].dtype)
        return expand_pairs_torch(*args)

    monkeypatch.setattr(binning, "expand_pairs_cuda", k4)
    monkeypatch.setattr(binning, "expand_pairs_torch", None)
    got = binning.expand_compacted(c, "cuda")
    assert calls == [torch.int64]
    bt = binning.sort_pairs(c, got)
    bj = jax.jit(lambda p: j_bin(p, width, height, JRasterConfig(tile_size=tile),
                                 capacity=8192, impl="xla"))(jp)
    _assert_binning_equal(bt, bj)
    assert RECT_SYMBOLS[torch.int64] == "gs_expand_pairs_i64"
    src = (CSRC_DIR / "expand.cu").read_text()
    assert 'extern "C" int gs_expand_pairs_i64(' in src
    assert "launch_expand<long long>" in src


def test_pre_sort_positions_are_contiguous():
    """Valid pairs occupy pre-sort positions [0, num_pairs): the backward
    reduction of the next slice relies on it."""
    bt, _ = _both(_jax_proj(), 160, 96)
    n = int(bt.num_pairs)
    assert sorted(np_(bt.sorted_pos)[:n].tolist()) == list(range(n))


def test_bit_helpers():
    rng = np.random.default_rng(0)
    m = rng.integers(-2**31, 2**31, size=4096, dtype=np.int64).astype(np.int32)
    m[:3] = [0, -1, -2**31]
    got = np_(popcount(torch.as_tensor(m)))
    want = np.array([bin(int(x) & 0xFFFFFFFF).count("1") for x in m])
    np.testing.assert_array_equal(got, want)
    k = rng.integers(0, 33, size=m.shape).astype(np.int32)
    sel = np_(_kth_set_bit(torch.as_tensor(m), torch.as_tensor(k)))
    for x, kk, s in zip(m[:512], k[:512], sel[:512]):
        bits = [b for b in range(32) if (int(x) >> b) & 1]
        assert s == (bits[kk] if kk < len(bits) else 0)


@settings(max_examples=300, deadline=None, derandomize=True, database=None)
@given(st.lists(st.integers(0, 3000), max_size=2500), st.integers(-1, 3001))
def test_warp_count_le_matches_bisect(values, key):
    """The 32-way search of csrc/expand.cu (its plain twin) counts the
    entries <= key of any non-decreasing array, duplicates included."""
    off = sorted(values)
    assert warp_count_le(off, key) == bisect.bisect_right(off, key)


@st.composite
def _compacted_offsets(draw):
    """Offsets as compact_rects makes them: ranks with 1..1500 pairs, or
    long runs of ranks with 1-3 pairs each (a block's 1024 slots then span
    up to its whole window of 1024 ranks), then empty ranks; clipped to a
    capacity that may cut the pairs (overflow) or exceed them by less than
    a block."""
    if draw(st.booleans()):
        counts = [draw(st.integers(1, 3))] * draw(st.integers(0, 3000))
        for _ in range(draw(st.integers(0, 8)) if counts else 0):
            counts[draw(st.integers(0, len(counts) - 1))] = draw(
                st.integers(1, 1500))
    else:
        counts = draw(st.lists(st.one_of(st.integers(1, 4),
                                         st.integers(1, 40),
                                         st.integers(1, 1500)),
                               min_size=0, max_size=300))
    counts += [0] * draw(st.integers(0 if counts else 1, 40))
    total = sum(counts)
    capacity = draw(st.one_of(st.integers(1, max(total, 1)),
                              st.integers(total + 1, total + 1100)))
    off = np.minimum(np.cumsum([0] + counts[:-1]), capacity)
    return off.astype(np.int32), min(total, capacity), capacity


def _ones(ranks, empty, capacity):
    """`ranks` ranks of one pair each, then `empty` empty ones."""
    off = np.minimum(np.minimum(np.arange(ranks + empty), ranks), capacity)
    return off.astype(np.int32), min(ranks, capacity), capacity


@settings(max_examples=150, deadline=None, derandomize=True, database=None)
@given(_compacted_offsets())
@example(_ones(2600, 5, 2603))     # windows used to their last rank
@example(_ones(2600, 5, 2048))     # overflow at a block edge
def test_block_owners_match_plain(case):
    """The owner of every slot as csrc/expand.cu finds it (one search per
    block of SLOTS_PER_BLOCK slots, a window of as many ranks, a bisection
    per SLOTS_PER_THREAD slots) equals the rank stream of the plain
    version over the whole capacity: past num_pairs that is n - 1, since
    every offset is clipped to num_pairs."""
    off, num_pairs, capacity = case
    n = off.shape[0]
    off_c = torch.as_tensor(off)
    zeros = torch.zeros(n, dtype=torch.int32)
    _, want = expand_pairs_torch(off_c, zeros, zeros, torch.tensor(num_pairs),
                                 capacity, 8, 64, 10, (4, 4, 4), False)
    assert torch.equal(block_owners(off_c, num_pairs, capacity), want)
    assert bool((want[num_pairs:] == n - 1).all())


def test_expand_launch_shape_matches_the_kernel():
    src = (CSRC_DIR / "expand.cu").read_text()
    threads = int(re.search(r"kThreads = (\d+);", src).group(1))
    per = int(re.search(r"kSlotsPerThread = (\d+);", src).group(1))
    assert (per, threads * per) == (SLOTS_PER_THREAD, SLOTS_PER_BLOCK)

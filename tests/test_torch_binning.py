"""Port parity of tile binning: the port's plain binning (including the plain
version of the K4 expansion kernel) is fed the JAX reference's `Projected`
arrays, so float rounding in projection cannot move a tile boundary, and
every integer field must equal JAX `bin_gaussians` up to `num_pairs`. The
plain version of the pair gather must give the reference's gathered rows
up to `num_pairs`, and the gather kernel's wrapper must refuse what the
kernel does not take before anything is built. The R kernel's plain
per-gaussian twin (ops/kernels/rects.py) must give the plain version's
rects, masks, counts and depth keys bit for bit, and its wrapper refuses
what the kernel does not take."""

import bisect
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import example, given, settings, strategies as st

from test_torch_common import limit_torch_threads, np_, port_projected
from test_binning_fallbacks import _fake_proj

from gaussiansplat_tpu.config import RasterConfig as JRasterConfig
from gaussiansplat_tpu.models import random_model as j_random_model
from gaussiansplat_tpu.ops import look_at as j_look_at
from gaussiansplat_tpu.ops.binning import bin_gaussians as j_bin
from gaussiansplat_tpu.ops.projection import project_gaussians as j_project
from gaussiansplat_tpu_torch.config import RasterConfig
from gaussiansplat_tpu_torch.ops.binning import (
    MASK_TILES,
    bin_gaussians,
    compact_rects,
    tile_grid,
    tile_rects_torch,
)
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
from gaussiansplat_tpu_torch.ops.kernels.gather import (
    GATHER,
    gather_pairs_cuda,
    gather_pairs_torch,
)
from gaussiansplat_tpu_torch.ops.kernels.rects import (
    RECTS,
    THREADS,
    tile_rects_cuda,
    tile_rects_twin,
)
from gaussiansplat_tpu_torch.ops.projection import Projected

limit_torch_threads()

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


def _gather_case(name):
    """(JAX projected, width, height, binning kwargs) of a gather case."""
    if name == "separate_streams":
        jp, *_ = _fake_proj(70_000, 8160, 4064, seed=5, n_valid=16,
                            max_r=8160 / 32)
        return jp, 8160, 4064, dict(capacity=4096)
    if name == "no_pairs":
        jp, *_ = _fake_proj(300, 160, 96, seed=2, n_valid=0)
        return jp, 160, 96, {}
    kw = dict(capacity=256) if name == "overflow" else {}
    return _jax_proj(), 160, 96, kw


@pytest.mark.parametrize("name", ["packed_keys", "separate_streams",
                                  "no_pairs", "overflow"])
def test_gather_pairs_torch_matches_reference(name):
    """The plain gather on the port's binning gives the reference's
    `gather_payload` rows (payload[depth_order][sorted_ranks]) bit for bit
    on the pairs [0, num_pairs), in both key regimes, with no pairs and
    with every slot filled by an overflow."""
    jp, width, height, kw = _gather_case(name)
    bt, bj = _both(jp, width, height, **kw)
    n, p = bt.depth_order.shape[0], bt.sorted_ranks.shape[0]
    payload = np.random.default_rng(11).standard_normal((n, 16)).astype(
        np.float32)
    want = np.asarray(bj.gather_payload(jnp.asarray(payload), impl="xla"))
    got = gather_pairs_torch(torch.from_numpy(payload), bt.depth_order,
                             bt.sorted_ranks, bt.num_pairs)
    npairs = int(bt.num_pairs)
    assert npairs == int(bj.num_pairs)
    assert tuple(got.shape) == want.shape == (p, 16)
    assert (npairs == 0) == (name == "no_pairs")
    assert (npairs == p) == (name == "overflow")
    if name == "separate_streams":
        c = compact_rects(port_projected(jp), width, height, RasterConfig(),
                          **kw)
        assert not c.packed_keys
    np.testing.assert_array_equal(got.numpy()[:npairs].view(np.int32),
                                  want[:npairs].view(np.int32))


def _gather_inputs(case):
    """Small CPU inputs of the gather wrapper, one of them broken by
    `case`."""
    t = dict(payload=torch.zeros((8, 16)),
             depth_order=torch.arange(8, dtype=torch.int32),
             sorted_ranks=torch.zeros((32,), dtype=torch.int32),
             num_pairs=torch.tensor(5, dtype=torch.int32))
    if case == "payload_dtype":
        t["payload"] = t["payload"].double()
    elif case == "rank_dtype":
        t["sorted_ranks"] = t["sorted_ranks"].long()
    elif case == "payload_width":
        t["payload"] = torch.zeros((8, 12))
    elif case == "not_contiguous":
        t["payload"] = torch.zeros((8, 32))[:, ::2]
    return t


@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA tensors"),
    ("payload_dtype", "float32"),
    ("rank_dtype", "int32"),
    ("payload_width", "16 channels"),
    ("not_contiguous", "contiguous"),
])
def test_gather_pairs_cuda_refuses(case, match):
    """The kernel's wrapper raises ValueError on CPU tensors, a wrong
    dtype, payload rows of another width and non-contiguous input, before
    it builds or launches anything."""
    before = GATHER.launches
    with pytest.raises(ValueError, match=match):
        gather_pairs_cuda(**_gather_inputs(case))
    assert GATHER.launches == before and GATHER._lib is None


# --- R: rects, survivor masks and pair counts ------------------------------

RECT_W, RECT_H, RECT_TILE = 256, 128, 16   # a 16 x 8 grid of 16 px tiles


def _fields(u, v, rx, ry, conic, opacity, depth, valid):
    """The binning fields of a Projected, as float32 / int32 / bool."""
    f32 = torch.float32
    radius_xy = torch.as_tensor(np.stack([rx, ry], -1).astype(np.int32))
    return Projected(
        mean2d=torch.as_tensor(np.stack([u, v], -1), dtype=f32),
        depth=torch.as_tensor(depth, dtype=f32),
        conic=torch.as_tensor(conic, dtype=f32),
        rgb=torch.zeros((len(u), 3)),
        opacity=torch.as_tensor(opacity, dtype=f32),
        radius=radius_xy.max(dim=1).values,
        radius_xy=radius_xy,
        valid=torch.as_tensor(valid, dtype=torch.bool),
    )


def _rect_case(name):
    """(Projected, cfg, width, height, tile_row0, tile_rows) of a twin case:
    200 gaussians of every size over the 16 x 8 grid, with conics of their
    radii turned by a random correlation, and the case's edge on the first
    60."""
    g = np.random.default_rng(21)
    n, k = 200, 60
    amin = RasterConfig().alpha_min
    if name == "projected":
        return (port_projected(_jax_proj()), RasterConfig(), 160, 96, 0,
                None)
    u = g.uniform(-20, RECT_W + 20, n)
    v = g.uniform(-20, RECT_H + 20, n)
    rx = g.integers(1, 100, n)
    ry = g.integers(1, 70, n)
    sx, sy, rho = rx / 3.0, ry / 3.0, g.uniform(-0.95, 0.95, n)
    det = sx * sx * sy * sy * (1 - rho * rho)
    conic = np.stack([sy * sy / det, -rho * sx * sy / det, sx * sx / det], -1)
    opacity = g.uniform(amin, 1.0, n)
    depth = g.uniform(0.5, 10.0, n)
    valid = g.random(n) < 0.9
    cfg, row0, rows = RasterConfig(tile_size=RECT_TILE), 0, None
    if name == "rect_32":          # 8 x 4 tiles, edges on tile borders
        u[:k] = 16 * g.integers(3, 12, k) + 8
        v[:k] = 16 * g.integers(1, 4, k) + 8
        rx[:k], ry[:k], valid[:k] = 56, 24, True
    elif name == "rect_33":        # 11 x 3 tiles: no mask
        u[:k] = 16 * g.integers(5, 11, k)
        v[:k] = 16 * g.integers(1, 7, k)
        rx[:k], ry[:k], valid[:k] = 80, 16, True
    elif name == "zero_radius":
        rx[:k // 2] = 0
        ry[k // 2:k] = 0
        valid[:k] = True
    elif name == "invalid":
        valid[:k] = False
    elif name == "alpha_min":
        opacity[:k // 2] = np.float32(amin)
        opacity[k // 2:k] = np.nextafter(np.float32(amin), np.float32(1))
        valid[:k] = True
    elif name == "degenerate_conic":
        a = np.float32(1e-3)
        conic[:k // 4] = [a, a * (1 - 1e-6), a]       # det ~ 0
        conic[k // 4:k // 2] = [a, -a, a]            # det = 0
        conic[k // 2:3 * k // 4] = 0.0               # zero conic
        conic[3 * k // 4:k] = [1e30, 1e30, 1e30]     # inf in the products
        valid[:k] = True
    elif name == "knife_edge":
        # q's minimum over tile (8, 3) at the cull's threshold, 9.01 / 0.999
        # (opacity 1, so tau = sigma_radius^2 = 9), all three of its terms
        # non-zero, the centre stepped by one float32 ulp a row: the test
        # flips inside the run, where one rounding decides it.
        s_, rho_ = 20.0, 0.1
        d_ = s_ ** 4 * (1 - rho_ ** 2)
        x0 = s_ * np.sqrt(9.01 / 0.999)
        u[:k] = np.float32(128 - x0) + np.arange(-k // 2, k // 2) * 2.0 ** -17
        v[:k] = 50.0
        rx[:k], ry[:k] = 70, 4
        conic[:k] = [s_ * s_ / d_, -rho_ * s_ * s_ / d_, s_ * s_ / d_]
        opacity[:k], valid[:k] = 1.0, True
    elif name == "strip":
        row0, rows = 2, 3
    elif name == "no_cull":
        cfg = RasterConfig(tile_size=RECT_TILE, tile_cull=False)
    proj = _fields(u, v, rx, ry, conic.astype(np.float32), opacity, depth,
                   valid)
    return proj, cfg, RECT_W, RECT_H, row0, rows


def _pack_bits(cfg, width, height, rows):
    """(tiles_x, tiles_y, tile_rows, (by, bw, bh), rect dtype) as
    compact_rects sets them."""
    tiles_x, tiles_y = tile_grid(width, height, cfg.tile_size)
    rows = tiles_y if rows is None else rows
    by = max(int(rows).bit_length(), 1)
    bw = max(int(tiles_x).bit_length(), 1)
    rdt = torch.int32 if 2 * (by + bw) <= 31 else torch.int64
    return tiles_x, tiles_y, rows, (by, bw, by), rdt


def _front(proj, cfg, width, height, row0, rows, fn):
    """`fn` (tile_rects_torch or the twin) on a case, as compact_rects calls
    it."""
    tiles_x, tiles_y, rows, bits, rdt = _pack_bits(cfg, width, height, rows)
    return fn(proj.mean2d, proj.conic, proj.opacity, proj.depth,
              proj.radius_xy, proj.valid, cfg, tiles_x, tiles_y, row0, rows,
              bits, rdt)


def _tiles(rect, pack_bits):
    """(tw, th) unpacked from packed rects."""
    _, bw, bh = pack_bits
    return ((rect >> bh) & ((1 << bw) - 1)).to(torch.int32), \
        (rect & ((1 << bh) - 1)).to(torch.int32)


@pytest.mark.parametrize("name", [
    "projected", "random", "rect_32", "rect_33", "zero_radius", "invalid",
    "alpha_min", "degenerate_conic", "knife_edge", "strip", "no_cull"])
def test_rects_twin_matches_plain(name):
    """The kernel's per-gaussian loop over only its rect's own tiles (the
    plain twin) gives the plain version's (N, 32)-lane rects, survivor
    masks, counts and depth keys bit for bit: rects of exactly 32 and 33
    tiles, zero radii, invalid rows, opacity at alpha_min, degenerate and
    zero conics, tiles at the cull's threshold to the ulp, a strip, the
    cull off and a projected scene."""
    case = _rect_case(name)
    want = _front(*case, tile_rects_torch)
    got = _front(*case, tile_rects_twin)
    for what, a, b in zip(("rect", "mask", "count", "key"), got, want):
        assert a.dtype == b.dtype, what
        if what == "key":
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), what
    proj, cfg, width, height, _, rows = case
    rect, mask, count, _ = want
    tw, th = _tiles(rect, _pack_bits(cfg, width, height, rows)[3])
    k = 60
    assert int((count > 0).sum()) > 10
    assert bool((mask != 0).any()) == (name != "no_cull")
    if name == "rect_32":
        assert bool((tw[:k] * th[:k] == MASK_TILES).all())
        assert bool((mask[:k] != 0).all())
    elif name == "rect_33":
        assert bool((tw[:k] * th[:k] == MASK_TILES + 1).all())
        assert bool((mask[:k] == 0).all()) and bool((count[:k] == 33).all())
    elif name == "knife_edge":
        assert len(set(mask[:k].tolist())) == 2
    elif name in ("zero_radius", "invalid"):
        assert bool((count[:k] == 0).all()) and bool((rect[:k] == 0).all())
    elif name == "no_cull":
        assert bool((mask == 0).all())


@pytest.mark.parametrize("name,cfg,row0,rows", [
    ("cull", RasterConfig(), 0, None),
    ("no_cull", RasterConfig(tile_cull=False), 0, None),
    ("strip", RasterConfig(), 1, 2),
    ("strip_no_cull", RasterConfig(tile_cull=False), 1, 2),
    ("clamped", RasterConfig(max_tiles_per_gaussian=3), 0, None),
    ("int64", RasterConfig(tile_size=16), 0, None),
], ids=lambda x: x if isinstance(x, str) else "")
def test_sorted_counts_equal_the_recount(name, cfg, row0, rows):
    """compact_rects takes each rank's pair count as counts[order], the
    counts the front already made. Before that it unpacked tw and th from
    the sorted rects and popcounted the sorted masks again; the two are
    equal bit for bit with the cull on and off, on a strip (tile_row0 > 0),
    with the count clamped, and on int64 rects, and so are the offsets."""
    if name == "int64":
        jp, *_ = _fake_proj(64, 8192, 8192, max_r=400)
        width = height = 8192
    else:
        jp, width, height = _jax_proj(), 160, 96
    proj = port_projected(jp)
    rect, mask, counts, key = _front(proj, cfg, width, height, row0, rows,
                                     tile_rects_torch)
    assert rect.dtype == (torch.int64 if name == "int64" else torch.int32)
    order = torch.sort(key, stable=True).indices
    rect_c, mask_c = rect[order], mask[order]
    tw_c, th_c = _tiles(rect_c, _pack_bits(cfg, width, height, rows)[3])
    mt = cfg.max_tiles_per_gaussian
    recount = torch.where(mask_c != 0, torch.clamp(popcount(mask_c), max=mt),
                          torch.clamp(tw_c * th_c, max=mt))
    assert torch.equal(counts[order], recount)
    assert int(recount.sum()) > 0
    assert bool((mask != 0).any()) == (cfg.tile_cull and name != "int64")
    c = compact_rects(proj, width, height, cfg, row0, rows, capacity=4096)
    off = torch.clamp(torch.cumsum(recount, 0) - recount, max=4096)
    assert torch.equal(c.off_c, off.to(torch.int32))
    assert int(c.num_pairs) + int(c.overflow) == int(recount.sum())


def _rects_inputs(case):
    """Small CPU inputs of R's wrapper, one of them broken by `case`."""
    n = 8
    t = dict(mean2d=torch.zeros((n, 2)), conic=torch.zeros((n, 3)),
             opacity=torch.zeros((n,)), depth=torch.zeros((n,)),
             radius_xy=torch.zeros((n, 2), dtype=torch.int32),
             valid=torch.ones((n,), dtype=torch.bool))
    if case == "mean_dtype":
        t["mean2d"] = t["mean2d"].double()
    elif case == "radius_dtype":
        t["radius_xy"] = t["radius_xy"].long()
    elif case == "valid_dtype":
        t["valid"] = t["valid"].to(torch.uint8)
    elif case == "conic_shape":
        t["conic"] = torch.zeros((n, 2))
    elif case == "depth_shape":
        t["depth"] = torch.zeros((n + 1,))
    elif case == "not_contiguous":
        t["mean2d"] = torch.zeros((n, 4))[:, ::2]
    return t


@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA tensors"),
    ("mean_dtype", "float32"),
    ("radius_dtype", "int32"),
    ("valid_dtype", "bool"),
    ("conic_shape", "shape"),
    ("depth_shape", "shape"),
    ("not_contiguous", "contiguous"),
    ("rect_dtype", "int32 or int64"),
])
def test_tile_rects_cuda_refuses(case, match):
    """R's wrapper raises ValueError on CPU tensors, a wrong dtype or
    shape, a row whose entries are not adjacent and another rect width,
    before it builds or launches anything. A strided column of the payload
    is taken as it is."""
    before = RECTS.launches
    rdt = torch.int16 if case == "rect_dtype" else torch.int32
    with pytest.raises(ValueError, match=match):
        tile_rects_cuda(**_rects_inputs(case), cfg=RasterConfig(), tiles_x=4,
                        tiles_y=4, tile_row0=0, tile_rows=4,
                        pack_bits=(3, 3, 3), rect_dtype=rdt)
    assert RECTS.launches == before and RECTS._lib is None


def test_rects_launch_shape_matches_the_kernel():
    src = (CSRC_DIR / "rects.cu").read_text()
    threads = int(re.search(r"kThreads = (\d+);", src).group(1))
    tiles = int(re.search(r"kMaskTiles = (\d+);", src).group(1))
    assert (threads, tiles) == (THREADS, MASK_TILES)
    assert 'extern "C" int gs_tile_rects_i64(' in src
    assert "launch_rects<long long>" in src

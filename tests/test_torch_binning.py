"""Port parity of tile binning: the port's plain binning (including the plain
version of the K4 expansion kernel) is fed the JAX reference's `Projected`
arrays, so float rounding in projection cannot move a tile boundary, and
every integer field must equal JAX `bin_gaussians` up to `num_pairs`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import np_, port_projected
from test_binning_fallbacks import _fake_proj

from gaussiansplat_tpu.config import RasterConfig as JRasterConfig
from gaussiansplat_tpu.models import random_model as j_random_model
from gaussiansplat_tpu.ops import look_at as j_look_at
from gaussiansplat_tpu.ops.binning import bin_gaussians as j_bin
from gaussiansplat_tpu.ops.projection import project_gaussians as j_project
from gaussiansplat_tpu_torch.config import RasterConfig
from gaussiansplat_tpu_torch.ops.binning import bin_gaussians, compact_rects
from gaussiansplat_tpu_torch.ops.kernels.expand import _kth_set_bit, popcount

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

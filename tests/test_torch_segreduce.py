"""Port parity of the gradient reduce (the payload-gather VJP) on the CPU.

* The plain version of K3 (`segment_reduce_pairs_torch`) against the
  reference's Pallas segment-reduce kernel in interpret mode and against
  `jax.ops.segment_sum`, on the pre-sort pair rows of a reference binning.
* `TileBinning.gather_payload`'s backward (un-permute, tail mask, plain K3,
  rank -> original index) against autodiff of the plain gather in JAX and
  against the reference's `reduce_pair_grads` with its Pallas kernel, on
  tests/test_gather_vjp.py's cases: 8 pairs per gaussian, 0.5 (capacity
  overflow), and garbage cotangent rows past num_pairs.

All within rtol = atol = 1e-6, the bound of tests/test_gather_vjp.py: the
sums run over the same rows in f32, in another order.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from test_torch_common import limit_torch_threads, np_

from gaussiansplat_tpu.config import RasterConfig as JRasterConfig
from gaussiansplat_tpu.models import random_model as j_random_model
from gaussiansplat_tpu.ops import look_at as j_look_at
from gaussiansplat_tpu.ops.binning import bin_gaussians as j_bin
from gaussiansplat_tpu.ops.binning import reduce_pair_grads as j_reduce
from gaussiansplat_tpu.ops.pallas.segreduce import segment_reduce_pairs as j_segreduce
from gaussiansplat_tpu.ops.projection import make_payload as j_payload
from gaussiansplat_tpu.ops.projection import project_gaussians as j_project
from gaussiansplat_tpu_torch.ops.binning import TileBinning, reduce_pair_grads
from gaussiansplat_tpu_torch.ops.kernels.build import CSRC_DIR
from gaussiansplat_tpu_torch.ops.kernels.segreduce import (
    GROUPS,
    LONG_ROWS,
    long_segment_pieces,
    segment_reduce_pairs_split,
    segment_reduce_pairs_torch,
)

limit_torch_threads()

BINNING_FIELDS = ("sorted_ranks", "depth_order", "sorted_tiles", "tile_starts",
                  "num_pairs", "overflow", "sorted_pos", "seg_offsets")


def _setup(n=300, pairs_per_gaussian=8.0, seed=0):
    """The scene of tests/test_gather_vjp.py: the reference's payload and
    binning, as numpy."""
    cfg = JRasterConfig(pairs_per_gaussian=pairs_per_gaussian)
    model = j_random_model(jax.random.PRNGKey(seed), n, sh_degree=1,
                           extent=1.0, opacity=0.8, scale_range=(0.02, 0.08))
    cam = j_look_at(eye=(0.2, -0.1, -4.0), target=(0, 0, 0), fx=300.0,
                    fy=300.0, width=256, height=192)

    @jax.jit
    def run(model, cam):
        proj = j_project(model.means, model.quats, model.log_scales,
                         model.logit_opacities, model.sh, cam, cfg,
                         sh_degree=1, alive=model.alive)
        return j_payload(proj), j_bin(proj, cam.width, cam.height, cfg,
                                      impl="xla")

    payload, binning = run(model, cam)
    return np.asarray(payload), binning


def _port_binning(jb) -> TileBinning:
    return TileBinning(**{f: torch.as_tensor(np.array(getattr(jb, f)))
                          for f in BINNING_FIELDS})


def _cotangent(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_reduce_pair_grads_unpermutes_exactly():
    """With one pair per rank the reduce is a pure permutation: each valid
    row lands, bit for bit, at depth_order[sorted_pos[i]]; rows past
    num_pairs (pre-sort order) come out zero."""
    rng = np.random.default_rng(0)
    n, num_pairs = 1000, 900
    sorted_pos = rng.permutation(n)
    depth_order = rng.permutation(n)
    dsorted = _cotangent((n, 16))
    got = np_(reduce_pair_grads(
        torch.tensor(dsorted), torch.tensor(depth_order, dtype=torch.int32),
        torch.tensor(sorted_pos, dtype=torch.int32),
        torch.arange(n + 1, dtype=torch.int32),
        torch.tensor(num_pairs, dtype=torch.int32), "torch"))
    dpre = np.empty_like(dsorted)
    dpre[sorted_pos] = dsorted
    dpre[num_pairs:] = 0.0
    want = np.empty_like(dpre)
    want[depth_order] = dpre
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pairs_per_gaussian", [8.0, 0.5])
def test_plain_segment_reduce_matches_jax(pairs_per_gaussian):
    payload, jb = _setup(pairs_per_gaussian=pairs_per_gaussian)
    n = payload.shape[0]
    p = jb.capacity
    num_pairs = int(jb.num_pairs)
    seg = np.asarray(jb.seg_offsets)
    if pairs_per_gaussian < 1:
        assert int(jb.overflow) > 0
    # Pre-sort rows: each depth rank's pairs contiguous, the tail zero.
    dsorted = _cotangent((p, 16))
    dpre = np.zeros_like(dsorted)
    dpre[np.asarray(jb.sorted_pos)] = dsorted
    dpre[num_pairs:] = 0.0

    got = np_(segment_reduce_pairs_torch(torch.tensor(dpre), torch.tensor(seg), n))
    want_pallas = np.asarray(jax.jit(lambda d, s: j_segreduce(
        d.T, s, n, interpret=True))(jnp.asarray(dpre), jnp.asarray(seg)))
    rank = np.clip(np.searchsorted(seg, np.arange(p), side="right") - 1, 0, n - 1)
    want_sum = np.asarray(jax.ops.segment_sum(jnp.asarray(dpre),
                                              jnp.asarray(rank), num_segments=n))
    assert got.shape == (n, 16)
    np.testing.assert_allclose(got, want_pallas, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, want_sum, rtol=1e-6, atol=1e-6)
    assert np.abs(got).max() > 0


@pytest.mark.parametrize("pairs_per_gaussian", [8.0, 0.5])
def test_gather_vjp_matches_jax(pairs_per_gaussian):
    payload, jb = _setup(pairs_per_gaussian=pairs_per_gaussian)
    valid = (np.arange(jb.capacity) < int(jb.num_pairs))[:, None]
    cot = _cotangent((jb.capacity, payload.shape[1])) * valid

    def plain(p):
        return jnp.vdot(p[jb.depth_order][jb.sorted_ranks], jnp.asarray(cot))

    want = np.asarray(jax.jit(jax.grad(plain))(jnp.asarray(payload)))
    want_reduce = np.asarray(jax.jit(lambda d: j_reduce(
        d, jb.sorted_ranks, jb.depth_order, jb.sorted_pos, jb.seg_offsets,
        jb.num_pairs, "pallas_interpret"))(jnp.asarray(cot)))

    b = _port_binning(jb)
    x = torch.tensor(payload, requires_grad=True)
    (b.gather_payload(x) * torch.tensor(cot)).sum().backward()
    got = np_(x.grad)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, want_reduce, rtol=1e-6, atol=1e-6)
    direct = np_(reduce_pair_grads(torch.tensor(cot), b.depth_order,
                                   b.sorted_pos, b.seg_offsets, b.num_pairs,
                                   "torch"))
    np.testing.assert_array_equal(direct, got)
    assert np.abs(got).max() > 0


def test_gather_vjp_masks_tail_garbage():
    """Cotangent rows past num_pairs must not leak into gradients."""
    payload, jb = _setup()
    cot = np.ones((jb.capacity, payload.shape[1]), np.float32)
    valid = (np.arange(jb.capacity) < int(jb.num_pairs))[:, None]
    assert not valid.all()

    def plain_masked(p):
        return jnp.vdot(p[jb.depth_order][jb.sorted_ranks],
                        jnp.asarray(np.where(valid, cot, 0.0)))

    want = np.asarray(jax.jit(jax.grad(plain_masked))(jnp.asarray(payload)))
    b = _port_binning(jb)
    x = torch.tensor(payload, requires_grad=True)
    (b.gather_payload(x) * torch.tensor(cot)).sum().backward()
    np.testing.assert_allclose(np_(x.grad), want, rtol=1e-6, atol=1e-6)


@st.composite
def _segments(draw):
    """Segment lengths around the split threshold and up to
    max_tiles_per_gaussian, empty ones included, and a row count P that is
    num_pairs exactly or leaves a zero tail."""
    lens = draw(st.lists(st.one_of(st.integers(0, 3),
                                   st.integers(LONG_ROWS - 2, LONG_ROWS + 2),
                                   st.integers(0, 1024)),
                         min_size=1, max_size=60))
    seg = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    tail = draw(st.sampled_from([0, 5]))
    seed = draw(st.integers(0, 2 ** 16))
    return seg, tail, seed


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(_segments())
def test_split_order_matches_plain(case):
    """K3's summation order (its plain twin) against the plain version:
    the same bits on every segment of at most LONG_ROWS rows (row order from
    +0, as `index_add_` on the CPU); empty segments give zero rows. On the
    split ones, within 1e-5 of each channel's largest sum of magnitudes: a
    sum in another order moves by up to ~len x 2^-24 of that, whatever the
    sum itself (hypothesis finds lone segments that cancel to ~1e-3)."""
    seg, tail, seed = case
    n = seg.shape[0] - 1
    rng = np.random.default_rng(seed)
    rows = rng.normal(size=(int(seg[-1]) + tail, 16)).astype(np.float32)
    rows[int(seg[-1]):] = 0.0
    rows_t, seg_t = torch.as_tensor(rows), torch.as_tensor(seg)
    got = np_(segment_reduce_pairs_split(rows_t, seg_t, n))
    want = np_(segment_reduce_pairs_torch(rows_t, seg_t, n))
    lens = np.diff(seg)
    short = lens <= LONG_ROWS
    np.testing.assert_array_equal(got[short], want[short])
    assert not got[lens == 0].any()
    mags = np_(segment_reduce_pairs_torch(torch.as_tensor(np.abs(rows)),
                                          seg_t, n))
    scale = np.maximum(mags.max(0), 1e-30)
    assert (np.abs(got - want) / scale).max() <= 1e-5


def test_long_segment_pieces_partition_each_split_segment():
    lens = np.array([0, LONG_ROWS, LONG_ROWS + 1, 7, GROUPS, 1000, 1024])
    seg = torch.as_tensor(
        np.concatenate([[0], np.cumsum(lens)]).astype(np.int32))
    ranks, bounds = long_segment_pieces(seg)
    assert ranks.tolist() == [2, 4, 5, 6]
    assert bounds.shape == (4, GROUPS + 1)
    assert torch.equal(bounds[:, 0], seg[ranks].long())
    assert torch.equal(bounds[:, -1], seg[ranks + 1].long())
    plen = bounds[:, 1:] - bounds[:, :-1]
    assert bool((plen >= 0).all())
    # Balanced: the pieces of a segment differ by at most one row.
    assert bool((plen.amax(1) - plen.amin(1) <= 1).all())


def test_split_shape_matches_the_kernel():
    src = (CSRC_DIR / "segreduce.cu").read_text()
    threads = int(re.search(r"kThreads = (\d+);", src).group(1))
    long_rows = int(re.search(r"kLongRows = (\d+);", src).group(1))
    assert (threads // 4, long_rows) == (GROUPS, LONG_ROWS)

"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`; every test skips (inside the `cuda` fixture) where
torch.cuda.is_available() is False. This file imports no JAX, so it also
runs on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

K2 (backward raster) is held against its plain version under a seeded
random cotangent: rows 0-10 scaled by each row's largest magnitude, all but
0.1% of the entries within 1e-4 and every entry within 1e-2 (the kernel
rewinds transmittance per pixel and sums in another order, ~1e-6; a
knife-edge alpha gate can flip where exp rounds differently). K3 (segment reduce)
within 1e-5 of each channel's largest magnitude. Both kernels must give the
same bits on two launches. K4 and K3 are also held at the edges of their
designs on synthetic inputs: K4 integer-equal to its plain version, K3
bit-equal to the plain twin of its summation order.
The timing variants of K1, K2 and K3 (`ablate=`) are held to their
contracts against the production kernels' outputs on the same synthetic
inputs (`ablate.contract`), each on its own launch counter.
On a small scene, `run_resilient` around `Trainer.fit` restarts after the
caching allocator's own out-of-memory and ends bit-equal to a straight run,
and one training step from two copies of a state is bit-equal.
Under torch.profiler the program's spans time a frame and a step on the
card without a synchronizing call.
The pair gather writes the rows [0, num_pairs) bit for bit as its plain
version (two index_selects) and leaves the rest as they were; a render
whose gather output starts as NaN gives the index_select path's image,
transmittance and gradients bit for bit, so no reader uses those rows.
R (the binning's rects, survivor masks, counts and depth keys) is bit-equal
to its plain version on the same CUDA tensors, and the whole binning with
it to the plain binning, on the benchmark's scene at 1080p, 4K, a strip,
the 8K int64 grid and a tile edge that is no power of two.
"""

import dataclasses

import numpy as np
import pytest
import torch

from imgcheck import assert_images_close

from gaussiansplat_tpu_torch.config import RasterConfig
from gaussiansplat_tpu_torch.models import random_model
from gaussiansplat_tpu_torch.ops.binning import (
    bin_gaussians,
    compact_rects,
    expand_compacted,
    tile_grid,
    tile_rects_torch,
)
from gaussiansplat_tpu_torch.ops.camera import look_at
from gaussiansplat_tpu_torch.ops.kernels import ablate, backward, forward
from gaussiansplat_tpu_torch.ops.kernels.backward import (
    BACKWARD,
    rasterize_backward_cuda,
    rasterize_backward_torch,
)
from gaussiansplat_tpu_torch.ops.kernels.expand import (
    EXPAND,
    SLOTS_PER_BLOCK,
    expand_pairs_cuda,
    expand_pairs_torch,
)
from gaussiansplat_tpu_torch.ops.kernels.forward import (
    FORWARD,
    rasterize_forward_cuda,
    rasterize_forward_torch,
)
from gaussiansplat_tpu_torch.ops.kernels.gather import (
    GATHER,
    gather_pairs_cuda,
    gather_pairs_torch,
)
from gaussiansplat_tpu_torch.ops.kernels.rects import RECTS, tile_rects_cuda
from gaussiansplat_tpu_torch.ops.kernels.segreduce import (
    GROUPS,
    LONG_ROWS,
    SEGREDUCE,
    segment_reduce_pairs_cuda,
    segment_reduce_pairs_split,
    segment_reduce_pairs_torch,
)
from gaussiansplat_tpu_torch.ops.projection import (
    make_payload,
    payload_to_projected,
    project_gaussians,
)
from gaussiansplat_tpu_torch.render import render

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _scene(device, n, width, height, seed=0, opacity=0.8, fx=None):
    g = torch.Generator().manual_seed(seed)
    model = random_model(g, n, sh_degree=3, opacity=opacity, device=device)
    cam = look_at(eye=(0.5, 0.3, -6.0), target=(0, 0, 0),
                  fx=fx or 1.7 * width, fy=fx or 1.7 * width,
                  width=width, height=height, device=device)
    return model, cam


def _project(model, cam, cfg):
    return project_gaussians(model.means, model.quats, model.log_scales,
                             model.logit_opacities, model.sh, cam, cfg,
                             sh_degree=3, alive=model.alive)


@pytest.mark.parametrize(
    "n,width,height", [(4096, 256, 192), (70_000, 8160, 4064)],
    ids=["packed_keys", "separate_streams"])
def test_expand_matches_plain(cuda, n, width, height):
    cfg = RasterConfig()
    model, cam = _scene(cuda, n, width, height, fx=0.5 * width)
    with torch.no_grad():
        c = compact_rects(_project(model, cam, cfg), width, height, cfg)
        assert c.packed_keys == (n < 10_000)
        assert int(c.num_pairs) > 0
        before = EXPAND.launches
        got = expand_compacted(c, "cuda")
        want = expand_compacted(c, "torch")
        torch.cuda.synchronize()
    assert EXPAND.launches == before + 1
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _compacted(device, counts, masks, rects, capacity):
    """K4's inputs as compact_rects lays them out, from per-rank pair
    counts (0 for the empty tail), survivor masks and packed rects on a
    64 x 64 tile grid (7 bits for each of xmin, ymin, tw, th)."""
    counts = np.asarray(counts, np.int64)
    off = np.minimum(np.cumsum(counts) - counts, capacity)

    def as_i32(a):  # the low 32 bits, as the kernel reads them
        return torch.as_tensor(
            np.asarray(a, np.int64).astype(np.uint32).view(np.int32)).to(device)

    return (as_i32(off), as_i32(rects), as_i32(masks),
            torch.tensor(min(int(counts.sum()), capacity), dtype=torch.int32,
                         device=device))


def _expand_case(name, seed=0):
    """(counts, masks, rects, capacity, packed) of one edge case."""
    rng = np.random.default_rng(seed)
    n = 3000
    tw, th = rng.integers(1, 6, n), rng.integers(1, 6, n)
    masks = np.zeros(n, np.int64)
    small = tw * th <= 32
    masks[small] = (rng.integers(0, 2 ** 32, small.sum())
                    & ((1 << (tw * th)[small]) - 1))
    if name == "mask_bit31":
        # 8 x 4 rects whose masks keep tile 31: bit 31 is the int32 sign.
        tw[:50], th[:50] = 8, 4
        masks[:50] = rng.integers(0, 2 ** 31, 50) | (1 << 31)
        masks[0], masks[1] = 1 << 31, 2 ** 32 - 1
    counts = np.where(masks != 0, [bin(int(m)).count("1") for m in masks],
                      np.minimum(tw * th, 1024))
    if name == "owner_over_a_block":
        tw[7], th[7], masks[7] = 60, 60, 0
        counts[7] = 3000          # more slots than a block of 1024
    empty = {"no_pairs": n, "one_rank": 0}.get(name, 40)
    if name == "one_rank":
        counts, masks, tw, th = counts[:1], masks[:1], tw[:1], th[:1]
        counts[0], masks[0], tw[0], th[0] = 37, 0, 37, 1
    counts[len(counts) - empty:] = 0
    xmin = rng.integers(0, 64 - tw + 1)
    ymin = rng.integers(0, 64 - th + 1)
    rects = np.where(counts > 0, (((xmin << 7 | ymin) << 7 | tw) << 7) | th, 0)
    masks = np.where(counts > 0, masks, 0)
    total = int(counts.sum())
    # Odd: a multiple of neither the block nor the 4-slot store.
    capacity = {"no_pairs": 3 * SLOTS_PER_BLOCK + 5,
                "overflow": total - 777}.get(name, total + SLOTS_PER_BLOCK) | 1
    return counts, masks, rects, capacity, name != "separate_streams"


@pytest.mark.parametrize("name", ["no_pairs", "overflow", "one_rank",
                                  "owner_over_a_block", "mask_bit31",
                                  "separate_streams", "ragged_capacity"])
def test_expand_edges_match_plain(cuda, name):
    """K4 integer-equal to its plain version over the whole capacity at the
    edges of its design: num_pairs = 0 (every block only stores); overflow
    (num_pairs = capacity, the tail ranks' offsets clipped); n = 1; one
    rank owning more slots than a block of SLOTS_PER_BLOCK; survivor masks
    with bit 31 set (the int32 sign); the separate-streams regime; and, in
    every case, a capacity that is a multiple of neither the block nor the
    4-slot store."""
    counts, masks, rects, capacity, packed = _expand_case(name)
    assert capacity % SLOTS_PER_BLOCK and capacity % 4
    off, rect, mask, num_pairs = _compacted(cuda, counts, masks, rects,
                                            capacity)
    n = off.shape[0]
    rank_bits = max(int(n - 1).bit_length(), 1)
    args = (off, rect, mask, num_pairs, capacity, 64, 64 * 64, rank_bits,
            (7, 7, 7), packed)
    before = EXPAND.launches
    got = expand_pairs_cuda(*args)
    want = expand_pairs_torch(*args)
    torch.cuda.synchronize()
    assert EXPAND.launches == before + 1
    if name == "overflow":
        assert int(num_pairs) == capacity
    if name == "no_pairs":
        assert int(num_pairs) == 0
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _segment_case(name, seed=0):
    """(segment lengths, zero rows after the last segment) of one case."""
    rng = np.random.default_rng(seed)
    if name == "empty_segments":
        lens = rng.integers(0, 3, 500) * (rng.random(500) < 0.5)
        return lens, 9
    if name == "one_of_1024":
        return np.array([3, 1024, 2]), 0
    if name == "long_at_every_boundary":
        # Long ranks at the first and last rank of blocks and warps, several
        # in one block (the partials' double buffer), of lengths around the
        # threshold and the piece count (pieces of 0, 1 and 2 rows).
        lens = rng.integers(0, 6, 4 * GROUPS + 13)
        long_lens = [LONG_ROWS + 1, GROUPS - 1, GROUPS, GROUPS + 1,
                     2 * GROUPS - 1, 2 * GROUPS + 1, 1000, LONG_ROWS]
        at = [0, 7, 8, 15, 63, 64, 65, 71, 72, 127, 128, 129, 191, 255, 256,
              4 * GROUPS + 12]
        for i, r in enumerate(at):
            lens[r] = long_lens[i % len(long_lens)]
        return lens, 0
    if name == "ragged_n":
        return rng.integers(0, 9, 3 * GROUPS + 5), 3
    raise ValueError(name)


@pytest.mark.parametrize("name", ["empty_segments", "one_of_1024",
                                  "long_at_every_boundary", "ragged_n"])
def test_segment_reduce_edges(cuda, name):
    """K3 at the edges of its design: empty segments (zero rows), one
    segment of 1024 rows, long segments at every block and warp boundary
    and of lengths that give pieces of 0, 1 and 2 rows, n a multiple of
    neither the warp's 8 ranks nor the block's 64, and P = num_pairs exactly
    (no row past the last segment). Bit-equal to the plain twin of its
    order, the same bits on two launches, within 1e-5 of each channel's
    largest entry of the plain version."""
    lens, tail = _segment_case(name)
    seg = torch.as_tensor(
        np.concatenate([[0], np.cumsum(lens)]).astype(np.int32))
    n, num_pairs = len(lens), int(seg[-1])
    g = torch.Generator().manual_seed(len(name))
    rows = torch.randn((num_pairs + tail, 16), generator=g)
    rows[num_pairs:] = 0.0
    rows, seg = rows.to(cuda), seg.to(cuda)
    got = segment_reduce_pairs_cuda(rows, seg, n)
    again = segment_reduce_pairs_cuda(rows, seg, n)
    twin = segment_reduce_pairs_split(rows, seg, n)
    want = segment_reduce_pairs_torch(rows, seg, n)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    assert torch.equal(got.view(torch.int32), twin.view(torch.int32))
    assert not got[torch.as_tensor(lens == 0, device=cuda)].any()
    scale = want.abs().amax(0).clamp(min=1e-12)
    assert float(((got - want).abs() / scale).max()) <= 1e-5


@pytest.mark.parametrize("chunk_size,trans_eps", [(128, 1e-4), (8, 1e-4),
                                                  (128, 0.0)],
                         ids=["cs128", "cs8_early_exit", "cs128_no_exit"])
def test_forward_matches_plain(cuda, chunk_size, trans_eps):
    cfg = RasterConfig(chunk_size=chunk_size, trans_eps=trans_eps)
    model, cam = _scene(cuda, 4096, 256, 192, opacity=0.99, fx=880.0)
    with torch.no_grad():
        proj = _project(model, cam, cfg)
        b = bin_gaussians(proj, cam.width, cam.height, cfg, impl="cuda")
        sp = b.gather_payload(make_payload(proj))
        before = FORWARD.launches
        got = rasterize_forward_cuda(sp, b.tile_starts, cam.width,
                                     cam.height, cfg)
        want = rasterize_forward_torch(sp, b.tile_starts, cam.width,
                                       cam.height, cfg)
        torch.cuda.synchronize()
    assert FORWARD.launches == before + 1
    got, want = got.cpu().numpy(), want.cpu().numpy()
    for row in range(5):
        assert_images_close(got[:, row], want[:, row], atol=2e-4)
    # A gate flip moves the depth sum by ~alpha_min * depth.
    depth_scale = float(proj.depth[proj.valid].max())
    assert_images_close(got[:, 5] / depth_scale, want[:, 5] / depth_scale,
                        atol=2e-4)
    np.testing.assert_array_equal(got[:, 6], want[:, 6])
    starts = b.tile_starts.cpu().numpy().astype(np.int64)
    base = starts[:-1] // chunk_size * chunk_size
    n_chunks = (starts[1:] - base + chunk_size - 1) // chunk_size
    exited = got[:, 6, 0] < n_chunks
    if trans_eps == 0:
        assert not exited.any(), "a tile stopped with early exit off"
    if chunk_size == 8:
        assert exited.any(), "no tile exited early"


@pytest.mark.parametrize("tile_size,tile_row0,tile_rows", [(16, 0, None),
                                                         (32, 2, 3)],
                         ids=["tile16", "strip"])
def test_forward_tiles_and_strips_match_plain(cuda, tile_size, tile_row0,
                                              tile_rows):
    cfg = RasterConfig(tile_size=tile_size)
    model, cam = _scene(cuda, 2048, 256, 192)
    with torch.no_grad():
        proj = _project(model, cam, cfg)
        b = bin_gaussians(proj, cam.width, cam.height, cfg, impl="cuda",
                          tile_row0=tile_row0, tile_rows=tile_rows)
        sp = b.gather_payload(make_payload(proj))
        args = (sp, b.tile_starts, cam.width, cam.height, cfg)
        kw = dict(tile_row0=tile_row0, tile_rows=tile_rows)
        got = rasterize_forward_cuda(*args, **kw).cpu().numpy()
        want = rasterize_forward_torch(*args, **kw).cpu().numpy()
    assert int(b.num_pairs) > 0
    for row in (0, 1, 2, 4):
        assert_images_close(got[:, row], want[:, row], atol=2e-4)
    np.testing.assert_array_equal(got[:, 6], want[:, 6])


def test_render_cuda_matches_torch(cuda):
    model, cam = _scene(cuda, 2048, 320, 240)
    bg = torch.tensor([0.1, 0.2, 0.3], device=cuda)
    with torch.no_grad():
        a = render(model, cam, RasterConfig(impl="cuda"), background=bg)
        b = render(model, cam, RasterConfig(impl="torch"), background=bg)
    assert int(a.overflow) == 0 and int(a.num_pairs) == int(b.num_pairs)
    assert_images_close(a.image.cpu().numpy(), b.image.cpu().numpy())
    assert_images_close(a.transmittance.cpu().numpy(),
                        b.transmittance.cpu().numpy())


def _assert_rows_close(got, want, what, bulk_atol=1e-4, bulk_frac=1e-3,
                       atol=1e-2):
    scale = want.abs().max().clamp(min=1e-12)
    d = (got - want).abs() / scale
    assert float(d.max()) <= atol, f"{what}: max scaled |diff| {float(d.max()):.3e}"
    frac = float((d > bulk_atol).float().mean())
    assert frac <= bulk_frac, f"{what}: {frac:.2%} of entries above {bulk_atol}"


def _backward_inputs(device, cfg, n=4096, seed=0):
    model, cam = _scene(device, n, 256, 192, seed=seed, opacity=0.99, fx=880.0)
    with torch.no_grad():
        proj = _project(model, cam, cfg)
        b = bin_gaussians(proj, cam.width, cam.height, cfg, impl="cuda")
        sp = b.gather_payload(make_payload(proj))
        fwd = rasterize_forward_cuda(sp, b.tile_starts, cam.width, cam.height, cfg)
    g = torch.Generator().manual_seed(seed + 7)
    cot = torch.randn(fwd.shape, generator=g).to(device)
    cot[:, 4:] = 0.0
    return cam, b, sp, fwd, cot


@pytest.mark.parametrize("chunk_size,trans_eps", [(128, 1e-4), (8, 1e-4),
                                                  (128, 0.0)],
                         ids=["cs128", "cs8_early_exit", "cs128_no_exit"])
def test_backward_matches_plain(cuda, chunk_size, trans_eps):
    cfg = RasterConfig(chunk_size=chunk_size, trans_eps=trans_eps)
    cam, b, sp, fwd, cot = _backward_inputs(cuda, cfg)
    args = (sp, b.tile_starts, cot, fwd, cam.width, cam.height, cfg)
    before = BACKWARD.launches
    got = rasterize_backward_cuda(*args)
    again = rasterize_backward_cuda(*args)
    want = rasterize_backward_torch(*args)
    torch.cuda.synchronize()
    assert BACKWARD.launches == before + 2
    n = int(b.num_pairs)
    assert n > 0
    assert torch.equal(got[:n], again[:n]), "K2 is not deterministic"
    for row in range(11):
        _assert_rows_close(got[:n, row], want[:n, row], f"row {row}")
    assert not got[:n, 11:].any()
    assert float(got[:n, :6].abs().max()) > 0


def test_segment_reduce_matches_plain(cuda):
    cfg = RasterConfig()
    _, b, _, _, _ = _backward_inputs(cuda, cfg)
    n, p = b.depth_order.shape[0], b.sorted_pos.shape[0]
    g = torch.Generator().manual_seed(3)
    rows = torch.randn((p, 16), generator=g).to(cuda)
    rows[int(b.num_pairs):] = 0.0
    before = SEGREDUCE.launches
    got = segment_reduce_pairs_cuda(rows, b.seg_offsets, n)
    again = segment_reduce_pairs_cuda(rows, b.seg_offsets, n)
    want = segment_reduce_pairs_torch(rows, b.seg_offsets, n)
    torch.cuda.synchronize()
    assert SEGREDUCE.launches == before + 2
    assert torch.equal(got, again), "K3 is not deterministic"
    twin = segment_reduce_pairs_split(rows, b.seg_offsets, n)
    assert torch.equal(got.view(torch.int32), twin.view(torch.int32))
    scale = want.abs().amax(0).clamp(min=1e-12)
    assert float(((got - want).abs() / scale).max()) <= 1e-5


def test_backward_launches_each_kernel_once(cuda):
    kernels = (EXPAND, GATHER, FORWARD, BACKWARD, SEGREDUCE)
    model, cam = _scene(cuda, 2048, 256, 192)
    counts = [k.launches for k in kernels]
    out = render(model, cam, RasterConfig(impl="cuda"))
    out.image.sum().backward()
    torch.cuda.synchronize()
    after = [k.launches for k in kernels]
    assert [a - c for a, c in zip(after, counts)] == [1, 1, 1, 1, 1]
    for name, prm in model.trainable().items():
        assert torch.isfinite(prm.grad).all(), name
    assert float(model.means.grad.abs().max()) > 0


def _gather_case(device, name):
    """(payload, depth_order, sorted_ranks, num_pairs) of a gather case:
    synthetic indices with M payload rows, N ranks and P slots, or a
    binning of a scene."""
    g = torch.Generator().manual_seed(21)
    synthetic = {  # name: (M, N, P, num_pairs)
        "no_pairs": (3000, 3000, 5000, 0),
        "ragged_tail": (3000, 3000, 5003, 4097),
        "every_slot": (3000, 3000, 5003, 5003),
        "more_payload_rows": (5000, 3000, 5003, 4000),
        "fewer_payload_rows": (1000, 3000, 5003, 4000),
    }
    if name in synthetic:
        m, n, p, k = synthetic[name]
        order = (torch.randperm(m, generator=g)[:n] if m >= n
                 else torch.randint(0, m, (n,), generator=g))
        ranks = torch.randint(0, n, (p,), generator=g)
        return (torch.randn((m, 16), generator=g).to(device),
                order.to(torch.int32).to(device),
                ranks.to(torch.int32).to(device),
                torch.tensor(k, dtype=torch.int32, device=device))
    n, width, height = ((70_000, 8160, 4064) if name == "separate_streams"
                        else (4096, 256, 192))
    cfg = RasterConfig()
    model, cam = _scene(device, n, width, height, fx=0.5 * width)
    with torch.no_grad():
        proj = _project(model, cam, cfg)
        b = bin_gaussians(proj, width, height, cfg, impl="cuda")
        if name == "overflow":
            b = bin_gaussians(proj, width, height, cfg, impl="cuda",
                              capacity=int(b.num_pairs) // 2)
            assert int(b.overflow) > 0
        return make_payload(proj), b.depth_order, b.sorted_ranks, b.num_pairs


@pytest.mark.parametrize("name", ["packed_keys", "separate_streams",
                                  "overflow", "no_pairs", "ragged_tail",
                                  "every_slot", "more_payload_rows",
                                  "fewer_payload_rows"])
def test_gather_matches_plain(cuda, name):
    """The gather kernel's rows [0, num_pairs) are its plain version's bit
    for bit, and the rows past num_pairs keep what the output held."""
    payload, order, ranks, num_pairs = _gather_case(cuda, name)
    p, k = ranks.shape[0], int(num_pairs)
    out = torch.full((p, 16), float("nan"), device=cuda)
    before = GATHER.launches
    got = gather_pairs_cuda(payload, order, ranks, num_pairs, out=out)
    want = gather_pairs_torch(payload, order, ranks, num_pairs)
    torch.cuda.synchronize()
    assert got is out and GATHER.launches == before + 1
    assert torch.equal(got[:k].view(torch.int32), want[:k].view(torch.int32))
    assert bool(got[k:].isnan().all())


def test_unwritten_gather_rows_are_never_read(cuda, monkeypatch):
    """A render whose gather output starts as NaN gives the index_select
    path's image, transmittance and every leaf's gradient bit for bit."""
    from gaussiansplat_tpu_torch.ops import binning

    model, cam = _scene(cuda, 2048, 256, 192, seed=4)
    g = torch.Generator().manual_seed(5)
    target = torch.rand((192, 256, 3), generator=g).to(cuda)
    tails = []

    def nan_filled(payload, order, ranks, num_pairs):
        out = torch.full((ranks.shape[0], 16), float("nan"), device=cuda)
        out = gather_pairs_cuda(payload, order, ranks, num_pairs, out=out)
        tails.append(out[int(num_pairs):])
        return out

    def index_select(payload, order, ranks, num_pairs):
        return gather_pairs_torch(payload, order, ranks, num_pairs)

    results = {}
    for label, gather in (("kernel", nan_filled), ("index_select", index_select)):
        monkeypatch.setattr(binning, "gather_pairs_cuda", gather)
        model.zero_grad(set_to_none=True)
        bg = torch.tensor([0.3, 0.1, 0.6], device=cuda, requires_grad=True)
        out = render(model, cam, RasterConfig(impl="cuda"), background=bg)
        loss = ((out.image - target) ** 2).mean() + 0.1 * out.transmittance.mean()
        loss.backward()
        torch.cuda.synchronize()
        results[label] = dict(
            image=out.image.detach(), trans=out.transmittance.detach(),
            background=bg.grad,
            **{k: p.grad.clone() for k, p in model.trainable().items()})
    (tail,) = tails
    assert tail.shape[0] > 0 and bool(tail.isnan().all())
    for key, want in results["index_select"].items():
        got = results["kernel"][key]
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), key


def test_render_grads_cuda_match_torch(cuda):
    """Gradients with the kernels against the plain versions: all six
    groups and the background, within 2e-3 of each one's largest
    magnitude."""
    model, cam = _scene(cuda, 2048, 256, 192, seed=4)
    g = torch.Generator().manual_seed(5)
    target = torch.rand((192, 256, 3), generator=g).to(cuda)
    grads = {}
    for impl in ("cuda", "torch"):
        model.zero_grad(set_to_none=True)
        bg = torch.tensor([0.3, 0.1, 0.6], device=cuda, requires_grad=True)
        out = render(model, cam, RasterConfig(impl=impl), background=bg)
        loss = ((out.image - target) ** 2).mean() + 0.1 * out.transmittance.mean()
        loss.backward()
        grads[impl] = {k: p.grad.clone() for k, p in model.trainable().items()}
        grads[impl]["background"] = bg.grad.clone()
    for k, want in grads["torch"].items():
        got = grads["cuda"][k]
        scale = want.abs().max().clamp(min=1e-12)
        err = float(((got - want).abs() / scale).max())
        assert err <= 2e-3, f"{k}: {err:.3e}"


def test_tile_size_limit(cuda):
    model, cam = _scene(cuda, 256, 128, 128)
    with torch.no_grad(), pytest.raises(ValueError, match="tile_size"):
        render(model, cam, RasterConfig(tile_size=64, impl="cuda"))


@pytest.mark.parametrize(
    "tile_size,chunk_size,strip",
    [(32, 128, False), (32, 8, False), (16, 128, False), (16, 8, False),
     (8, 128, False), (8, 8, True), (12, 128, False), (32, 128, True)],
    ids=["ts32_cs128", "ts32_cs8", "ts16_cs128", "ts16_cs8", "ts8_cs128",
         "ts8_cs8_strip", "ts12_partial_quads", "ts32_strip"])
def test_raster_layouts_match_plain(cuda, tile_size, chunk_size, strip):
    """K1 and K2 on the layouts of csrc/raster_common.cuh (a 2x2 quad per
    thread, 16x8-pixel warps; at tile_size 8 half a warp idles, at 12 the
    quads past the edge are masked), on whole frames and strips: K1 within
    the image budget with equal stop rows, K2 within its row budget and the
    same bits on two launches."""
    cfg = RasterConfig(tile_size=tile_size, chunk_size=chunk_size)
    kw = dict(tile_row0=1, tile_rows=3) if strip else {}
    model, cam = _scene(cuda, 4096, 256, 192, opacity=0.99, fx=880.0)
    with torch.no_grad():
        proj = _project(model, cam, cfg)
        b = bin_gaussians(proj, cam.width, cam.height, cfg, impl="cuda", **kw)
        sp = b.gather_payload(make_payload(proj))
        args = (sp, b.tile_starts, cam.width, cam.height, cfg)
        fwd = rasterize_forward_cuda(*args, **kw)
        want_fwd = rasterize_forward_torch(*args, **kw)
        g = torch.Generator().manual_seed(tile_size + chunk_size)
        cot = torch.randn(fwd.shape, generator=g).to(cuda)
        cot[:, 4:] = 0.0
        bargs = (sp, b.tile_starts, cot, fwd, cam.width, cam.height, cfg)
        got = rasterize_backward_cuda(*bargs, **kw)
        again = rasterize_backward_cuda(*bargs, **kw)
        want = rasterize_backward_torch(*bargs, **kw)
        torch.cuda.synchronize()
    n = int(b.num_pairs)
    assert n > 0
    f, wf = fwd.cpu().numpy(), want_fwd.cpu().numpy()
    for row in (0, 1, 2, 4):
        assert_images_close(f[:, row], wf[:, row], atol=2e-4)
    assert_images_close(np.exp(f[:, 3]), np.exp(wf[:, 3]), atol=2e-4)
    np.testing.assert_array_equal(f[:, 6], wf[:, 6])
    assert torch.equal(got[:n], again[:n]), "K2 is not deterministic"
    for row in range(11):
        _assert_rows_close(got[:n, row], want[:n, row], f"row {row}")
    assert not got[:n, 11:].any()
    assert float(got[:n, :6].abs().max()) > 0


@pytest.mark.parametrize("tile_size,chunk_size", [(32, 128), (16, 8), (8, 128)],
                         ids=["ts32_cs128", "ts16_cs8", "ts8_cs128"])
def test_support_cull_is_exact(cuda, monkeypatch, tile_size, chunk_size):
    """Opacities spread from alpha_min to 1, so that the support extent of
    csrc/raster_common.cuh is cut by the alpha gate (2 ln(opacity /
    alpha_min) < sigma^2) for about a third of the pairs and by sigma for
    the rest: K1 and K2 give the same bits as a build with the cull off
    (GS_NO_SUPPORT_CULL), and stay within their budgets against the plain
    versions."""
    cfg = RasterConfig(tile_size=tile_size, chunk_size=chunk_size)
    model, cam = _scene(cuda, 4096, 256, 192, opacity=0.99, fx=880.0)
    g = torch.Generator().manual_seed(tile_size + chunk_size)
    op = cfg.alpha_min + (1.0 - cfg.alpha_min) * torch.rand(
        model.capacity, generator=g, dtype=torch.float64) * 0.999
    with torch.no_grad():
        model.logit_opacities.copy_(torch.log(op / (1.0 - op)).float())
        proj = _project(model, cam, cfg)
        b = bin_gaussians(proj, cam.width, cam.height, cfg, impl="cuda")
        sp = b.gather_payload(make_payload(proj))
        args = (sp, b.tile_starts, cam.width, cam.height, cfg)
        fwd = rasterize_forward_cuda(*args)
        cot = torch.randn(fwd.shape, generator=g).to(cuda)
        cot[:, 4:] = 0.0
        bargs = (sp, b.tile_starts, cot, fwd, cam.width, cam.height, cfg)
        grad = rasterize_backward_cuda(*bargs)
        want_fwd = rasterize_forward_torch(*args)
        want = rasterize_backward_torch(*bargs)
        for module, name in ((forward, "FORWARD"), (backward, "BACKWARD")):
            k = getattr(module, name)
            monkeypatch.setattr(module, name, type(k)(
                str(k.source), k.symbol, k.argtypes,
                defines=("GS_NO_SUPPORT_CULL",)))
        all_fwd = rasterize_forward_cuda(*args)
        all_grad = rasterize_backward_cuda(*bargs)
        torch.cuda.synchronize()
    n = int(b.num_pairs)
    assert n > 0
    assert torch.equal(fwd.view(torch.int32), all_fwd.view(torch.int32))
    assert torch.equal(grad[:n].view(torch.int32), all_grad[:n].view(torch.int32))
    f, wf = fwd.cpu().numpy(), want_fwd.cpu().numpy()
    for row in (0, 1, 2, 4):
        assert_images_close(f[:, row], wf[:, row], atol=2e-4)
    np.testing.assert_array_equal(f[:, 6], wf[:, 6])
    for row in range(11):
        _assert_rows_close(grad[:n, row], want[:n, row], f"row {row}")


def _densify_inputs(device, seed=0):
    """A 96-of-112-slot model with every third slot killed (64 alive, 48
    free) and statistics whose ranking has ties, on `device`."""
    from gaussiansplat_tpu_torch.models.densify import DensifyState

    g = torch.Generator().manual_seed(seed)
    model = random_model(g, 96, sh_degree=3, capacity=112, device="cpu")
    model.alive[::3] = False
    grads = torch.where(model.alive, 1e-5 * (torch.arange(112) % 7).float(),
                        torch.zeros(112))
    radii = torch.randint(0, 300, (112,), generator=g, dtype=torch.int32)
    state = DensifyState(grads, model.alive.to(torch.int32), radii)
    eps = torch.randn((112, 3), generator=g)
    eps2 = torch.randn((112, 3), generator=g)
    mv = lambda t: t.to(device)
    return (model.to(device),
            DensifyState(*(mv(t) for t in (state.grad2d_sum,
                                           state.grad2d_count,
                                           state.max_radii))),
            mv(eps), mv(eps2))


def test_densify_and_prune_cuda_match_cpu(cuda):
    """Clone, split and prune on CUDA tensors equal the same calls on the
    CPU with the same draws: masks, counts and alive exactly, clones bit
    for bit, split samples within 1e-6."""
    from gaussiansplat_tpu_torch.config import TrainConfig
    from gaussiansplat_tpu_torch.models import densify
    from gaussiansplat_tpu_torch.models.gaussians import PARAM_NAMES

    cfg = TrainConfig(densify_target_fraction=0.9, densify_scale_thresh=0.05,
                      prune_radius_frac=0.05)
    out = []
    for dev in ("cpu", cuda):
        model, state, eps, eps2 = _densify_inputs(dev)
        _, _, info = densify._densify(model, state, cfg, 1.0, eps, eps2)
        _, pinfo = densify.prune_step(model, state, cfg, 1.0, True,
                                      max_screen_px=200.0)
        out.append((model.cpu(), info, pinfo))
    (a, ia, pa), (b, ib, pb) = out
    for k in ("cloned", "split", "dropped"):
        assert ia[k] == ib[k], k
    assert ia["cloned"] > 0 and ia["split"] > 0 and ia["dropped"] > 0
    assert torch.equal(ia["touched"], ib["touched"].cpu())
    assert pa == pb and pa["pruned"] > 0
    assert torch.equal(a.alive, b.alive)
    for k in PARAM_NAMES:
        if k in ("means", "log_scales"):
            torch.testing.assert_close(getattr(b, k), getattr(a, k), rtol=0,
                                       atol=1e-6)
        else:
            assert torch.equal(getattr(b, k), getattr(a, k)), k


def test_render_oracle_full_cuda_matches_cpu(cuda):
    from gaussiansplat_tpu_torch.config import RasterConfig
    from gaussiansplat_tpu_torch.ops.oracle import render_oracle_full

    cfg = RasterConfig()
    model, cam = _scene("cpu", 4096, 160, 120, seed=3)
    bg = torch.tensor([0.1, 0.2, 0.3])
    with torch.no_grad():
        want = render_oracle_full(_project(model, cam, cfg), 160, 120, cfg, bg)
        got = render_oracle_full(_project(model.to(cuda), cam.to(cuda), cfg),
                                 160, 120, cfg, bg.to(cuda))
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_.cpu(), w_, rtol=0, atol=1e-5)
    assert float(want[1].min()) < 0.5


def test_fit_on_the_card_launches_every_kernel(cuda):
    """20 iterations of Trainer.fit on the card with one densify pass: K1-K4
    launch on every step, K4, K1 and R on every eval render, R on every
    step; overflow 0, finite loss, the gaussian count grows."""
    from gaussiansplat_tpu_torch.config import RasterConfig, TrainConfig
    from gaussiansplat_tpu_torch.data import synthetic_scene
    from gaussiansplat_tpu_torch.train import Trainer

    scene, _ = synthetic_scene(torch.Generator().manual_seed(0),
                               n_gaussians=512, n_train=6, n_test=2,
                               width=96, height=80, fx=120.0, device=cuda)
    cfg = TrainConfig(iterations=20, densify_start=10, densify_every=10,
                      densify_end=10, densify_target_fraction=0.1,
                      sh_degree=1, sh_increase_every=5, eval_every=20,
                      log_every=5)
    kernels = (EXPAND, FORWARD, BACKWARD, SEGREDUCE, RECTS)
    before = [k.launches for k in kernels]
    rows = []
    model, met = Trainer(raster_cfg=RasterConfig(), cfg=cfg).fit(
        scene.init_model, scene.train_views,
        log=lambda it, m: rows.append((it, m)), eval_views=scene.test_views)
    torch.cuda.synchronize()
    counts = [k.launches - b for k, b in zip(kernels, before)]
    assert counts[0] >= 22 and counts[1] >= 22, counts
    assert counts[2] >= 20 and counts[3] >= 20, counts
    assert counts[4] == counts[0], counts
    train = [m for _, m in rows if m.get("kind") != "eval"]
    assert all(m["overflow"] == 0 for m in train)
    assert sum(m.get("cloned", 0) + m.get("split", 0) for m in train) > 0
    assert int(model.num_alive) > 512 and np.isfinite(met["loss"])
    assert model.device.type == "cuda"


@pytest.mark.parametrize(
    "n,width,height,tile_size", [(4096, 7680, 4320, 32),
                                 (70_000, 7680, 4320, 32),
                                 (4096, 3840, 2160, 16)],
    ids=["8k_packed_keys", "8k_separate_streams", "4k_16px"])
def test_expand_int64_rects_match_plain(cuda, n, width, height, tile_size):
    """Tile grids whose rect needs more than 31 bits (240 x 135 tiles):
    K4's int64 instantiation integer-equal to its plain version over the
    whole capacity, in both key regimes (the int32 instantiation is held by
    test_expand_int32_path_unchanged)."""
    cfg = RasterConfig(tile_size=tile_size, pairs_per_gaussian=64.0)
    model, cam = _scene(cuda, n, width, height, fx=0.5 * width)
    with torch.no_grad():
        c = compact_rects(_project(model, cam, cfg), width, height, cfg)
        assert c.rect_c.dtype == torch.int64
        assert c.packed_keys == (n < 10_000)
        assert int(c.num_pairs) > 0 and int(c.overflow) == 0
        before = EXPAND.launches
        got = expand_compacted(c, "cuda")
        want = expand_compacted(c, "torch")
        torch.cuda.synchronize()
    assert EXPAND.launches == before + 1
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["owner_over_a_block", "mask_bit31",
                                  "separate_streams"])
def test_expand_int32_path_unchanged(cuda, name):
    """The same rects as int32 and widened to int64: both instantiations
    give the plain version's output, bit for bit."""
    counts, masks, rects, capacity, packed = _expand_case(name)
    off, rect, mask, num_pairs = _compacted(cuda, counts, masks, rects,
                                            capacity)
    n = off.shape[0]
    rank_bits = max(int(n - 1).bit_length(), 1)
    outs = []
    for r in (rect, rect.to(torch.int64)):
        args = (off, r, mask, num_pairs, capacity, 64, 64 * 64, rank_bits,
                (7, 7, 7), packed)
        got = expand_pairs_cuda(*args)
        outs.append(got if isinstance(got, tuple) else (got,))
    want = expand_pairs_torch(off, rect, mask, num_pairs, capacity, 64,
                              64 * 64, rank_bits, (7, 7, 7), packed)
    want = want if isinstance(want, tuple) else (want,)
    torch.cuda.synchronize()
    for out in outs:
        for a, b in zip(out, want):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="rect_c"):
        expand_pairs_cuda(off, rect.to(torch.int16), mask, num_pairs,
                          capacity, 64, 64 * 64, rank_bits, (7, 7, 7), packed)


def test_render_4k_16px_tiles_matches_plain(cuda):
    """A 3840x2160 frame with 16 px tiles (int64 rects) through render() on
    the card against the plain path."""
    cfg = RasterConfig(tile_size=16, pairs_per_gaussian=64.0)
    model, cam = _scene(cuda, 20_000, 3840, 2160, fx=0.5 * 3840)
    with torch.no_grad():
        a = render(model, cam, dataclasses.replace(cfg, impl="cuda"))
        b = render(model, cam, dataclasses.replace(cfg, impl="torch"))
    assert int(a.overflow) == 0 and int(a.num_pairs) == int(b.num_pairs) > 0
    assert_images_close(a.image.cpu().numpy(), b.image.cpu().numpy(),
                        atol=1e-4)


def test_splats2d_render_and_grads_match_plain(cuda):
    """A 2D splat scene through K4, K1 (forward) and K2, K3 (backward)
    against the plain versions: the image within the budget, every
    gradient within 2e-3 of its largest entry."""
    from gaussiansplat_tpu_torch.models import random_splats2d, render_splats2d

    model = random_splats2d(torch.Generator().manual_seed(0), 3000, 320, 240,
                            device=cuda)
    target = torch.rand((240, 320, 3), generator=torch.Generator().manual_seed(1))
    target = target.to(cuda)
    grads, images = {}, {}
    for impl in ("cuda", "torch"):
        model.zero_grad(set_to_none=True)
        counts = [k.launches for k in (EXPAND, FORWARD, BACKWARD, SEGREDUCE)]
        out = render_splats2d(model, 320, 240, RasterConfig(impl=impl))
        ((out.image - target) ** 2).mean().backward()
        torch.cuda.synchronize()
        launched = [k.launches - c for k, c in
                    zip((EXPAND, FORWARD, BACKWARD, SEGREDUCE), counts)]
        assert launched == ([1, 1, 1, 1] if impl == "cuda" else [0, 0, 0, 0])
        assert int(out.overflow) == 0
        images[impl] = out.image.detach().cpu().numpy()
        grads[impl] = {k: p.grad.clone() for k, p in model.trainable().items()}
    assert_images_close(images["cuda"], images["torch"], atol=1e-4)
    for k, want in grads["torch"].items():
        got = grads["cuda"][k]
        scale = want.abs().max().clamp(min=1e-12)
        assert float(((got - want).abs() / scale).max()) <= 2e-3, k


def test_strips_match_render(cuda):
    """render_strip for every strip of a 4-way split, concatenated, against
    render() on the card. The tile early exit is off: a tile's chunks are
    aligned to the pair list, which differs between a strip and the whole
    frame, so with it on a tile may stop a chunk sooner or later (up to
    ~trans_eps a pixel); without it each tile composites the same pairs in
    the same order."""
    from gaussiansplat_tpu_torch.parallel import render_strip
    from gaussiansplat_tpu_torch.parallel.render import strip_pair_capacity

    cfg = RasterConfig(trans_eps=0.0)
    model, cam = _scene(cuda, 8192, 320, 256, seed=2)
    bg = torch.tensor([0.1, 0.2, 0.3], device=cuda)
    counts = [k.launches for k in (EXPAND, FORWARD)]
    with torch.no_grad():
        strips = [render_strip(model, cam, cfg, 3, bg, 2 * i, 2,
                               strip_pair_capacity(cfg, model.capacity, 4))
                  for i in range(4)]
        full = render(model, cam, cfg, background=bg)
    torch.cuda.synchronize()
    assert [k.launches - c for k, c in zip((EXPAND, FORWARD), counts)] == [5, 5]
    assert all(int(s[2]["overflow"]) == 0 for s in strips)
    img = torch.cat([s[0] for s in strips])[:256]
    trans = torch.cat([s[1] for s in strips])[:256]
    torch.testing.assert_close(img, full.image, rtol=0, atol=1e-5)
    torch.testing.assert_close(trans, full.transmittance, rtol=0, atol=1e-5)


@pytest.mark.parametrize("path", ["strip", "ring"])
def test_gauss_sharded_renders_match_render(cuda, path):
    """The gauss-sharded render (strip exchange) and the depth ring on one
    rank (no process group) on CUDA tensors: image and transmittance
    against render() (the exchange within 1e-5, the ring within 2e-4), the
    gradients of a sum of squares within 2e-3 of each group's largest
    entry, and K4, K1, K2 and K3 each launched once. The tile early exit
    is off, as in `test_strips_match_render`."""
    from gaussiansplat_tpu_torch.parallel import (
        make_depth_ring_render, make_gauss_mesh, make_gauss_sharded_render,
        shard_model)

    cfg = RasterConfig(trans_eps=0.0)
    model, cam = _scene(cuda, 8192, 320, 256, seed=4)
    ref, _ = _scene(cuda, 8192, 320, 256, seed=4)
    bg = torch.tensor([0.1, 0.2, 0.3], device=cuda)
    mesh = make_gauss_mesh()
    sm = shard_model(model, mesh)
    if path == "strip":
        f = make_gauss_sharded_render(mesh, cfg, 320, 256, 3, send_cap=8192)
    else:
        f = make_depth_ring_render(mesh, cfg, 320, 256, 3)
    kernels = (EXPAND, FORWARD, BACKWARD, SEGREDUCE)
    counts = [k.launches for k in kernels]
    img, trans = f(sm, cam, bg)
    (img ** 2).sum().backward()
    torch.cuda.synchronize()
    assert [k.launches - c for k, c in zip(kernels, counts)] == [1, 1, 1, 1]
    full = render(ref, cam, cfg, background=bg)
    (full.image ** 2).sum().backward()
    atol = 1e-5 if path == "strip" else 2e-4
    torch.testing.assert_close(img, full.image, rtol=0, atol=atol)
    torch.testing.assert_close(trans, full.transmittance, rtol=0, atol=atol)
    for k, p in sm.trainable().items():
        want = ref.trainable()[k].grad
        scale = want.abs().max().clamp(min=1e-12)
        assert float(((p.grad - want).abs() / scale).max()) <= 2e-3, k


def _variant_inputs(device):
    """Production outputs of K1, K2 and K3 on one synthetic scene, and a
    call of each kernel with `ablate=`."""
    cfg = RasterConfig()
    cam, b, sp, fwd, cot = _backward_inputs(device, cfg)
    with torch.no_grad():
        grad = rasterize_backward_cuda(sp, b.tile_starts, cot, fwd, cam.width,
                                       cam.height, cfg)
        n, p = b.depth_order.shape[0], b.sorted_pos.shape[0]
        g = torch.Generator().manual_seed(3)
        rows = torch.randn((p, 16), generator=g).to(device)
        rows[int(b.num_pairs):] = 0.0
        red = segment_reduce_pairs_cuda(rows, b.seg_offsets, n)
    calls = {
        "forward": lambda v: rasterize_forward_cuda(
            sp, b.tile_starts, cam.width, cam.height, cfg, ablate=v),
        "backward": lambda v: rasterize_backward_cuda(
            sp, b.tile_starts, cot, fwd, cam.width, cam.height, cfg, ablate=v),
        "segreduce": lambda v: segment_reduce_pairs_cuda(
            rows, b.seg_offsets, n, ablate=v),
    }
    full = {"forward": fwd, "backward": grad, "segreduce": red}
    return cfg, b, calls, full


@pytest.mark.parametrize("kernel,variant", [
    (k, v) for k, names in ablate.VARIANTS.items() for v in names])
def test_variant_meets_its_contract(cuda, kernel, variant):
    cfg, b, calls, full = _variant_inputs(cuda)
    base = {"forward": FORWARD, "backward": BACKWARD, "segreduce": SEGREDUCE}[kernel]
    k = ablate.variant_kernel(kernel, base, variant)
    before, prod = k.launches, base.launches
    with torch.no_grad():
        got = calls[kernel](variant)
        torch.cuda.synchronize()
    assert k.launches == before + 1 and base.launches == prod
    r = ablate.contract(kernel, variant, got, full[kernel], b.tile_starts,
                        cfg.chunk_size)
    assert r["ok"], r["text"]


@pytest.mark.parametrize("kernel,variant", [
    ("forward", "noacc"), ("backward", "nograd"), ("forward", ""),
    ("backward", "")], ids=["forward_noacc", "backward_nograd",
                            "forward_production", "backward_production"])
def test_pinned_build_runs_at_the_given_occupancy(cuda, monkeypatch, kernel,
                                                  variant):
    """A build pinned to 2 blocks per SM (its shared memory padded by the
    launcher) reports 2 by the occupancy API; a pinned variant meets its
    contract and pinned production gives production's bits."""
    cfg, b, calls, full = _variant_inputs(cuda)
    module, attr = {"forward": (forward, "FORWARD"),
                    "backward": (backward, "BACKWARD")}[kernel]
    k = ablate.variant_kernel(kernel, getattr(module, attr), variant, blocks=2)
    before = k.launches
    monkeypatch.setattr(module, attr, k)
    with torch.no_grad():
        got = calls[kernel]("")
        torch.cuda.synchronize()
    assert k.launches == before + 1
    assert ablate.pinned_blocks_per_sm(k) == 2
    if not variant:
        n = int(b.num_pairs) if kernel == "backward" else got.shape[0]
        assert torch.equal(got[:n].view(torch.int32),
                           full[kernel][:n].view(torch.int32))
        return
    r = ablate.contract(kernel, variant, got, full[kernel], b.tile_starts,
                        cfg.chunk_size)
    assert r["ok"], r["text"]


RESTART_CFG = dict(iterations=6, densify_start=2, densify_every=2,
                   densify_end=6, densify_target_fraction=0.3,
                   densify_scale_thresh=0.05, random_background=True,
                   sh_degree=1, sh_increase_every=2, checkpoint_every=2,
                   log_every=1)


def _restart_scene(cuda):
    from gaussiansplat_tpu_torch.data import synthetic_scene

    scene, _ = synthetic_scene(torch.Generator().manual_seed(1),
                               n_gaussians=2048, n_train=8, n_test=1,
                               width=128, height=128, fx=160.0, device=cuda)
    return scene


def test_restart_after_card_oom_equals_straight_run(cuda, tmp_path):
    """At step 5 (after the step-4 checkpoint) the timer first takes a
    ballast that leaves 4-6 MiB of the card free, so the step's own
    allocations fail in the caching allocator. run_resilient restarts once
    on that torch.OutOfMemoryError, the retry resumes at 5, densifies at 6
    and ends bit-equal to a straight run."""
    import copy

    from gaussiansplat_tpu_torch.config import TrainConfig
    from gaussiansplat_tpu_torch.train import Trainer
    from gaussiansplat_tpu_torch.utils import StageTimer, run_resilient

    scene = _restart_scene(cuda)
    trainer = Trainer(raster_cfg=RasterConfig(), cfg=TrainConfig(**RESTART_CFG))
    straight = copy.deepcopy(scene.init_model)
    _, met = trainer.fit(straight, scene.train_views)

    class BallastAtStep5(StageTimer):
        ballast, calls = None, 0

        def wrap(self, name, fn):
            timed = super().wrap(name, fn)

            def step(*args, **kwargs):
                self.calls += 1
                if self.calls == 5:
                    torch.cuda.synchronize()
                    torch.cuda.empty_cache()
                    free, _ = torch.cuda.mem_get_info()
                    self.ballast = torch.empty(
                        (free - (4 << 20)) // (2 << 20) * (2 << 20),
                        dtype=torch.uint8, device=cuda)
                return timed(*args, **kwargs)

            return step if name == "step" else timed

    timer, restarts, rows = BallastAtStep5(), [], []

    def on_restart(attempt, exc):
        restarts.append((type(exc), timer.ballast is not None))
        timer.ballast = None

    model = copy.deepcopy(scene.init_model)
    _, rmet = run_resilient(
        trainer.fit, model, scene.train_views,
        log=lambda it, m: rows.append((it, m)), ckpt_dir=str(tmp_path),
        timer=timer, backoff_s=0.0, on_restart=on_restart)
    assert restarts == [(torch.OutOfMemoryError, True)]
    assert [it for it, _ in rows] == [1, 2, 3, 4, 5, 6]
    assert [it for it, m in rows if "cloned" in m] == [2, 4, 6]
    for k, v in straight.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    assert rmet["loss"] == met["loss"]


def test_train_step_twice_bit_equal(cuda):
    """One make_train_step from two deep copies of a state one step into
    training: parameters, Adam moments and step counts, densify statistics
    and the loss bit-equal."""
    import copy

    from gaussiansplat_tpu_torch.config import TrainConfig
    from gaussiansplat_tpu_torch.models import scene_extent
    from gaussiansplat_tpu_torch.train import init_train_state, make_train_step

    scene = _restart_scene(cuda)
    cam, gt = scene.train_views[0]
    cfg = TrainConfig(random_background=True)
    step = make_train_step(RasterConfig(), cfg)
    base = init_train_state(scene.init_model, cfg,
                            float(scene_extent(scene.init_model)))
    base, _ = step(base, cam, gt, 1)
    (a, ma), (b, mb) = [step(copy.deepcopy(base), cam, gt, 1)
                        for _ in range(2)]
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k
    for ga, gb in zip(a.optimizer.param_groups, b.optimizer.param_groups):
        sa = a.optimizer.state[ga["params"][0]]
        sb = b.optimizer.state[gb["params"][0]]
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[key], sb[key]), (ga["name"], key)
    for f in ("grad2d_sum", "grad2d_count", "max_radii"):
        assert torch.equal(getattr(a.densify, f), getattr(b.densify, f)), f
    assert a.step == b.step == 2
    assert torch.equal(ma["loss"], mb["loss"])


def test_spans_time_the_card_without_a_sync(cuda):
    """The program's spans under torch.profiler on the card: a frame's and
    a step's spans have positive device ms, their self times sum to the
    top-level span's device ms, K2's and K3's spans (autograd's device
    thread) belong to the step under `gs.backward`, the host stamps agree
    with the profiler's own events, and a span around a CUDA op makes no
    synchronizing call."""
    from torch.profiler import ProfilerActivity, profile

    from gaussiansplat_tpu_torch.config import TrainConfig
    from gaussiansplat_tpu_torch.train import init_train_state, make_train_step
    from gaussiansplat_tpu_torch.utils import logging as spans

    model, cam = _scene(cuda, 4096, 256, 192)
    gt = torch.rand((192, 256, 3), device=cuda)
    cfg = RasterConfig()
    state = init_train_state(model, TrainConfig(), 1.0)
    step = make_train_step(cfg, TrainConfig())
    state, _ = step(state, cam, gt, 3)        # builds and warms every kernel
    torch.cuda.synchronize()
    spans.RECORDER.reset()
    x = torch.ones(1024, device=cuda)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.inference_mode():
            render(model, cam, cfg)
        state, _ = step(state, cam, gt, 3)
        torch.cuda.set_sync_debug_mode("error")
        try:
            with spans.span("gs.probe", cuda):
                x = x * 2
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    (frame,) = spans.calls("gs.render")
    (train,) = spans.calls("gs.step")
    for call in (frame, train):
        top = call.spans[0]
        assert all(s.device_ms > 0 for s in call.spans), call.spans[0].name
        total = sum(s.self_ms for s in call.spans)
        assert abs(total - top.device_ms) <= 1e-4 * top.device_ms
    s = {x.name: x for x in train.spans}
    for name in ("gs.raster.bwd", "gs.gather.bwd"):
        assert s[name].parent is s["gs.backward"] and s[name].call is train
    host = {}
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() == torch.autograd.DeviceType.CPU
                and e.name().startswith("gs.")):
            host.setdefault(e.name(), []).append(e)
    mine = [x for c in (frame, train) for x in c.spans]
    for name, evs in host.items():
        ours = [x for x in mine if x.name == name]
        if name == "gs.probe":
            continue
        assert len(ours) == len(evs), name
        for x, e in zip(sorted(ours, key=lambda x: x.t0_ns),
                        sorted(evs, key=lambda e: e.start_ns())):
            assert abs(x.t0_ns - e.start_ns()) < 1_000_000, name
            assert abs(x.t1_ns - e.end_ns()) < 1_000_000, name


# The benchmark's scene (chip_smoke.bench_scene, seed 1) and its camera
# (eye at z = -4, fx scaled with the width): (gaussians, width, height,
# tile edge, first tile row, tile rows).
RECT_CASES = {
    "1080p": (3_000_000, 1920, 1080, 32, 0, None),
    "4k": (3_000_000, 3840, 2160, 32, 0, None),
    "strip_9_of_34": (3_000_000, 1920, 1080, 32, 9, 9),
    "payload_columns": (1_000_000, 1920, 1080, 32, 0, None),
    "8k_int64": (1_000_000, 7680, 4320, 32, 0, None),
    "1080p_24px": (1_000_000, 1920, 1080, 24, 0, None),
}


def _rect_case(device, name):
    """(Projected, cfg, width, height, tile_row0, tile_rows) of a case; the
    payload case reads every field as a strided column of the payload."""
    import chip_smoke as cs

    n, width, height, tile, row0, rows = RECT_CASES[name]
    fx = cs.FX * width / cs.WIDTH
    cfg = RasterConfig(tile_size=tile)
    model = cs.bench_scene(n, device, seed=1, draw_on_device=True)
    cam = look_at(eye=(0.0, 0.0, -4.0), target=(0.0, 0.0, 0.0), fx=fx, fy=fx,
                  width=width, height=height, device=device)
    proj = _project(model, cam, cfg)
    if name == "payload_columns":
        proj = payload_to_projected(make_payload(proj))
        assert not proj.mean2d.is_contiguous()
    return proj, cfg, width, height, row0, rows


@pytest.mark.parametrize("name", list(RECT_CASES))
def test_rects_match_plain(cuda, name):
    """R's rects, survivor masks, counts and depth keys are its plain
    version's bit for bit on the same CUDA tensors, in one launch."""
    proj, cfg, width, height, row0, rows = _rect_case(cuda, name)
    tiles_x, tiles_y = tile_grid(width, height, cfg.tile_size)
    rows = tiles_y if rows is None else rows
    by = max(int(rows).bit_length(), 1)
    bw = max(int(tiles_x).bit_length(), 1)
    rdt = torch.int32 if 2 * (by + bw) <= 31 else torch.int64
    assert (rdt == torch.int64) == (name == "8k_int64")
    args = (proj.mean2d.detach(), proj.conic.detach(), proj.opacity.detach(),
            proj.depth.detach(), proj.radius_xy, proj.valid, cfg, tiles_x,
            tiles_y, row0, rows, (by, bw, by), rdt)
    with torch.no_grad():
        before = RECTS.launches
        got = tile_rects_cuda(*args)
        want = tile_rects_torch(*args)
        torch.cuda.synchronize()
    assert RECTS.launches == before + 1
    for what, a, b in zip(("rect", "mask", "count", "key"), got, want):
        assert a.dtype == b.dtype, what
        if what == "key":
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), what
    count, mask = want[2], want[1]
    assert int((count > 0).sum()) > 1000
    assert bool((mask != 0).any()) == (rdt == torch.int32)


@pytest.mark.parametrize("name", ["1080p", "4k", "strip_9_of_34", "8k_int64"])
def test_binning_with_rects_matches_plain(cuda, name):
    """The whole TileBinning of bin_gaussians with impl='cuda' (R, K4) is
    the plain binning's (impl='torch') bit for bit, every field over its
    whole length."""
    proj, cfg, width, height, row0, rows = _rect_case(cuda, name)
    kw = dict(tile_row0=row0, tile_rows=rows)
    with torch.no_grad():
        before = RECTS.launches
        got = bin_gaussians(proj, width, height, cfg, impl="cuda", **kw)
        assert RECTS.launches == before + 1
        want = bin_gaussians(proj, width, height, cfg, impl="torch", **kw)
        torch.cuda.synchronize()
    assert RECTS.launches == before + 1
    assert int(want.num_pairs) > 0
    for f in ("sorted_ranks", "depth_order", "sorted_tiles", "tile_starts",
              "num_pairs", "overflow", "sorted_pos", "seg_offsets"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f

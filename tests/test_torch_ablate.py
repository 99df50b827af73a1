"""The port's timing variants (`ablate=`, ops/kernels/ablate.py) on the CPU.

One scene at the size of tests/test_ablate.py (64x64, 512 gaussians, SH 1,
tile_size 16, chunk_size 128), made once with numpy from a seed: the
reference projects and bins it (its XLA path), and the same sorted payload,
tile segments, forward block and seeded cotangent go to the reference's
Pallas kernels in interpret mode (unpacked) and to the port's plain
versions, each with `ablate=`:

* K2 `nogeom`, `nodirect`, `nograd`, `dmaonly`: the rows a variant keeps
  within tests/test_torch_backward.py's row budget of the reference's
  variant and bit-equal to the port's own production rows; the rows it
  drops at most 1e-20 in both packages.
* K1 `noacc`, `dmaonly`: the stop row equal, logT as the transmittance
  exp(logT) within the image budget, the dropped rows at most 1e-20.
* K3 `dmaonly` at most 1e-20 in both packages, `stacked` bit-equal to
  production.
* The TPU-only names and unknown names raise on all six functions;
  `decompose` reproduces the reference's record
  (benchmarks/bwd_ablate_3m_r5.json); each variant is its own build and
  counter.

The kernels themselves are held to these contracts on the card
(tests/test_torch_gpu.py, chip_smoke.py phase 14).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imgcheck import assert_images_close
from test_torch_backward import _assert_rows_close

from gaussiansplat_tpu.config import RasterConfig as JRasterConfig
from gaussiansplat_tpu.models.gaussians import from_arrays as j_from_arrays
from gaussiansplat_tpu.ops import look_at as j_look_at
from gaussiansplat_tpu.ops.binning import bin_gaussians as j_bin
from gaussiansplat_tpu.ops.pallas.backward import rasterize_backward as j_bwd
from gaussiansplat_tpu.ops.pallas.forward import rasterize_forward as j_fwd
from gaussiansplat_tpu.ops.pallas.segreduce import segment_reduce_pairs as j_segreduce
from gaussiansplat_tpu.ops.projection import make_payload as j_payload
from gaussiansplat_tpu.ops.projection import project_gaussians as j_project
from gaussiansplat_tpu_torch.config import RasterConfig
from gaussiansplat_tpu_torch.ops.kernels import ablate
from gaussiansplat_tpu_torch.ops.kernels.backward import (
    BACKWARD,
    rasterize_backward_cuda,
)
from gaussiansplat_tpu_torch.ops.kernels.forward import FORWARD, rasterize_forward_cuda
from gaussiansplat_tpu_torch.ops.kernels.segreduce import (
    SEGREDUCE,
    segment_reduce_pairs_cuda,
    segment_reduce_pairs_torch,
)
from gaussiansplat_tpu_torch.ops.tile_raster import (
    rasterize_backward_torch,
    rasterize_forward_torch,
)

ROOT = Path(__file__).resolve().parents[1]
SIZE, N, CFG = 64, 512, dict(tile_size=16, chunk_size=128)
TINY = 1e-20
# Rows each backward variant keeps (the others it drops).
BWD_KEPT = {"nogeom": range(6, 11), "nodirect": range(0, 6), "nograd": (),
            "dmaonly": ()}
FWD_VARIANTS = ("noacc", "dmaonly")
# K3's inputs: seeded rows in pre-sort order over N_SEG segments.
N_SEG, P_SEG = 300, 1000


def _numpy_scene(seed=0):
    """The model's arrays, from numpy: the reference's random_model
    distribution (means in [-1, 1]^3, scales in [0.02, 0.08], opacity 0.8,
    colours in [0.05, 0.95]) at SH degree 1."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(N, 4))
    colors = rng.uniform(0.05, 0.95, (N, 3))
    return dict(
        means=rng.uniform(-1.0, 1.0, (N, 3)).astype(np.float32),
        quats=(q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32),
        log_scales=rng.uniform(np.log(0.02), np.log(0.08), (N, 3)).astype(np.float32),
        logit_opacities=np.full(N, np.log(0.8 / 0.2), np.float32),
        sh_dc=((colors - 0.5) / 0.28209479177387814).astype(np.float32),
        sh_rest=np.zeros((N, 3, 3), np.float32),
    )


@pytest.fixture(scope="module")
def ref():
    """Every reference output the tests read, computed once."""
    jcfg = JRasterConfig(packed=False, **CFG)
    m = j_from_arrays(**_numpy_scene())
    cam = j_look_at(eye=(0, 0, -4.0), target=(0, 0, 0), fx=100.0, fy=100.0,
                    width=SIZE, height=SIZE)

    @jax.jit
    def sorted_inputs(m):
        p = j_project(m.means, m.quats, m.log_scales, m.logit_opacities, m.sh,
                      cam, jcfg, sh_degree=1, alive=m.alive)
        b = j_bin(p, SIZE, SIZE, jcfg, impl="xla")
        return b.gather_payload(j_payload(p), impl="xla"), b.tile_starts

    sp, ts = (np.asarray(a) for a in sorted_inputs(m))
    num_pairs = int(ts[-1])
    payload_t = jnp.concatenate(
        [jnp.asarray(sp).T, jnp.zeros((16, CFG["chunk_size"]), jnp.float32)], 1)
    fwd = {v: np.asarray(j_fwd(payload_t, jnp.asarray(ts), SIZE, SIZE, jcfg,
                               interpret=True, packed=False, ablate=v))
           for v in ("",) + FWD_VARIANTS}
    cot = np.random.default_rng(7).normal(size=fwd[""].shape).astype(np.float32)
    cot[:, 6:] = 0.0                          # rows 0-5 carry a cotangent
    stops = fwd[""][:, 6, 0].astype(np.int32)
    bwd = {}
    for v in BWD_KEPT:
        out = np.asarray(j_bwd(payload_t, jnp.asarray(ts), jnp.asarray(stops),
                               jnp.asarray(cot), jnp.asarray(fwd[""]), SIZE,
                               SIZE, jcfg, interpret=True, packed=False,
                               ablate=v))
        rows = out[:, :sp.shape[0]].T.copy()
        rows[num_pairs:] = 0.0                # never written by any tile
        bwd[v] = rows

    rng = np.random.default_rng(11)
    bounds = np.sort(rng.integers(0, P_SEG, N_SEG - 1))
    seg = np.concatenate([[0], bounds, [P_SEG]]).astype(np.int32)
    seg_rows = rng.normal(size=(P_SEG, 16)).astype(np.float32)
    seg_dmaonly = np.asarray(j_segreduce(
        jnp.asarray(seg_rows.T), jnp.asarray(seg), N_SEG, interpret=True,
        packed=False, ablate="dmaonly"))
    return dict(sp=sp, ts=ts, num_pairs=num_pairs, fwd=fwd, cot=cot, bwd=bwd,
                seg=seg, seg_rows=seg_rows, seg_dmaonly=seg_dmaonly)


def _port_backward(ref, v):
    t = torch.tensor
    return rasterize_backward_torch(
        t(ref["sp"]), t(ref["ts"]), t(ref["cot"]), t(ref["fwd"][""]), SIZE,
        SIZE, RasterConfig(**CFG), ablate=v).numpy()


def _port_forward(ref, v):
    return rasterize_forward_torch(torch.tensor(ref["sp"]), torch.tensor(ref["ts"]),
                                   SIZE, SIZE, RasterConfig(**CFG), ablate=v).numpy()


@pytest.mark.parametrize("variant", list(BWD_KEPT))
def test_backward_variant_matches_reference(ref, variant):
    n = ref["num_pairs"]
    assert n > 0
    got, want = _port_backward(ref, variant)[:n], ref["bwd"][variant][:n]
    kept = list(BWD_KEPT[variant])
    for row in kept:
        _assert_rows_close(got[:, row], want[:, row], f"{variant} row {row}")
        assert np.abs(want[:, row]).max() > 0
    dropped = [r for r in range(16) if r not in kept]
    assert np.abs(got[:, dropped]).max() <= TINY
    assert np.abs(want[:, dropped]).max() <= TINY


@pytest.mark.parametrize("variant", list(BWD_KEPT))
def test_backward_variant_keeps_production_bits(ref, variant):
    got, full = _port_backward(ref, variant), _port_backward(ref, "")
    kept = list(BWD_KEPT[variant])
    np.testing.assert_array_equal(got[:, kept].view(np.int32),
                                  full[:, kept].view(np.int32))
    assert np.abs(full[:ref["num_pairs"], :11]).max() > 0


@pytest.mark.parametrize("variant", FWD_VARIANTS)
def test_forward_variant_matches_reference(ref, variant):
    got, want = _port_forward(ref, variant), ref["fwd"][variant]
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, 6], want[:, 6])
    assert_images_close(np.exp(got[:, 3]), np.exp(want[:, 3]))
    dropped = [0, 1, 2, 4, 5, 7]
    assert np.abs(got[:, dropped]).max() <= TINY
    assert np.abs(want[:, dropped]).max() <= TINY
    full = _port_forward(ref, "")
    if variant == "noacc":
        # The gates and the logT sum are production's, bit for bit.
        np.testing.assert_array_equal(got[:, [3, 6]], full[:, [3, 6]])
        assert (full[:, 6] != 0).any() and (full[:, 3] < 0).any()
    else:
        # No compositing: logT stays 0, so no tile stops early and every
        # chunk of its segment is streamed.
        assert not got[:, 3].any()
        assert (got[:, 6] >= full[:, 6]).all()


def test_segreduce_dmaonly_matches_reference(ref):
    rows, seg = torch.tensor(ref["seg_rows"]), torch.tensor(ref["seg"])
    got = segment_reduce_pairs_torch(rows, seg, N_SEG, ablate="dmaonly")
    assert got.shape == ref["seg_dmaonly"].shape == (N_SEG, 16)
    assert float(got.abs().max()) <= TINY
    assert np.abs(ref["seg_dmaonly"]).max() <= TINY
    assert float(segment_reduce_pairs_torch(rows, seg, N_SEG).abs().max()) > 1.0


def test_segreduce_stacked_is_production(ref):
    rows, seg = torch.tensor(ref["seg_rows"]), torch.tensor(ref["seg"])
    got = segment_reduce_pairs_torch(rows, seg, N_SEG, ablate="stacked")
    want = segment_reduce_pairs_torch(rows, seg, N_SEG)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _calls():
    """Each of the six functions, called with `ablate` on small CPU inputs."""
    sp = torch.zeros((8, 16))
    ts = torch.tensor([0, 8, 8, 8, 8], dtype=torch.int32)
    blk = torch.zeros((4, 8, 256))
    cfg = RasterConfig(**CFG)
    seg = torch.tensor([0, 4, 8], dtype=torch.int32)
    return {
        "rasterize_forward_cuda": lambda v: rasterize_forward_cuda(
            sp, ts, 32, 32, cfg, ablate=v),
        "rasterize_forward_torch": lambda v: rasterize_forward_torch(
            sp, ts, 32, 32, cfg, ablate=v),
        "rasterize_backward_cuda": lambda v: rasterize_backward_cuda(
            sp, ts, blk, blk, 32, 32, cfg, ablate=v),
        "rasterize_backward_torch": lambda v: rasterize_backward_torch(
            sp, ts, blk, blk, 32, 32, cfg, ablate=v),
        "segment_reduce_pairs_cuda": lambda v: segment_reduce_pairs_cuda(
            sp, seg, 2, ablate=v),
        "segment_reduce_pairs_torch": lambda v: segment_reduce_pairs_torch(
            sp, seg, 2, ablate=v),
    }


@pytest.mark.parametrize("fn", list(_calls()))
def test_tpu_only_and_unknown_names_raise(fn):
    call = _calls()[fn]
    for name in ("nopack", "nounpack", "split1", "constoh"):
        with pytest.raises(ValueError, match="TPU"):
            call(name)
    # Unknown names, and another kernel's variant, list the accepted ones.
    other = "noacc" if "backward" in fn else "nograd"
    for name in ("bogus", other):
        with pytest.raises(ValueError, match="unknown ablate.*accepted"):
            call(name)


def test_variants_check_before_falling_back():
    """A CUDA wrapper given a known variant on CPU tensors raises as
    production does (it never falls back to the plain version); a checksum
    variant has no plain version."""
    calls = _calls()
    for fn, v in (("rasterize_forward_cuda", "noacc"),
                  ("rasterize_backward_cuda", "nograd"),
                  ("segment_reduce_pairs_cuda", "dmaonly")):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            calls[fn](v)
    for fn in ("rasterize_forward_torch", "rasterize_backward_torch"):
        with pytest.raises(ValueError, match="no plain version"):
            calls[fn]("nowrite")
    assert calls["rasterize_forward_torch"]("dmaonly").shape == (4, 8, 256)


def test_decompose_reproduces_the_reference_record():
    rec = json.loads((ROOT / "benchmarks" / "bwd_ablate_3m_r5.json").read_text())
    times = {k: v for k, v in rec["variants"].items() if k != "nopack_ms"}
    got = ablate.decompose(times, "backward", digits=2)
    keys = ("geom_chain_ms", "direct_ms", "write_path_ms", "all_grad_math_ms",
            "recompute_ms", "stream_floor_ms")
    assert got == {k: rec["derived"][k] for k in keys}
    assert got["geom_chain_ms"] == 7.96 and got["recompute_ms"] == 15.92
    assert "pack_ms" not in got


def test_decompose_forward_and_segreduce():
    fwd = ablate.decompose({"full_ms": 0.625, "noacc_ms": 0.5, "nowrite_ms": 0.5,
                            "dmaonly_ms": 0.125}, "forward")
    assert fwd == {"compositing_ms": 0.125, "output_store_ms": 0.125,
                   "gates_ms": 0.375, "stream_floor_ms": 0.125}
    seg = ablate.decompose({"full_ms": 0.078125, "dmaonly_ms": 0.0625},
                           "segreduce", digits=4)
    assert seg == {"adds_ms": 0.0156, "stream_floor_ms": 0.0625}
    assert ablate.decompose({"dmaonly_ms": 1.0}, "backward") == {}
    with pytest.raises(ValueError, match="unknown kernel"):
        ablate.decompose({}, "expand")


def test_each_variant_is_its_own_build_and_counter():
    """A -DGS_ABLATE_<NAME> build of the production source with its own
    launch counter, cached; `stacked` is the production library under
    another counter. Nothing is built here (the paths are hashes)."""
    paths = set()
    for kernel, base in (("forward", FORWARD), ("backward", BACKWARD),
                         ("segreduce", SEGREDUCE)):
        variants = ablate.variant_kernels(kernel, base)
        assert tuple(variants) == ablate.VARIANTS[kernel]
        for v, k in variants.items():
            assert k is ablate.variant_kernel(kernel, base, v)
            assert k is not base and k.launches == 0
            assert k.source == base.source and k.symbol == base.symbol
            if (kernel, v) in ablate.ALIASES:
                assert k.library_path() == base.library_path()
            else:
                assert f"-DGS_ABLATE_{v.upper()}" in k.flags
                paths.add(k.library_path())
        paths.add(base.library_path())
    assert len(paths) == 3 + 3 + 5 + 1
    # Pinned to a count of blocks per SM: another build of the variant.
    pinned = ablate.variant_kernel("forward", FORWARD, "noacc", blocks=3)
    assert pinned is ablate.variant_kernel("forward", FORWARD, "noacc", blocks=3)
    assert pinned.flags[-2:] == ("-DGS_ABLATE_NOACC", "-DGS_ABLATE_BLOCKS=3")
    assert pinned.library_path() not in paths
    # Production pinned the same way: no variant define.
    prod = ablate.variant_kernel("forward", FORWARD, "", blocks=3)
    assert prod.flags[-1] == "-DGS_ABLATE_BLOCKS=3"
    assert not any(f.startswith("-DGS_ABLATE_") and "BLOCKS" not in f
                   for f in prod.flags)
    assert prod.library_path() not in paths | {pinned.library_path()}
    with pytest.raises(ValueError, match="pinned"):
        ablate.variant_kernel("segreduce", SEGREDUCE, "dmaonly", blocks=8)


def _nowrite_out(kernel, full, ts):
    """What a `nowrite` launch leaves: garbage but the tile checksums."""
    out = torch.full_like(full, float("nan"))
    if kernel == "forward":
        out[:, 0, 0] = ablate.forward_checksums(full).float()
    else:
        starts = ts.to(torch.int64)
        keep = starts[1:] > starts[:-1]
        out[starts[:-1][keep], 0] = ablate.backward_checksums(full, ts)[keep].float()
    return out


def test_contract_checks_the_plain_variants(ref):
    """`ablate.contract`, which holds the kernels' variants against
    production on the card, accepts the plain variants against the plain
    production outputs, and refuses production's own output (its dropped
    rows are not under 1e-20), a moved logT and a wrong checksum."""
    ts = torch.tensor(ref["ts"])
    cs = CFG["chunk_size"]
    outs = {
        "forward": {v: torch.tensor(_port_forward(ref, v)) for v in ("",) + FWD_VARIANTS},
        "backward": {v: torch.tensor(_port_backward(ref, v))
                     for v in ("",) + tuple(BWD_KEPT)},
    }
    rows, seg = torch.tensor(ref["seg_rows"]), torch.tensor(ref["seg"])
    outs["segreduce"] = {v: segment_reduce_pairs_torch(rows, seg, N_SEG, ablate=v)
                         for v in ("",) + ablate.SEGREDUCE_VARIANTS}
    for kernel, by_v in outs.items():
        full = by_v[""]
        for v, out in by_v.items():
            if not v:
                continue
            r = ablate.contract(kernel, v, out, full, ts, cs)
            assert r["ok"], (kernel, v, r["text"])
            if v != "stacked":
                assert not ablate.contract(kernel, v, full, full, ts, cs)["ok"]
        if kernel != "segreduce":
            out = _nowrite_out(kernel, full, ts)
            assert ablate.contract(kernel, "nowrite", out, full, ts, cs)["ok"]
            bad = out.clone()
            if kernel == "forward":
                bad[3, 0, 0] += 1.0
            else:
                bad[int(ts[3]), 0] += 1.0
            r = ablate.contract(kernel, "nowrite", bad, full, ts, cs)
            assert not r["ok"] and r["checksum_rel"] > ablate.CHECKSUM_RTOL
    moved = outs["forward"]["noacc"].clone()
    moved[0, 3, 0] = torch.nextafter(moved[0, 3, 0], torch.tensor(-1.0))
    assert not ablate.contract("forward", "noacc", moved, outs["forward"][""], ts,
                               cs)["ok"]
    assert not ablate.contract("segreduce", "stacked", outs["segreduce"][""] * 2,
                               outs["segreduce"][""])["ok"]

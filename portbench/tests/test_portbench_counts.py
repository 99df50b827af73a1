"""The reference's work counts and its tile early exit against a brute
force over every (pixel, gaussian) at a tiny size, and the bound's
arithmetic by hand."""

import math
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench import inputs  # noqa: E402
from portbench.reference import counts, peaks  # noqa: E402
from portbench.reference import render as R  # noqa: E402
from portbench.reference import scenes  # noqa: E402

W, H, TS = 40, 32, 16
RASTER = dict(tile_size=TS, alpha_min=1 / 255, alpha_max=0.999,
              trans_eps=1e-4, sigma_radius=3.0, cov2d_dilation=0.3,
              near=0.2, far=1e6)


def _brute(proj, rc):
    """Per tile, composite every valid gaussian front to back over the
    tile's pixels until all are at T <= trans_eps; count as counts.py says."""
    f = proj["fields"].detach().double().numpy()
    valid = proj["valid"].numpy()
    depth = np.where(valid, proj["depth"].numpy(), np.inf)
    order = np.argsort(depth, kind="stable")
    op = f[:, 5]
    r2 = np.clip(np.minimum(rc.sigma_radius ** 2,
                            2 * np.log(np.maximum(op, 1e-30) / rc.alpha_min)),
                 0, None)
    hx = np.sqrt(r2 * proj["cov_xx"].double().numpy())
    hy = np.sqrt(r2 * proj["cov_yy"].double().numpy())
    pairs = inside = live = stopped = 0
    for ty in range(-(-H // TS)):
        for tx in range(-(-W // TS)):
            ys, xs = np.mgrid[ty * TS:(ty + 1) * TS, tx * TS:(tx + 1) * TS]
            xs, ys = xs.ravel().astype(float), ys.ravel().astype(float)
            in_img = (xs < W) & (ys < H)
            log_t = np.zeros(xs.shape)
            for g in order:
                if not valid[g] or r2[g] <= 0:
                    continue
                dx, dy = xs - f[g, 0], ys - f[g, 1]
                q = f[g, 2] * dx * dx + 2 * f[g, 3] * dx * dy + f[g, 4] * dy * dy
                a = op[g] * np.exp(-0.5 * q)
                ok = (a >= rc.alpha_min) & (q <= rc.sigma_radius ** 2)
                box = (np.abs(dx) <= hx[g]) & (np.abs(dy) <= hy[g]) & in_img
                inside += int(box.sum())
                pairs += int(box.any())
                live += int((ok & in_img).sum())
                log_t += np.log1p(-np.where(ok, np.minimum(a, rc.alpha_max), 0))
                if log_t.max() <= math.log(rc.trans_eps):
                    stopped += 1
                    break
    return pairs, inside, live, stopped


def test_counts_and_early_exit_match_a_brute_force():
    params, alive = scenes.bench_scene(11, 500, 1, 0.8, (0.02, 0.06), W, H,
                                       40.0, 0.05, "cpu")
    rot, t = scenes.look_at(scenes.orbit_eye(0.3, 0.1, 4.0), (0, 0, 0),
                            (0, 1, 0))
    pose = inputs.Pose(R=rot, t=t, fx=40.0, fy=40.0, cx=(W - 1) / 2,
                       cy=(H - 1) / 2, width=W, height=H)
    rc = R.Raster.from_dict(RASTER)
    cam = inputs.ref_camera(pose, "cpu")
    proj = R.project(params, alive, cam, rc, 1)
    _, _, c = R.render(proj, cam, rc, count=True)
    pairs, inside, live, stopped = _brute(proj, rc)
    assert stopped >= 1, "no tile reached the early exit"
    assert (c.pairs, c.inside) == (pairs, inside)
    # A gate evaluated in float32 and float64 may differ on its edge.
    assert abs(c.live - live) <= 1e-3 * live


def test_bound_arithmetic():
    c = R.RasterCounts(pairs=1_000_000, inside=100_000_000, live=40_000_000)
    pixels = 1920 * 1080
    issue = 1e6 * 30 + 1e8 * 14 + 4e7 * 35
    sfu = 1e6 * 6 + 1e8 * 1 + 4e7 * 2
    nbytes = 1e6 * 36 + pixels * 16
    want = max(nbytes / peaks.PEAK_BYTES_PER_S, issue / peaks.RATES["issue"],
               sfu / peaks.RATES["sfu"])
    assert counts.kernel_bound("k1", c, pixels) == pytest.approx(want)
    assert counts.kernel_bound("k2", c, pixels) > counts.kernel_bound("k1", c, pixels)
    serve = counts.serve_flops(3_000_000, 3, pixels, c)
    assert serve == pytest.approx(3e6 * (197 + counts.sh_flops(3)) + 1e6 * 12
                                  + 1e8 * 15 + 4e7 * 12 + pixels * 6)
    assert counts.train_flops(3_000_000, 3, pixels, c) > 2 * serve
    with pytest.raises(ValueError):
        counts.kernel_bound("k3", c, pixels)

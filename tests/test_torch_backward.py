"""Port parity of the backward pass on the CPU.

* The plain version of K2 (`rasterize_backward_torch`) against the
  reference's Pallas backward kernel in interpret mode (unpacked): both get
  the same sorted payload, tile segments and forward block (from the
  reference's interpret-mode forward, stop row included) and the same
  seeded random cotangent (rows 4 and 5 zero, as the rasterizer makes
  them). A linear cotangent tests the kernel and not the loss's curvature.
  Rows 0-10 of the valid pairs, scaled by each row's largest magnitude:
  all but 1% of the entries within 1e-4, and every entry within 5e-3. The
  reference evaluates q through a centred polynomial basis and the port
  through the factored form, so an alpha gate on a knife edge may flip at
  one pixel; a flip moves that pair's row by one pixel's contribution
  (measured up to 2.9e-3 of the row's largest entry, 1-4 entries of ~1000
  per row above 1e-4), and the rewound transmittance of the pixel's earlier
  pairs by a factor 1 - alpha_min. Rows 11-15 and every row past num_pairs
  are zero.
* `render` gradients: the port's render (plain K1, K2 and K3 through their
  autograd Functions) against `jax.grad` of the reference's render with its
  Pallas kernels in interpret mode, on tests/test_pallas.py's loss (MSE to a
  target plus 0.1 mean transmittance): all six parameter groups,
  `mean2d_offset` and `background`, scale-normalised atol 2e-3; the
  saturated early-exit scene at 5e-3, as there.
* The projection VJP against `jax.vjp` of `project_gaussians` with a seeded
  cotangent on every float output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import limit_torch_threads, np_, port_camera, port_model
from test_torch_raster import CASES, _sorted_inputs

from gaussiansplat_tpu.config import RasterConfig as JRasterConfig
from gaussiansplat_tpu.models import random_model as j_random_model
from gaussiansplat_tpu.ops import look_at as j_look_at
from gaussiansplat_tpu.ops.pallas.backward import rasterize_backward as j_bwd
from gaussiansplat_tpu.ops.pallas.forward import rasterize_forward as j_fwd
from gaussiansplat_tpu.ops.projection import project_gaussians as j_project
from gaussiansplat_tpu.render import render as j_render
from gaussiansplat_tpu_torch.config import RasterConfig
from gaussiansplat_tpu_torch.ops.projection import project_gaussians
from gaussiansplat_tpu_torch.ops.tile_raster import rasterize_backward_torch
from gaussiansplat_tpu_torch.render import render

limit_torch_threads()

PROJ_FLOAT = ("mean2d", "depth", "conic", "rgb", "opacity")
PROJ_INPUTS = ("means", "quats", "log_scales", "logit_opacities", "sh")


def _assert_rows_close(got, want, what, bulk_atol=1e-4, bulk_frac=0.01,
                       atol=5e-3):
    """Scale-normalised: all but `bulk_frac` of the entries within
    `bulk_atol`, every entry within `atol` (the alpha-gate flip budget)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max() + 1e-8
    d = np.abs(got - want) / scale
    assert d.max() <= atol, f"{what}: max scaled |diff| {d.max():.3e}"
    frac = float((d > bulk_atol).mean())
    assert frac <= bulk_frac, f"{what}: {frac:.2%} of entries above {bulk_atol}"


def _assert_scaled_close(got, want, atol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all(), what
    scale = np.abs(want).max() + 1e-8
    np.testing.assert_allclose(got / scale, want / scale, atol=atol,
                               rtol=0, err_msg=what)


@pytest.mark.parametrize("case", CASES, ids=["cs128", "cs8_early_exit",
                                             "cs8_no_exit"])
def test_plain_backward_matches_pallas_interpret(case):
    width = height = 128
    sp, ts, _, jcfg = _sorted_inputs(case["n"], width, height, case["cfg"],
                                     opacity=case["opacity"],
                                     fx=case.get("fx", 220.0),
                                     scale_range=case.get("scale_range",
                                                          (0.02, 0.08)))
    cs = jcfg.chunk_size
    payload_t = jnp.concatenate(
        [jnp.asarray(sp).T, jnp.zeros((16, cs), jnp.float32)], 1)
    fwd = np.asarray(jax.jit(lambda p, s: j_fwd(
        p, s, width, height, jcfg, interpret=True, packed=False))(
            payload_t, jnp.asarray(ts)))
    cot = np.random.default_rng(7).normal(size=fwd.shape).astype(np.float32)
    cot[:, 4:] = 0.0
    stops = fwd[:, 6, 0].astype(np.int32)
    want_t = jax.jit(lambda p, s, st, c, f: j_bwd(
        p, s, st, c, f, width, height, jcfg, interpret=True, packed=False))(
            payload_t, jnp.asarray(ts), jnp.asarray(stops), jnp.asarray(cot),
            jnp.asarray(fwd))
    want = np.asarray(want_t)[:, :sp.shape[0]].T
    got = np_(rasterize_backward_torch(
        torch.tensor(sp), torch.tensor(ts), torch.tensor(cot),
        torch.tensor(fwd), width, height, RasterConfig(**case["cfg"])))
    num_pairs = int(ts[-1])
    assert num_pairs > 0 and got.shape == sp.shape
    for row in range(11):
        _assert_rows_close(got[:num_pairs, row], want[:num_pairs, row],
                           f"row {row}")
    assert np.abs(got[:num_pairs, :6]).max() > 0
    assert not got[:, 11:].any()
    assert not got[num_pairs:].any()


def _grad_scene(n, opacity, seed=0, size=64):
    jm = j_random_model(jax.random.PRNGKey(seed), n, sh_degree=1, extent=1.0,
                        opacity=opacity)
    jcam = j_look_at(eye=(0.5, 0.3, -6.0), target=(0, 0, 0), fx=220.0,
                     fy=220.0, width=size, height=size)
    return jm, jcam


GRAD_CASES = [
    # (n, opacity, chunk_size, trans_eps, target seed, atol)
    (96, 0.8, 128, 0.0, 7, 2e-3),
    (96, 0.8, 8, 0.0, 7, 2e-3),
    # Saturated: tiles stop early; the loss of test_pallas.py:325-346.
    (256, 0.99, 8, 1e-4, None, 5e-3),
]


@pytest.mark.parametrize("n,opacity,cs,trans_eps,target_seed,atol", GRAD_CASES,
                         ids=["cs128", "cs8", "saturated"])
def test_render_grads_match_jax(n, opacity, cs, trans_eps, target_seed, atol):
    size = 64
    jm, jcam = _grad_scene(n, opacity)
    kw = dict(chunk_size=cs, trans_eps=trans_eps)
    jcfg = JRasterConfig(packed=False, **kw)
    if target_seed is None:
        target = np.zeros((size, size, 3), np.float32)
        bg = np.zeros(3, np.float32)
        t_weight = 0.0
    else:
        target = np.random.default_rng(target_seed).random(
            (size, size, 3)).astype(np.float32)
        bg = np.array([0.3, 0.1, 0.6], np.float32)
        t_weight = 0.1

    def j_loss(params, off, bg_):
        out = j_render(jm.with_params(params), jcam, jcfg, sh_degree=1,
                       background=bg_, mean2d_offset=off,
                       impl="pallas_interpret")
        return (jnp.mean((out.image - target) ** 2)
                + t_weight * jnp.mean(out.transmittance))

    off0 = jnp.zeros((n, 2), jnp.float32)
    jg, jg_off, jg_bg = jax.jit(jax.grad(j_loss, argnums=(0, 1, 2)))(
        jm.trainable(), off0, jnp.asarray(bg))

    model = port_model(jm)
    off = torch.zeros((n, 2), requires_grad=True)
    bg_t = torch.tensor(bg, requires_grad=True)
    out = render(model, port_camera(jcam), RasterConfig(**kw), sh_degree=1,
                 background=bg_t, mean2d_offset=off)
    loss = (((out.image - torch.tensor(target)) ** 2).mean()
            + t_weight * out.transmittance.mean())
    loss.backward()
    for k, p in model.trainable().items():
        _assert_scaled_close(np_(p.grad), jg[k], atol, k)
    _assert_scaled_close(np_(off.grad), jg_off, atol, "mean2d_offset")
    _assert_scaled_close(np_(bg_t.grad), jg_bg, atol, "background")
    assert np.abs(np_(off.grad)).max() > 0


def test_projection_vjp_matches_jax():
    jm = j_random_model(jax.random.PRNGKey(3), 512, sh_degree=3, extent=1.0)
    jm = jm.replace(alive=jm.alive.at[::13].set(False))
    jcam = j_look_at(eye=(0.5, 0.3, -6.0), target=(0, 0, 0), fx=220.0,
                     fy=220.0, width=128, height=96)
    cfg_kw = dict()
    rng = np.random.default_rng(11)

    def f(*inputs):
        p = j_project(*inputs, jcam, JRasterConfig(**cfg_kw), sh_degree=3,
                      alive=jm.alive)
        return tuple(getattr(p, k) for k in PROJ_FLOAT)

    primals = (jm.means, jm.quats, jm.log_scales, jm.logit_opacities, jm.sh)
    outs, vjp = jax.vjp(f, *primals)
    cots = tuple(rng.normal(size=o.shape).astype(np.float32) for o in outs)
    want = vjp(tuple(jnp.asarray(c) for c in cots))

    model = port_model(jm)
    sh = model.sh.detach().requires_grad_(True)
    tp = project_gaussians(model.means, model.quats, model.log_scales,
                           model.logit_opacities, sh, port_camera(jcam),
                           RasterConfig(**cfg_kw), sh_degree=3,
                           alive=model.alive)
    total = sum((getattr(tp, k) * torch.tensor(c)).sum()
                for k, c in zip(PROJ_FLOAT, cots))
    total.backward()
    got = (model.means.grad, model.quats.grad, model.log_scales.grad,
           model.logit_opacities.grad, sh.grad)
    for name, g, w in zip(PROJ_INPUTS, got, want):
        _assert_scaled_close(np_(g), w, 1e-5, name)

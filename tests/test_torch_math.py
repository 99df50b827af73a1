"""Port parity of the math layer (quaternions, SH, cameras) against the JAX
reference, on the cases of tests/test_math.py. Inputs are made once with
numpy and handed to both packages; float results agree within 1e-6."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as ScipyRotation

from gaussiansplat_tpu.ops import camera as jcam
from gaussiansplat_tpu.ops import quaternion as jq
from gaussiansplat_tpu.ops import sh as jsh
from gaussiansplat_tpu_torch.ops import camera as tcam
from gaussiansplat_tpu_torch.ops import quaternion as tq
from gaussiansplat_tpu_torch.ops import sh as tsh

from test_torch_common import limit_torch_threads

limit_torch_threads()

ATOL = 1e-6


def _quats(n=64, seed=0):
    return np.random.default_rng(seed).normal(size=(n, 4)).astype(np.float32)


class TestQuaternion:
    def test_identity(self):
        r = tq.quat_to_rotmat(torch.tensor([1.0, 0.0, 0.0, 0.0]))
        np.testing.assert_allclose(r.numpy(), np.eye(3), atol=ATOL)

    def test_normalize_matches_jax(self):
        q = _quats()
        q[3] = 0.0  # the eps guard
        np.testing.assert_allclose(tq.normalize(torch.as_tensor(q)).numpy(),
                                   np.asarray(jq.normalize(jnp.asarray(q))),
                                   atol=ATOL)

    def test_rotmat_matches_jax_and_scipy(self):
        q = _quats()
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        ours = tq.quat_to_rotmat(torch.as_tensor(q)).numpy()
        np.testing.assert_allclose(
            ours, np.asarray(jq.quat_to_rotmat(jnp.asarray(q))), atol=ATOL)
        theirs = ScipyRotation.from_quat(q[:, [1, 2, 3, 0]]).as_matrix()
        np.testing.assert_allclose(ours, theirs, atol=1e-5)

    def test_rotmat_to_quat_matches_jax_and_roundtrips(self):
        q = _quats(128, seed=1)
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        R = np.array(jq.quat_to_rotmat(jnp.asarray(q)))
        # every pivot branch: identity-like (trace > 0) and the three
        # half-turns about x, y and z (one diagonal entry largest)
        R[:4] = np.stack([np.eye(3), np.diag([1.0, -1, -1]),
                          np.diag([-1.0, 1, -1]), np.diag([-1.0, -1, 1])])
        ours = tq.rotmat_to_quat(torch.as_tensor(R)).numpy()
        np.testing.assert_allclose(
            ours, np.asarray(jq.rotmat_to_quat(jnp.asarray(R))), atol=ATOL)
        dot = np.abs(np.sum(q[4:] * ours[4:], axis=-1))
        np.testing.assert_allclose(dot, 1.0, atol=1e-4)

    @pytest.mark.parametrize("seed", [2, 3])
    def test_covariance_matches_jax(self, seed):
        rng = np.random.default_rng(seed)
        q = rng.normal(size=(32, 4)).astype(np.float32)   # not normalized
        s = np.exp(rng.normal(size=(32, 3))).astype(np.float32)
        ours = tq.build_covariance_3d(torch.as_tensor(q), torch.as_tensor(s))
        want = np.asarray(jq.build_covariance_3d(jnp.asarray(q), jnp.asarray(s)))
        scale = np.abs(want).max(axis=(1, 2), keepdims=True)
        np.testing.assert_allclose(ours.numpy() / scale, want / scale, atol=ATOL)
        np.testing.assert_allclose(ours.numpy(),
                                   np.swapaxes(ours.numpy(), 1, 2), atol=1e-4)
        eigs = np.sort(np.linalg.eigvalsh(ours.numpy().astype(np.float64)), axis=-1)
        np.testing.assert_allclose(eigs, np.sort(s.astype(np.float64) ** 2, axis=-1),
                                   rtol=2e-2, atol=1e-5)

    def test_covariance_unnormalized_quat(self):
        cov = tq.build_covariance_3d(torch.tensor([[2.0, 0.0, 0.0, 0.0]]),
                                     torch.ones((1, 3)))
        np.testing.assert_allclose(cov[0].numpy(), np.eye(3), atol=ATOL)

    def test_random_quats_unit(self):
        g = torch.Generator().manual_seed(1)
        q = tq.random_quats(g, (128,))
        assert q.shape == (128, 4)
        np.testing.assert_allclose(torch.linalg.vector_norm(q, dim=-1).numpy(),
                                   1.0, atol=ATOL)


class TestSH:
    @pytest.mark.parametrize("degree", [0, 1, 2, 3])
    def test_basis_matches_jax(self, degree):
        d = np.random.default_rng(degree).normal(size=(256, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        np.testing.assert_allclose(
            tsh.sh_basis(torch.as_tensor(d), degree).numpy(),
            np.asarray(jsh.sh_basis(jnp.asarray(d), degree)), atol=ATOL)

    @pytest.mark.parametrize("degree", [0, 1, 3])
    def test_eval_flat_matches_jax(self, degree):
        rng = np.random.default_rng(7)
        sh = rng.normal(size=(128, 48)).astype(np.float32)  # K_total = 16
        dirs = rng.normal(size=(128, 3)).astype(np.float32)
        np.testing.assert_allclose(
            tsh.eval_sh_flat(torch.as_tensor(sh), torch.as_tensor(dirs),
                             degree).numpy(),
            np.asarray(jsh.eval_sh_flat(jnp.asarray(sh), jnp.asarray(dirs),
                                        degree)),
            atol=ATOL)

    @pytest.mark.parametrize("degree", [0, 1, 2, 3])
    def test_eval_band_major_matches_jax(self, degree):
        rng = np.random.default_rng(11 + degree)
        sh = rng.normal(size=(128, 16, 3)).astype(np.float32)
        dirs = rng.normal(size=(128, 3)).astype(np.float32)
        ours = tsh.eval_sh(torch.as_tensor(sh), torch.as_tensor(dirs), degree)
        np.testing.assert_allclose(
            ours.numpy(),
            np.asarray(jsh.eval_sh(jnp.asarray(sh), jnp.asarray(dirs), degree)),
            atol=ATOL)
        # the same colours as the flat layout, and the extra bands ignored
        np.testing.assert_allclose(
            ours.numpy(),
            tsh.eval_sh_flat(torch.as_tensor(sh.reshape(128, 48)),
                             torch.as_tensor(dirs), degree).numpy(), atol=ATOL)
        k = tsh.num_sh_coeffs(degree)
        np.testing.assert_allclose(
            tsh.eval_sh(torch.as_tensor(sh[:, :k]), torch.as_tensor(dirs),
                        degree).numpy(), ours.numpy(), atol=ATOL)

    def test_eval_band_major_dc_and_clamp(self):
        sh = torch.zeros((5, 16, 3))
        sh[:, 0, :] = 1.0
        dirs = torch.tensor([[0.0, 0.0, 1.0]]).repeat(5, 1)
        np.testing.assert_allclose(tsh.eval_sh(sh, dirs, 0).numpy(),
                                   tsh.SH_C0 + 0.5, atol=ATOL)
        assert (tsh.eval_sh(-5.0 * torch.ones((1, 1, 3)), dirs[:1], 0) >= 0).all()

    def test_dc_only_and_clamp(self):
        sh = torch.zeros((5, 48))
        sh[:, :3] = 1.0
        dirs = torch.tensor([[0.0, 0.0, 1.0]]).repeat(5, 1)
        rgb = tsh.eval_sh_flat(sh, dirs, 0)
        np.testing.assert_allclose(rgb.numpy(), tsh.SH_C0 + 0.5, atol=ATOL)
        assert (tsh.eval_sh_flat(-5.0 * torch.ones((1, 3)), dirs[:1], 0) >= 0).all()

    def test_degree_count_and_range(self):
        assert [tsh.num_sh_coeffs(d) for d in range(4)] == [1, 4, 9, 16]
        with pytest.raises(ValueError):
            tsh.sh_basis(torch.zeros((1, 3)), 4)

    def test_higher_degree_ignores_extra(self):
        rng = np.random.default_rng(0)
        sh = torch.as_tensor(rng.normal(size=(4, 48)).astype(np.float32))
        dirs = torch.as_tensor(rng.normal(size=(4, 3)).astype(np.float32))
        np.testing.assert_allclose(tsh.eval_sh_flat(sh, dirs, 1).numpy(),
                                   tsh.eval_sh_flat(sh[:, :12], dirs, 1).numpy(),
                                   atol=ATOL)

    def test_dc_conversions_match_jax(self):
        rgb = np.random.default_rng(3).random((32, 3)).astype(np.float32)
        dc = tsh.rgb_to_sh_dc(torch.as_tensor(rgb)).numpy()
        np.testing.assert_allclose(
            dc, np.asarray(jsh.rgb_to_sh_dc(jnp.asarray(rgb))), atol=ATOL)
        np.testing.assert_allclose(
            tsh.sh_dc_to_rgb(torch.as_tensor(dc)).numpy(), rgb, atol=ATOL)


def _assert_cameras_equal(tc, jc):
    for f in ("R", "t", "fx", "fy", "cx", "cy"):
        np.testing.assert_allclose(getattr(tc, f).numpy(),
                                   np.asarray(getattr(jc, f)), atol=ATOL,
                                   err_msg=f)
    assert (tc.width, tc.height) == (jc.width, jc.height)
    np.testing.assert_allclose(tc.position.numpy(), np.asarray(jc.position),
                               atol=1e-5)


class TestCamera:
    @pytest.mark.parametrize("eye,target", [
        ((0, 0, -5), (0, 0, 0)), ((3, 2, 1), (0, 1, 0)),
        ((0.5, 0.3, -6.0), (0, 0, 0))])
    def test_look_at_matches_jax(self, eye, target):
        kw = dict(fx=220.0, fy=200.0, width=100, height=72)
        _assert_cameras_equal(tcam.look_at(eye, target, device="cpu", **kw),
                              jcam.look_at(eye, target, **kw))

    @pytest.mark.parametrize("angle", [0.0, 1.3, math.pi])
    def test_orbit_matches_jax(self, angle):
        kw = dict(fx=1600.0, fy=1600.0, width=1920, height=1080)
        _assert_cameras_equal(
            tcam.orbit_camera(angle, 4.0, height_offset=1.0, device="cpu", **kw),
            jcam.orbit_camera(angle, 4.0, height_offset=1.0, **kw))

    def test_look_at_maps_target_forward(self):
        cam = tcam.look_at((0, 0, -5), (0, 0, 0), width=64, height=64,
                           device="cpu")
        np.testing.assert_allclose((cam.R @ torch.zeros(3) + cam.t).numpy(),
                                   [0, 0, 5], atol=1e-5)

    def test_make_camera_and_fov(self):
        kw = dict(fx=100.0, fy=90.0, width=64, height=48)
        R, t = np.eye(3, dtype=np.float32), np.array([0.1, -0.2, 5.0], np.float32)
        tc = tcam.make_camera(R, t, device="cpu", **kw)
        _assert_cameras_equal(tc, jcam.make_camera(R, t, **kw))
        jc = jcam.look_at((0, 0, -5), (0, 0, 0), **kw)
        tc = tcam.look_at((0, 0, -5), (0, 0, 0), device="cpu", **kw)
        np.testing.assert_allclose(
            [float(x) for x in tc.tan_half_fov()],
            [float(x) for x in jc.tan_half_fov()], atol=ATOL)
        assert tcam.fov_to_focal(1.1, 800) == jcam.fov_to_focal(1.1, 800)
        assert tcam.focal_to_fov(700.0, 800) == jcam.focal_to_fov(700.0, 800)

    def test_camera_from_numpy(self):
        jc = jcam.look_at((1, 2, -5), (0, 0, 0), fx=300.0, fy=310.0,
                          width=90, height=70)
        tc = tcam.camera_from_numpy(np.asarray(jc.R), np.asarray(jc.t), jc.fx,
                                    jc.fy, jc.cx, jc.cy, jc.width, jc.height,
                                    device="cpu")
        _assert_cameras_equal(tc, jc)

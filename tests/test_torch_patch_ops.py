"""The port's patch compositing against the JAX package's `ops/patch_ops.py`
and `ops/grid_sample.py`: the affine warp, paste, scaled paste, both
composites, and the batched op with the JAX package's random draws replayed
(`replay_patch_draws`, also used by the attack-step tests), with its
gradient with respect to the patch.

Tolerance 1e-6: the port transcribes the same f32 arithmetic op by op
(the warp agrees exactly; the gradient's scatter-adds may sum in another
order)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from roboticattack_tpu.ops import grid_sample as jgrid
from roboticattack_tpu.ops import patch_ops as jpatch
from roboticattack_torch.ops import grid_sample as tgrid
from roboticattack_torch.ops import patch_ops as tpatch

TOL = dict(rtol=1e-6, atol=1e-6)


def replay_patch_draws(key, batch, height, width, ph, pw, resize_patch=False):
    """The draws the JAX `apply_patch_batch(images, patch, key)` makes, as the
    port's PatchDraws: split(key, B), then per image split(k, 3) ->
    placement, rescale factor, affine matrix (apply_patch_single)."""
    xy, mats, scales = [], [], []
    for k in jax.random.split(key, batch):
        k_place, k_scale, k_aff = jax.random.split(k, 3)
        if resize_patch:
            lo, hi = tpatch.SCALE_RANGE
            scales.append(float(jax.random.uniform(k_scale, (), minval=lo, maxval=hi)))
            max_side = int(np.ceil(max(ph, pw) * hi))
            kx, ky = jax.random.split(k_place)
            x = jax.random.randint(kx, (), 0, max(width - max_side, 1))
            y = jax.random.randint(ky, (), 0, max(height - max_side, 1))
        else:
            x, y = jpatch.random_placement(k_place, height, width, ph, pw)
            scales.append(1.0)
        xy.append((int(x), int(y)))
        mats.append(np.asarray(jgrid.random_affine_matrix(k_aff)))
    return tpatch.PatchDraws(xy=torch.tensor(xy), matrix=torch.from_numpy(np.stack(mats)),
                             scale=torch.tensor(scales, dtype=torch.float32))


def _canvas(seed, size=56, ph=12, pw=9):
    rng = np.random.default_rng(seed)
    canvas = np.full((size, size, 3), -100.0, np.float32)
    x, y = rng.integers(0, size - pw), rng.integers(0, size - ph)
    canvas[y:y + ph, x:x + pw] = rng.uniform(size=(ph, pw, 3))
    return canvas


@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
def test_affine_warp_matches_jax_on_random_matrices(padding_mode):
    """20 random augmentation matrices on -100-filled canvases: the
    transcription agrees with the JAX gather arithmetic."""
    keys = jax.random.split(jax.random.key(0), 20)
    mats = np.stack([np.asarray(jgrid.random_affine_matrix(k)) for k in keys])
    canvases = np.stack([_canvas(i) for i in range(20)])
    want = np.stack([np.asarray(jgrid.affine_warp(jnp.asarray(c), jnp.asarray(m), padding_mode))
                     for c, m in zip(canvases, mats)])
    got = tgrid.affine_warp(torch.from_numpy(canvases), torch.from_numpy(mats), padding_mode).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # the composite test reads the same side of -20 everywhere
    np.testing.assert_array_equal(got < -20, want < -20)


def test_affine_matrices_match_jax():
    for angle, shx, shy in [(0.0, 0.0, 0.0), (17.5, 0.1, -0.15), (-30.0, -0.2, 0.2)]:
        np.testing.assert_allclose(tgrid.fixed_affine_matrix(angle, shx, shy),
                                   jgrid.fixed_affine_matrix(angle, shx, shy), rtol=0, atol=0)
        want = np.asarray(jgrid.shear_matrix(jnp.float32(shx), jnp.float32(shy))
                          @ jgrid.rotation_matrix(jnp.float32(angle)))
        got = (tgrid.shear_matrix(shx, shy) @ tgrid.rotation_matrix(angle)).numpy()
        np.testing.assert_allclose(got, want, **TOL)
    m = tgrid.random_affine_matrix(64, torch.Generator().manual_seed(0))
    assert m.shape == (64, 3, 3)
    eye = (m == torch.eye(3)).all(dim=(1, 2))
    assert 0 < int(eye.sum()) < 64  # some identities, some warps
    assert torch.all(m[:, 2] == torch.tensor([0.0, 0.0, 1.0]))


def test_paste_and_composites_match_jax():
    rng = np.random.default_rng(1)
    patch = rng.uniform(size=(10, 7, 3)).astype(np.float32)
    image = rng.uniform(size=(40, 40, 3)).astype(np.float32)
    for x, y in [(0, 0), (33, 30), (12, 5), (50, 50)]:  # the last is clamped
        want = np.asarray(jpatch.paste_patch(jnp.asarray(patch), jnp.int32(x), jnp.int32(y), 40, 40))
        got = tpatch.paste_patch(torch.from_numpy(patch), x, y, 40, 40).numpy()
        np.testing.assert_array_equal(got, want)
        for scale in (0.61, 1.0, 1.3):
            want_s = np.asarray(jpatch.paste_patch_scaled(jnp.asarray(patch), jnp.int32(x % 20), jnp.int32(y % 20),
                                                          jnp.float32(scale), 40, 40))
            got_s = tpatch.paste_patch_scaled(torch.from_numpy(patch), x % 20, y % 20,
                                              torch.tensor(scale), 40, 40).numpy()
            np.testing.assert_allclose(got_s, want_s, **TOL)
        np.testing.assert_array_equal(
            tpatch.composite(torch.from_numpy(got), torch.from_numpy(image)).numpy(),
            np.asarray(jpatch.composite(jnp.asarray(want), jnp.asarray(image))))
        np.testing.assert_array_equal(
            tpatch.composite_exact(torch.from_numpy(got), torch.from_numpy(image)).numpy(),
            np.asarray(jpatch.composite_exact(jnp.asarray(want), jnp.asarray(image))))


@pytest.mark.parametrize("geometry,resize_patch", [(True, False), (False, False), (True, True), (False, True)])
def test_apply_patch_batch_with_replayed_draws(geometry, resize_patch):
    """The batched op and its patch gradient against the JAX op under the
    JAX key, the draws replayed."""
    rng = np.random.default_rng(2)
    images = rng.uniform(size=(3, 56, 56, 3)).astype(np.float32)
    patch = rng.uniform(size=(10, 10, 3)).astype(np.float32)
    w = rng.standard_normal(images.shape).astype(np.float32)
    key = jax.random.key(7 + 2 * geometry + resize_patch)

    def jfn(p):
        return jpatch.apply_patch_batch(jnp.asarray(images), p, key, geometry=geometry,
                                        resize_patch=resize_patch)

    want = np.asarray(jfn(jnp.asarray(patch)))
    want_grad = np.asarray(jax.grad(lambda p: jnp.sum(jfn(p) * jnp.asarray(w)))(jnp.asarray(patch)))

    draws = replay_patch_draws(key, 3, 56, 56, 10, 10, resize_patch)
    tp = torch.from_numpy(patch).requires_grad_(True)
    got = tpatch.apply_patch_batch(torch.from_numpy(images), tp, draws, geometry, resize_patch)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    np.testing.assert_allclose(tp.grad.numpy(), want_grad, rtol=1e-5, atol=1e-6)


def test_draw_patch_params_stay_in_bounds():
    gen = torch.Generator().manual_seed(3)
    for resize in (False, True):
        d = tpatch.draw_patch_params(gen, 16, 56, 48, 10, 12, resize_patch=resize)
        assert d.xy.shape == (16, 2) and d.matrix.shape == (16, 3, 3) and d.scale.shape == (16,)
        assert (d.xy[:, 0] >= 0).all() and (d.xy[:, 0] <= 48 - 12).all()
        assert (d.xy[:, 1] >= 0).all() and (d.xy[:, 1] <= 56 - 10).all()
        assert ((d.scale >= 0.61) & (d.scale <= 1.39)).all()
    again = tpatch.draw_patch_params(torch.Generator().manual_seed(3), 16, 56, 48, 10, 12)
    first = tpatch.draw_patch_params(torch.Generator().manual_seed(3), 16, 56, 48, 10, 12)
    assert torch.equal(again.xy, first.xy) and torch.equal(again.matrix, first.matrix)


def test_quantize_patch_u8_matches_jax():
    patch = np.random.default_rng(4).uniform(-0.2, 1.2, size=(9, 9, 3)).astype(np.float32)
    np.testing.assert_array_equal(tpatch.quantize_patch_u8(patch), jpatch.quantize_patch_u8(patch))

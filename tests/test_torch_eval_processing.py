"""Slice 5's frame path on the CPU: the port's JPEG round trip, lanczos3
resize, LIBERO frame, center crop, `quat2axisangle`, the gripper chain,
`simulation_paste_patch`, `is_noop` and the policy's center crop, each
against TensorFlow or the JAX package on numpy-seeded inputs.

Tolerances: all exact. The JPEG helper equals `tf.io.decode_image(
tf.image.encode_jpeg(x))` bit for bit (same libjpeg settings: quality 95,
4:2:0, the fast integer IDCT); the resize and crop transcriptions follow
TensorFlow's CPU kernels in float32 op for op (the Lanczos weights take the
C library's sinf, as the kernel does), so they equal TF bit for bit at 256->256,
256->224 and the upsampling case tested here."""

import numpy as np
import jax
import pytest

tf = pytest.importorskip("tensorflow")

from roboticattack_tpu.eval import processing as jproc
from roboticattack_tpu.eval.regenerate_libero import is_noop as jax_is_noop
from roboticattack_tpu.ops.patch_ops import simulation_paste_patch as jax_paste
from roboticattack_tpu.utils import gripper as jgrip
from roboticattack_torch.eval import jpeg as tjpeg
from roboticattack_torch.eval import processing as tproc
from roboticattack_torch.eval.regenerate_libero import is_noop
from roboticattack_torch.ops.patch_ops import simulation_paste_patch
from roboticattack_torch.utils import gripper as tgrip

tf.config.set_visible_devices([], "GPU")


def frame(kind, seed, size=256):
    """A noise frame (the replay episodes' kind) or a smooth one (gradients
    and a disc: what a JPEG keeps nearly whole)."""
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)
    cy, cx, r = rng.uniform(0.3, 0.7, 2).tolist() + [rng.uniform(0.1, 0.3)]
    disc = ((yy / size - cy) ** 2 + (xx / size - cx) ** 2 < r * r) * 80.0
    img = np.stack([xx / size * 200 + disc, yy / size * 180 + 30, (xx + yy) / (2 * size) * 255 - disc / 2], -1)
    return np.clip(img + rng.normal(0, 2, img.shape), 0, 255).astype(np.uint8)


FRAMES = [(k, s) for k in ("noise", "smooth") for s in (0, 1, 2)]


@pytest.mark.parametrize("kind,seed", FRAMES)
def test_jpeg_roundtrip_equals_tf(kind, seed):
    img = frame(kind, seed)
    want = tf.io.decode_image(tf.image.encode_jpeg(img), expand_animations=False, dtype=tf.uint8).numpy()
    np.testing.assert_array_equal(tjpeg.jpeg_roundtrip(img), want)


def test_jpeg_roundtrip_odd_sizes_and_errors():
    img = frame("smooth", 3)[:37, :53]
    want = tf.io.decode_image(tf.image.encode_jpeg(img), expand_animations=False, dtype=tf.uint8).numpy()
    np.testing.assert_array_equal(tjpeg.jpeg_roundtrip(img), want)
    with pytest.raises(ValueError, match="RGB"):
        tjpeg.jpeg_roundtrip(img[..., 0])


@pytest.mark.parametrize("size", [256, 224])
@pytest.mark.parametrize("kind,seed", FRAMES)
def test_libero_frame_equals_jax(kind, seed, size):
    """Rotate 180, JPEG round trip, lanczos3 resize, round and clip: bit for
    bit at the eval's 224 as at 256."""
    img = frame(kind, seed)
    np.testing.assert_array_equal(tproc.libero_frame(img, size), jproc.libero_frame(img, size))


@pytest.mark.parametrize("shape,size", [((256, 256, 3), 224), ((256, 256, 3), 256), ((200, 180, 3), 224),
                                        ((96, 128, 1), 64)])
def test_lanczos3_resize_equals_tf(shape, size):
    img = np.random.default_rng(sum(shape)).uniform(0, 255, shape).astype(np.float32)
    want = tf.image.resize(img, (size, size), method="lanczos3", antialias=True).numpy()
    np.testing.assert_array_equal(tproc.lanczos3_resize(img, size), want)


@pytest.mark.parametrize("side", [224, 256, 300])
@pytest.mark.parametrize("kind", ["noise", "smooth"])
def test_center_crop_resize_equals_jax(kind, side):
    img = frame(kind, side, size=side)
    np.testing.assert_array_equal(tproc.center_crop_resize_tf(img), jproc.center_crop_resize_tf(img))


@pytest.mark.parametrize("quat", [[0, 0, 0, 1], [0.1, 0.2, 0.3, 0.927], [0.5, -0.5, 0.5, -0.5],
                                  [0, 0, 0, 1.0000001], [0.7071068, 0, 0, 0.7071068]])
def test_quat2axisangle_equals_jax(quat):
    np.testing.assert_array_equal(tproc.quat2axisangle(quat), jproc.quat2axisangle(quat))


def test_gripper_chain_equals_jax():
    rng = np.random.default_rng(7)
    actions = rng.uniform(-0.2, 1.2, (64, 7))
    actions[::8, -1] = 0.5  # the sign of exactly 0 after the rescale
    for binarize in (True, False):
        got = tgrip.invert_gripper_action(tgrip.normalize_gripper_action(actions, binarize))
        want = jgrip.invert_gripper_action(jgrip.normalize_gripper_action(actions, binarize))
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tgrip.normalize_gripper_action(actions[0]),
                                  jgrip.normalize_gripper_action(actions[0]))


@pytest.mark.parametrize("geometry", [
    dict(), dict(geometry=True), dict(geometry=True, angle=15.0), dict(geometry=True, shx=0.2, shy=-0.1),
    dict(geometry=True, angle=-30.0, shx=0.1),
], ids=["plain", "identity-warp", "rotate", "shear", "rotate-shear"])
def test_simulation_paste_patch_equals_jax(geometry):
    rng = np.random.default_rng(8)
    img = rng.integers(0, 256, (224, 224, 3), dtype=np.uint8)
    patch = rng.uniform(0, 1, (40, 30, 3)).astype(np.float32)
    for pos in ((120, 160), (0, 0), (194, 184)):
        got = simulation_paste_patch(img, patch, pos, **geometry)
        np.testing.assert_array_equal(got, jax_paste(img, patch, pos, **geometry))
        assert got.dtype == np.uint8 and not np.array_equal(got, img)


def test_is_noop_equals_jax():
    rng = np.random.default_rng(9)
    cases = [(np.zeros(7), None), (np.array([0.01, 0, 0, 0, 0, 0, -1.0]), np.zeros(7)),
             (np.array([0, 0, 0, 0, 0, 0, -1.0]), np.array([1e-9] * 6 + [-1.0])),
             (np.array([0, 0, 0, 0, 0, 0, 1.0]), np.array([0, 0, 0, 0, 0, 0, -1.0]))]
    cases += [(rng.normal(0, 1e-4, 7), rng.choice([-1.0, 1.0], 7)) for _ in range(20)]
    got = [is_noop(a, p) for a, p in cases]
    assert got == [jax_is_noop(a, p) for a, p in cases]
    assert got[:4] == [True, False, True, False]


def test_policy_center_crop_equals_jax():
    """VLAPolicy(center_crop=True): each frame cropped to 0.9 of its area
    and resized back before the processor, as the JAX policy does — the
    same tokens and actions; and the crop changes them."""
    from roboticattack_tpu.eval.policy import VLAPolicy as JaxPolicy
    from roboticattack_tpu.models import VLA_TINY, init_vla_params
    from roboticattack_tpu.utils.prompting import WordStubTokenizer as JaxStub
    from roboticattack_torch.eval.policy import VLAPolicy
    from roboticattack_torch.models.bridge import params_from_jax
    from roboticattack_torch.models.config import VLA_TINY as T_TINY
    from roboticattack_torch.utils.prompting import WordStubTokenizer

    params = jax.device_get(init_vla_params(jax.random.key(23), VLA_TINY))
    stats = {"k": {"action": {"q01": [-0.2] * 7, "q99": [0.4] * 7, "mask": [True] * 6 + [False]}}}
    frames = np.stack([frame("smooth", 4, 224), frame("noise", 5, 224)])
    tasks = ["open the drawer", "pick up the bowl"]
    want = JaxPolicy(params, VLA_TINY, JaxStub(), stats, center_crop=True)
    got = VLAPolicy(params_from_jax(params, "cpu", T_TINY), T_TINY, WordStubTokenizer(), stats,
                    center_crop=True, device="cpu")
    acts = got.get_action_multi(frames, tasks)
    np.testing.assert_allclose(acts, want.get_action_multi(frames, tasks), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got.last_tokens, want.last_tokens)
    plain = VLAPolicy(params_from_jax(params, "cpu", T_TINY), T_TINY, WordStubTokenizer(), stats, device="cpu")
    cropped = got.prepare(frames, tasks)[2]
    assert not np.array_equal(cropped.numpy(), plain.prepare(frames, tasks)[2].numpy())

"""The port's small public helpers against the JAX package's: the patch PNG,
`is_quantized`, the image denormalization and the reference's 6-channel
pixel layout, TMA's dict label rewrite, the tracker's image log and the
seeding helper. Tolerances: exact (the same arithmetic), the normalization
round trips rtol 1e-6 (f32)."""

import random

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from roboticattack_tpu.attacks import artifacts as jart
from roboticattack_tpu.eval import policy as jpolicy
from roboticattack_tpu.models import quant as jquant
from roboticattack_tpu.utils import labels as jlabels
from roboticattack_tpu.utils import normalization as jnorm
from roboticattack_torch.attacks import artifacts as tart
from roboticattack_torch.eval import policy as tpolicy
from roboticattack_torch.models import quant as tquant
from roboticattack_torch.models.decode import decode_layout_params
from roboticattack_torch.models.config import VLA_TINY
from roboticattack_torch.models.vlm import init_vla_params
from roboticattack_torch.utils import labels as tlabels
from roboticattack_torch.utils import normalization as tnorm
from roboticattack_torch.utils.constants import DINO_MEAN, DINO_STD, IGNORE_INDEX, SIGLIP_MEAN, SIGLIP_STD
from roboticattack_torch.utils.tracking import Tracker


def test_save_patch_png_equals_the_jax_packages(tmp_path):
    patch = np.random.default_rng(0).uniform(-0.1, 1.1, (12, 9, 3)).astype(np.float32)
    tart.save_patch_png(patch, str(tmp_path / "t.png"))
    jart.save_patch_png(patch, str(tmp_path / "j.png"))
    got, want = (np.asarray(Image.open(tmp_path / f"{n}.png").convert("RGB")) for n in "tj")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", [None, "int8", "int4"])
def test_is_quantized_equals_the_jax_packages(mode):
    params = decode_layout_params(init_vla_params(torch.Generator().manual_seed(0), VLA_TINY, device="cpu"))
    if mode:
        params = tquant.quantize_decode_params(params, mode=mode, group_size=8)
    host = {"llm": {"layers": {k: v.numpy() for k, v in params["llm"]["layers"].items()}}}
    assert tquant.is_quantized(params) == jquant.is_quantized(host) == (mode is not None)


def test_denormalize_and_the_nchw6_layout_equal_the_jax_packages():
    rng = np.random.default_rng(1)
    images = rng.uniform(0, 1, (2, 5, 7, 3)).astype(np.float32)
    for mean, std in ((DINO_MEAN, DINO_STD), (SIGLIP_MEAN, SIGLIP_STD)):
        normed = tnorm.normalize_image(torch.from_numpy(images), mean, std)
        got = tnorm.denormalize_image(normed, mean, std).numpy()
        want = np.asarray(jnorm.denormalize_image(jnp.asarray(normed.numpy()), np.asarray(mean), np.asarray(std)))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(got, images, rtol=1e-6, atol=1e-6)
    nchw6 = rng.standard_normal((2, 6, 5, 7)).astype(np.float32)
    got = tnorm.dual_normalize_from_nchw6(torch.from_numpy(nchw6))
    assert got.shape == (2, 2, 5, 7, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnorm.dual_normalize_from_nchw6(jnp.asarray(nchw6))))
    # the reference's stack of the two normalizations comes back as dual_normalize's
    stacked = tnorm.dual_normalize(torch.from_numpy(images)).permute(0, 1, 4, 2, 3).reshape(2, 6, 5, 7)
    np.testing.assert_array_equal(tnorm.dual_normalize_from_nchw6(stacked).numpy(),
                                  tnorm.dual_normalize(torch.from_numpy(images)).numpy())
    with pytest.raises(ValueError, match="6-channel"):
        tnorm.dual_normalize_from_nchw6(torch.zeros(1, 3, 4, 4))


def test_modify_labels_dict_equals_the_jax_packages():
    labels = np.full((3, 10), IGNORE_INDEX, np.int64)
    labels[0, 2:9] = np.arange(31800, 31807)
    labels[1, 5:10] = 31900
    # row 2 has no valid label: its first valid index is 0
    target = {"0": 31744, "2": IGNORE_INDEX, "4": 31999, "6": 2, "-12": 5, "-9": 6}
    got = tlabels.modify_labels_dict(torch.from_numpy(labels), target).numpy()
    want = np.asarray(jlabels.modify_labels_dict(jnp.asarray(labels), target))
    np.testing.assert_array_equal(got, want)
    assert got[0, 2] == 31744 and got[1, 9] == 31999 and got[2, 1] == 6


def test_tracker_log_images_without_wandb_writes_nothing(tmp_path):
    tracker = Tracker(str(tmp_path), quiet=True)
    tracker.log_images("adv", [str(tmp_path / "x.png")], step=0)
    tracker.close()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["run-metrics.jsonl"]
    assert (tmp_path / "run-metrics.jsonl").read_text() == ""


def test_set_seed_everywhere_equals_the_jax_packages():
    def draws():
        return random.random(), np.random.random(), torch.rand(()).item()

    jpolicy.set_seed_everywhere(7)
    want = draws()
    tpolicy.set_seed_everywhere(7)
    assert draws() == want
    tpolicy.set_seed_everywhere(8)
    assert draws() != want

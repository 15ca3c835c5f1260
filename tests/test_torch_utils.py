"""The port's host-side copies against the JAX package: model configs,
constants, the action-token decode, the --quantize grammar, the int4 group
size rule and the eval processing helpers. All exact: these are the same
values and the same integer or string logic on both sides."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from roboticattack_tpu.eval import processing as jproc
from roboticattack_tpu.models import config as jconfig
from roboticattack_tpu.models.quant import int4_group_size_for as j_group_size
from roboticattack_tpu.utils import action_tokenizer as jtok
from roboticattack_tpu.utils import constants as jconst
from roboticattack_tpu.utils import quant_args as jqa
from roboticattack_torch.eval import processing as tproc
from roboticattack_torch.models import config as tconfig
from roboticattack_torch.models.quant import int4_group_size_for as t_group_size
from roboticattack_torch.utils import action_tokenizer as ttok
from roboticattack_torch.utils import constants as tconst
from roboticattack_torch.utils import quant_args as tqa


@pytest.mark.parametrize("name", sorted(jconfig.REGISTRY))
def test_registry_configs_match(name):
    want = jconfig.REGISTRY[name]
    got = tconfig.get_config(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.num_patches == want.num_patches
    assert got.action_vocab_size == want.action_vocab_size


def test_constants_match():
    names = sorted(n for n in dir(jconst) if n.isupper())
    assert names == sorted(n for n in dir(tconst) if n.isupper())
    for n in names:
        np.testing.assert_array_equal(np.asarray(getattr(tconst, n)), np.asarray(getattr(jconst, n)), n)


def test_decode_tokens_match():
    """Every id of the vocab and a few out of range, through the torch and
    the numpy decode, against the JAX decode (bin geometry included)."""
    np.testing.assert_array_equal(ttok.BINS, jtok.BINS)
    np.testing.assert_array_equal(ttok.BIN_CENTERS, jtok.BIN_CENTERS)
    ids = np.arange(31700, 32064, dtype=np.int32)
    want = np.asarray(jtok.decode_tokens(jnp.asarray(ids)))
    np.testing.assert_array_equal(ttok.decode_tokens(torch.from_numpy(ids)).numpy(), want)
    np.testing.assert_array_equal(ttok.decode_tokens_np(ids), jtok.decode_tokens_np(ids))


@pytest.mark.parametrize("spec", [None, "int8", "w8a8", "int4", "int4:64", "int4:32"])
def test_quantize_grammar_matches(spec):
    assert tqa.parse_quantize(spec) == jqa.parse_quantize(spec)
    assert tqa.resolve_quantize(spec) == jqa.resolve_quantize(spec)


@pytest.mark.parametrize("spec", ["int4:0", "int4:x", "int4:-8", "fp8", "int"])
def test_quantize_grammar_refuses_the_same(spec):
    with pytest.raises(ValueError):
        jqa.parse_quantize(spec)
    with pytest.raises(ValueError, match="quantize="):
        tqa.parse_quantize(spec)


def test_int4_kernel_flag_matches():
    for s in ("auto", "on", "off"):
        assert tqa.resolve_int4_kernel(s) == jqa.resolve_int4_kernel(s)


@pytest.mark.parametrize("name", ["openvla-7b", "vla-tiny"])
def test_int4_group_size_matches(name):
    assert t_group_size(tconfig.get_config(name)) == j_group_size(jconfig.get_config(name))


def test_eval_processing_matches():
    task = "Put the Bowl on the PLATE"
    assert tproc.eval_prompt(task) == jproc.eval_prompt(task)
    img = np.random.default_rng(0).integers(0, 256, (90, 120, 3), dtype=np.uint8)
    np.testing.assert_array_equal(tproc.resize_bicubic_pil(img, 56), jproc.resize_bicubic_pil(img, 56))
    np.testing.assert_array_equal(tproc.center_crop_resize_tf(img), jproc.center_crop_resize_tf(img))

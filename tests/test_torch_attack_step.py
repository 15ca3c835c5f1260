"""One outer attack step of the port against the JAX package's
`make_attack_step` on VLA_TINY with attn_impl="flash" (the JAX side runs its
Pallas kernels interpreted, the port their plain versions), the random
draws of the JAX key replayed: uada, tma (maskidx [6]), upa (L1 clip 1e-3)
and upa_guide (coin replayed), the accumulation path, and the val and
clean-filter steps.

Tolerances: per-inner-step metrics rtol 1e-4 (a forward and backward
through the tiny VLA in f32, as the forward tests); the patch and Adam's m
after two AdamW steps at lr 2e-3 atol 1e-5, v and the gradient buffers
relative 1e-3 of their largest entry (they are squares and raw gradients,
~1e-10 and ~1e-5)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from roboticattack_tpu.attacks import engine as je
from roboticattack_tpu.data import batch_iterator as jbatch_iterator
from roboticattack_tpu.data import dummy_frame_iterator as jdummy
from roboticattack_tpu.models import VLA_TINY, init_vla_params
from roboticattack_tpu.utils.labels import build_tma_target_tokens
from roboticattack_tpu.utils.prompting import WordStubTokenizer as JaxStub
from roboticattack_torch.attacks import engine as te
from roboticattack_torch.attacks.optimizer import AdamState
from roboticattack_torch.models.bridge import params_from_jax
from roboticattack_torch.models.config import VLA_TINY as T_TINY
from test_torch_patch_ops import replay_patch_draws

PATCH_HW = (10, 10)
JCFG = dataclasses.replace(VLA_TINY, llm=dataclasses.replace(VLA_TINY.llm, attn_impl="flash"))
TCFG = dataclasses.replace(T_TINY, llm=dataclasses.replace(T_TINY.llm, attn_impl="flash"))


@pytest.fixture(scope="module")
def setup():
    params = jax.device_get(init_vla_params(jax.random.key(2), VLA_TINY))
    batch = next(jbatch_iterator(jdummy(JaxStub(), image_size=56, seed=4), batch_size=2, pad_to=48))
    # host copy: the JAX step donates (deletes) the state it is given
    jstate = jax.device_get(je.init_attack_state(jax.random.key(3), PATCH_HW))
    return params, params_from_jax(params), batch, jstate


def _torch_state(jstate):
    to = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return te.AttackState(patch=to(jstate.patch), opt=AdamState(*(to(x) for x in jstate.opt)),
                          grad_acc=to(jstate.grad_acc))


def _replay_step(rng, spec, batch):
    """The StepDraws of the JAX step under `rng`: k_label, k_inner = split;
    the coin is bernoulli(k_label); split(k_inner, inner_loop) per inner
    step."""
    k_label, k_inner = jax.random.split(rng)
    b, h, w, _ = batch.images.shape
    inner = [replay_patch_draws(k, b, h, w, *PATCH_HW, spec.resize_patch)
             for k in jax.random.split(k_inner, spec.inner_loop)]
    coin = None
    if spec.objective == "upa_guide":
        coin = torch.from_numpy(np.array(jax.random.bernoulli(k_label, 0.5, batch.labels.shape)))
    return te.StepDraws(inner=inner, coin=coin)


def _rel_close(got, want, rel=1e-3):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * np.abs(want).max() + 1e-30)


CASES = {
    "uada": (dict(objective="uada"), [0, 1, 2, 3, 4, 5, 6]),
    "tma": (dict(objective="tma"), [6]),
    "upa": (dict(objective="upa", grad_clip_l1=1e-3), [0, 1, 2, 3, 4, 5, 6]),
    "upa_guide": (dict(objective="upa_guide", grad_clip_l1=1e-3), [0, 1, 2]),
}


@pytest.mark.parametrize("name", list(CASES))
def test_outer_step_matches_jax(setup, name):
    jparams, tparams, batch, jstate = setup
    kw, maskidx = CASES[name]
    spec_kw = dict(kw, inner_loop=2)
    target = build_tma_target_tokens(np.zeros(7), maskidx) if kw["objective"] == "tma" else None
    jstep = je.make_attack_step(je.AttackSpec(**spec_kw), JCFG, target, maskidx)
    tspec = te.AttackSpec(**spec_kw)
    tstep = te.make_attack_step(tspec, TCFG, target, maskidx)

    rng = jax.random.key(17)
    jst, jm = jstep(jparams, jax.tree.map(jnp.asarray, jstate), batch, jnp.float32(2e-3), jnp.bool_(True), rng)
    tst, tm = tstep(tparams, _torch_state(jstate), te.batch_to_device(batch, "cpu"), 2e-3, True,
                    _replay_step(rng, tspec, batch))
    assert sorted(tm) == sorted(jm)
    for k in jm:
        assert tm[k].shape == (2,)
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]), rtol=1e-4, atol=1e-9, err_msg=k)
    np.testing.assert_allclose(tst.patch.numpy(), np.asarray(jst.patch), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tst.opt.m.numpy(), np.asarray(jst.opt.m), rtol=0, atol=1e-5)
    _rel_close(tst.opt.v.numpy(), jst.opt.v)
    assert int(tst.opt.count) == int(jst.opt.count) == 2
    np.testing.assert_array_equal(tst.grad_acc.numpy(), np.asarray(jst.grad_acc))  # zeros
    assert not np.array_equal(tst.patch.numpy(), np.asarray(jstate.patch))


def test_accumulation_step_holds_the_update(setup):
    """accumulate_steps 2, apply_update False: patch and Adam state wait,
    the buffer holds the sum of the raw inner gradients."""
    jparams, tparams, batch, jstate = setup
    spec_kw = dict(objective="tma", inner_loop=2, accumulate_steps=2)
    target = build_tma_target_tokens(np.zeros(7), [0, 1, 2, 3, 4, 5, 6])
    jstep = je.make_attack_step(je.AttackSpec(**spec_kw), JCFG, target, range(7))
    tspec = te.AttackSpec(**spec_kw)
    tstep = te.make_attack_step(tspec, TCFG, target, range(7))
    rng = jax.random.key(23)
    jst, jm = jstep(jparams, jax.tree.map(jnp.asarray, jstate), batch, jnp.float32(2e-3), jnp.bool_(False), rng)
    tst, tm = tstep(tparams, _torch_state(jstate), te.batch_to_device(batch, "cpu"), 2e-3, False,
                    _replay_step(rng, tspec, batch))
    np.testing.assert_array_equal(tst.patch.numpy(), np.asarray(jstate.patch))
    assert int(tst.opt.count) == 0
    _rel_close(tst.grad_acc.numpy(), jst.grad_acc)
    np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]), rtol=1e-4)


@pytest.mark.parametrize("objective,maskidx", [("tma", [6]), ("uada", [0, 1, 2, 3, 4, 5, 6])])
def test_val_and_clean_filter_steps_match_jax(setup, objective, maskidx):
    jparams, tparams, batch, jstate = setup
    spec = dict(objective=objective, inner_loop=2)
    target = build_tma_target_tokens(np.zeros(7), maskidx) if objective == "tma" else None
    jval = je.make_val_step(je.AttackSpec(**spec), JCFG, target, maskidx)
    tval = te.make_val_step(te.AttackSpec(**spec), TCFG, target, maskidx)
    rng = jax.random.key(29)
    want = jval(jparams, jstate.patch, batch, rng)
    _, k_patch, _ = jax.random.split(rng, 3)
    b, h, w, _ = batch.images.shape
    draws = te.StepDraws(inner=[replay_patch_draws(k_patch, b, h, w, *PATCH_HW)])
    tbatch = te.batch_to_device(batch, "cpu")
    got = tval(tparams, torch.from_numpy(np.array(jstate.patch)), tbatch, draws)
    if objective == "tma":  # maskidx [6]: the JAX val leaves the filter to its own step
        want = dict(want, clean_gripper_correct=je.make_clean_filter_step(JCFG)(jparams, batch))
        np.testing.assert_array_equal(te.make_clean_filter_step(TCFG)(tparams, tbatch).numpy(),
                                      np.asarray(want["clean_gripper_correct"]))
    assert sorted(got) == sorted(want)
    for k in want:
        if k == "clean_gripper_correct" and objective == "tma":
            continue
        # Under jit XLA rounds the warp's coordinate arithmetic differently
        # from the eager op the port matches exactly (test_torch_patch_ops):
        # ~1e-6 in a sample position, which a pixel interpolated against the
        # -100 canvas fill amplifies 100-fold.
        atol = 1e-3 if k == "_patched_images" else 1e-6
        np.testing.assert_allclose(np.asarray(got[k], np.float64), np.asarray(want[k], np.float64),
                                   rtol=1e-4, atol=atol, err_msg=k)

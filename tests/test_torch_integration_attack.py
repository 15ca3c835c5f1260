"""The JAX package's end-to-end integration tests (test_integration_attack.py)
on the port, on the CPU: train a tiny VLA on an image-dependent task with the
port's `VLATrainer`, then attack it with the port's attack steps.

`test_train_then_attack_flips_policy` runs `chip_smoke.train_then_attack`,
which chip_smoke.py's `train` phase runs on the card, and holds it to the
JAX test's thresholds (`chip_smoke.check_train_then_attack`). Both tests are
marked slow, as the JAX package's are. The draws come from torch generators,
so the numbers are not JAX's: the thresholds are the gate."""

import numpy as np
import pytest
import torch

import chip_smoke
from roboticattack_torch.attacks import engine
from roboticattack_torch.attacks.optimizer import cosine_schedule_with_warmup
from roboticattack_torch.models.config import VLA_TINY
from roboticattack_torch.models.vlm import init_vla_params
from roboticattack_torch.training import TrainConfig, VLATrainer

IMG = chip_smoke.BRIGHT_IMG


@pytest.mark.slow
def test_train_then_attack_flips_policy():
    result = chip_smoke.train_then_attack("cpu")
    chip_smoke.check_train_then_attack(result)


@pytest.mark.slow
def test_upa_direction_metrics_and_descent():
    """UPA on a brightness -> xyz-direction policy, as the JAX test: (a) the
    direction metrics detect a turned policy (a dark image on bright ground
    truth drops the angle and blows up the xyz distance); (b) the UPA step
    descends from a random patch on a soft (early) policy."""
    params = init_vla_params(torch.Generator().manual_seed(10), VLA_TINY)
    trainer = VLATrainer(params, VLA_TINY, TrainConfig(strategy="ddp", learning_rate=2e-3, max_steps=160,
                                                       max_grad_norm=1.0), device="cpu")
    trainer.run_training(chip_smoke.brightness_batches(8, seed=11, directional=True), num_steps=40)
    soft = torch.utils._pytree.tree_map(torch.clone, trainer.params)  # the trainer updates in place
    final_loss = trainer.run_training(chip_smoke.brightness_batches(8, seed=11, directional=True), num_steps=120)
    assert final_loss < 0.5, f"tiny model failed to learn the task: loss={final_loss}"
    trained = trainer.params

    maskidx = [0, 1, 2, 3, 4, 5, 6]
    spec = engine.AttackSpec(objective="upa", geometry=False, inner_loop=1, grad_clip_l1=1e-3)
    val = engine.make_val_step(spec, VLA_TINY, None, maskidx)
    bright_val = engine.batch_to_device(
        chip_smoke.brightness_frames(16, np.random.default_rng(12), bright=True, directional=True), "cpu")

    def draws(seed, patch_hw, batch, inner=None):
        return engine.draw_step(torch.Generator().manual_seed(seed), spec, batch.images.shape, patch_hw,
                                batch.labels.shape, inner)

    m0 = val(trained, torch.zeros((14, 14, 3)), bright_val, draws(13, (14, 14), bright_val, 1))
    clean_angle, clean_dist = m0["ex_angle"].mean().item(), m0["ex_xyz_dist"].mean().item()
    assert clean_angle > 1.95, clean_angle
    m_dark = val(trained, torch.full((IMG, IMG, 3), 0.35), bright_val, draws(14, (IMG, IMG), bright_val, 1))
    dark_angle, dark_dist = m_dark["ex_angle"].mean().item(), m_dark["ex_xyz_dist"].mean().item()
    assert dark_angle < clean_angle - 0.25, (clean_angle, dark_angle)
    assert dark_dist > clean_dist * 10, (clean_dist, dark_dist)

    step = engine.make_attack_step(spec, VLA_TINY, None, maskidx)
    state = engine.init_attack_state(torch.Generator().manual_seed(15), (IMG, IMG), "cpu")
    batches = chip_smoke.brightness_batches(8, seed=16, bright=True, directional=True)
    losses = []
    for i in range(30):
        lr = cosine_schedule_with_warmup(i, 1e-1, 3, 30)
        batch = engine.batch_to_device(next(batches), "cpu")
        state, metrics = step(soft, state, batch, lr, True, draws(17 + i, (IMG, IMG), batch))
        losses.append(metrics["loss"][-1].item())
    assert min(losses[-5:]) < losses[0] - 0.01, (losses[0], losses[-5:])

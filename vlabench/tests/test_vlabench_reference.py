"""The plain reference against the program, on small configurations of both
families on the CPU: the program's first outer step in float32 follows the
float32 reference to rounding; in bfloat16 it stays inside a cell's
limits. And the configuration files give the program the registry's own
configs."""

import dataclasses

import pytest
import torch

from roboticattack_torch.models.config import MISTRAL_7B, VLAConfig, DINOV2_VIT_L, SIGLIP_SO400M
from roboticattack_torch.models.registry import build_config

from vlabench import calibrate, run
from vlabench.common.program import vla_config
from vlabench.tests import tiny

CELLS = [("attack-uada-mistral7b-bs8", tiny.tiny_mistral), ("attack-uada-phi2-bs8", tiny.tiny_phi)]


@pytest.mark.parametrize("cell,make", CELLS, ids=["mistral", "phi"])
def test_reference_follows_the_program_in_float32(cell, make):
    cfg = make()
    cfg["dtype"] = "float32"
    got = calibrate.readings(cell, 5, False, "cpu", cfg)["program"]
    assert got["loss_gap"] < 1e-5 and got["m_norm_gap"] < 1e-4 and got["delta_norm_gap"] < 1e-4, got


@pytest.mark.parametrize("cell,make", CELLS, ids=["mistral", "phi"])
def test_bfloat16_program_within_the_cell_limits(cell, make):
    limits = run.cell_files(cell)[0]["limits"]
    got = calibrate.readings(cell, 6, False, "cpu", make())["program"]
    assert all(got[k] <= limits[k] for k in limits), (got, limits)


def test_config_files_give_the_registry_configs():
    _, mistral, _ = run.cell_files("attack-uada-mistral7b-bs8")
    _, phi, _ = run.cell_files("attack-uada-phi2-bs8")
    assert vla_config(mistral) == VLAConfig(name="vla-mistral-7b", dino=DINOV2_VIT_L, siglip=SIGLIP_SO400M,
                                            llm=MISTRAL_7B)
    assert dataclasses.replace(vla_config(phi), name="phi-2+3b") == build_config("phi-2+3b")
    assert vla_config(mistral).llm.head_dim == mistral["llm"]["head_dim"]
    assert vla_config(phi).llm.head_dim == phi["llm"]["head_dim"]


def test_reference_takes_grouped_query_heads_and_the_window():
    """Grouped-query attention repeats each key/value head over its group,
    and the sliding window hides keys further back than it reaches."""
    from vlabench.reference import vla as ref

    q = torch.randn(1, 4, 5, 8)
    k, v = torch.randn(1, 2, 5, 8), torch.randn(1, 2, 5, 8)
    out = ref.attention(ref.Precision(), q, k, v, None)
    want = ref.attention(ref.Precision(), q, k.repeat_interleave(2, 1), v.repeat_interleave(2, 1), None)
    assert torch.equal(out, want)
    i = torch.arange(5)
    mask = (i[None] <= i[:, None]) & (i[None] > i[:, None] - 2)
    got = ref.attention(ref.Precision(), q, k, v, mask)
    last = ref.attention(ref.Precision(), q[:, :, 4:], k[:, :, 3:], v[:, :, 3:], None)
    assert torch.allclose(got[:, :, 4:], last, atol=1e-6)


@pytest.mark.parametrize("seed", [5, 2**31 + 11, 2**33 - 7])
@pytest.mark.parametrize("cell", [c for c, _ in CELLS], ids=["mistral", "phi"])
def test_the_program_draws_what_the_reference_is_given(cell, seed):
    """The window takes each outer step's draws from the program's own
    `draw_step`; the reference takes them from the benchmark's copy. At the
    cell's sizes and the driver's large seeds they draw the same numbers:
    placements and scales equal, the warp matrices equal to float32
    rounding (each side composes shear and rotation by its own arithmetic)."""
    from vlabench.common import inputs

    cell_, cfg, traffic = run.cell_files(cell)
    driver = run.load_module("drivers", cell_["driver"]).Driver(cfg, traffic, cell_, seed, torch.device("cpu"))
    size = cfg["vision"]["towers"][0]["image_size"]
    for step in (0, 1, 1999):
        got = driver._draws(step)
        want = inputs.step_draws(seed, step, traffic["inner_loop"], traffic["batch_size"], size, traffic["patch"])
        assert got.coin is None and len(got.inner) == len(want)
        for g, w in zip(got.inner, want):
            assert torch.equal(g.xy, w.xy) and torch.equal(g.scale, w.scale)
            assert float((g.matrix - w.matrix).abs().max()) <= 1e-6


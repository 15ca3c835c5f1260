"""The blocks' normalisation entry (`ops/norm.layer_norm`, `rms_norm`) on the
CPU: the plain versions are the eager chains the models ran before, bit for
bit, on every dtype; each call counts `norm.calls` once and `norm.kernel` 0;
the dispatch's refusals; the row views the kernels are handed; and one
forward of each model family counts the norms its blocks hold. The kernels
themselves run on the card only (tests/test_torch_norm_cuda.py)."""

import dataclasses

import pytest
import torch

from roboticattack_torch.models import vit, vlm
from roboticattack_torch.models.vlm import init_vla_params
from roboticattack_torch.ops import norm
from roboticattack_torch.utils import profiling
from vlabench.common import program, program_moe
from vlabench.tests import tiny


def eager_layer_norm(x, scale, bias, eps):
    """`models/vit.layer_norm` as the models ran it before the entry."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    return (normed * scale.float() + bias.float()).to(x.dtype)


def eager_rms_norm(x, weight, eps):
    """`models/llama.rms_norm` as the models ran it before the entry."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = (xf * torch.rsqrt(var + eps)).to(x.dtype)
    return weight * normed


def _operands(shape, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    n = shape[-1]
    x = (3.0 * torch.randn(shape, generator=gen) + 0.5).to(dtype)
    w = (1.0 + 0.1 * torch.randn(n, generator=gen)).to(dtype)
    b = (0.1 * torch.randn(n, generator=gen)).to(dtype)
    return x, w, b


@pytest.mark.parametrize("shape", [(2, 5, 64), (7, 1152), (3, 2, 4, 40)], ids=["rows_64", "siglip_1152", "4d_40"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64], ids=["f32", "bf16", "f64"])
@pytest.mark.parametrize("kind", ["layer", "rms"])
def test_the_plain_path_is_the_old_eager_chain_bit_for_bit_and_counts_one_call(kind, dtype, shape):
    x, w, b = _operands(shape, dtype)
    with profiling.tallying() as tally:
        if kind == "layer":
            got, want = norm.layer_norm(x, w, b, 1e-6), eager_layer_norm(x, w, b, 1e-6)
        else:
            got, want = norm.rms_norm(x, w, 1e-5), eager_rms_norm(x, w, 1e-5)
    assert got.dtype == want.dtype == dtype and torch.equal(got, want)
    assert tally.counters == {"norm.calls": 1, "norm.kernel": 0}


@pytest.mark.parametrize("kind", ["layer", "rms"])
def test_the_plain_path_differentiates_as_the_old_eager_chain(kind):
    """Gradients of x and the weights through the entry on the CPU equal
    those through the old chain, bit for bit (both are the same autograd
    graph)."""
    x, w, b = _operands((4, 6, 48), torch.bfloat16, seed=1)
    dy = torch.randn((4, 6, 48), generator=torch.Generator().manual_seed(2)).to(torch.bfloat16)
    grads = []
    for fn in ((norm.layer_norm, eager_layer_norm) if kind == "layer" else (norm.rms_norm, eager_rms_norm)):
        leaves = [t.clone().requires_grad_() for t in ((x, w, b) if kind == "layer" else (x, w))]
        out = fn(*leaves, 1e-5)
        out.backward(dy)
        grads.append([t.grad for t in leaves])
    for got, want in zip(*grads):
        assert torch.equal(got, want)


def test_the_models_keep_their_names_for_the_entry():
    from roboticattack_torch import models
    from roboticattack_torch.models import llama

    assert vit.layer_norm is norm.layer_norm
    assert llama.rms_norm is models.rms_norm is norm.rms_norm


@pytest.mark.parametrize("width", [8, 32, 48, 64, 512, 1024, 1152, 2048, 2560, 4096, norm.MAX_WIDTH])
def test_the_kernels_take_bf16_rows_of_every_model_width(width):
    x, w, b = _operands((3, width), torch.bfloat16)
    assert norm.kernel_problem(x, w, b) is None and norm.kernel_problem(x, w) is None
    assert not norm.takes_kernel(x, w, b)  # never on the CPU


@pytest.mark.parametrize("case", ["f32_input", "f32_weight", "width_12", "past_max_width", "empty",
                                  "weight_shape", "scalar"])
def test_the_kernels_refuse_what_they_do_not_take(case):
    x, w, b = _operands((3, 64), torch.bfloat16)
    if case == "f32_input":
        x = x.float()
    elif case == "f32_weight":
        w = w.float()
    elif case == "width_12":
        x, w, b = _operands((3, 12), torch.bfloat16)
    elif case == "past_max_width":
        x, w, b = _operands((2, norm.MAX_WIDTH + 8), torch.bfloat16)
    elif case == "empty":
        x = x[:0]
    elif case == "weight_shape":
        w = torch.cat([w, w])
    elif case == "scalar":
        x = x[0, 0]
    assert norm.kernel_problem(x, w, b) is not None
    with pytest.raises(ValueError):
        norm.norm_fwd(x, w, b, 1e-5)


def test_the_kernels_are_handed_rows_as_they_lie_where_they_can_read_them():
    """A slice of a wider row (MLA's kv latent) goes in as a strided view of
    the same memory; rows they cannot read (an odd row stride, a
    misaligned start) as a contiguous aligned copy."""
    wide = torch.randn(2, 3, 32 + 8).to(torch.bfloat16)
    rows = norm._rows(wide[..., :32])
    assert rows.data_ptr() == wide.data_ptr() and rows.stride() == (40, 1) and rows.shape == (6, 32)
    odd = torch.randn(6, 37).to(torch.bfloat16)[:, :32]
    rows = norm._rows(odd)
    assert rows.is_contiguous() and rows.data_ptr() % 16 == 0 and torch.equal(rows, odd)
    flat = torch.randn(6 * 32 + 1).to(torch.bfloat16)
    shifted = flat[1:].view(6, 32)  # 2 bytes off 16-byte alignment
    assert shifted.data_ptr() % 16 != 0
    for got in (norm._rows(shifted), norm._aligned(shifted)):
        assert got.data_ptr() % 16 == 0 and torch.equal(got, shifted)
    w = torch.randn(64).to(torch.bfloat16)
    assert norm._aligned(w) is w


def _family(name):
    if name == "llama":
        return program.vla_config(tiny.tiny_mistral())
    if name == "phi":
        return program.vla_config(tiny.tiny_phi())
    from deepseek_tiny import tiny_moonlight

    return program_moe.vla_config(tiny_moonlight())


def _norms_of_a_forward(cfg):
    """The norms one forward of `cfg` runs: 2 a tower block run (a tower
    runs its blocks up to its tap layer, the second-to-last), plus CLIP's
    pre-norm, and per decoder block 2 (Llama), 1 (Phi's
    parallel block) or 3 (DeepSeek-V3, with MLA's kv_norm), plus the
    decoder's final norm."""
    towers = [t for t in (cfg.dino, cfg.siglip) if t is not None]
    per_block = {"LlamaConfig": 2, "PhiConfig": 1, "DeepseekV3Config": 3}[type(cfg.llm).__name__]
    return sum(2 * t.tap_layer + t.pre_norm for t in towers) + per_block * cfg.llm.num_layers + 1


@pytest.mark.parametrize("family", ["llama", "phi", "deepseek"])
def test_one_forward_of_each_family_counts_its_norms(family):
    cfg = dataclasses.replace(_family(family), remat=False)
    params = init_vla_params(torch.Generator().manual_seed(0), cfg)
    gen = torch.Generator().manual_seed(1)
    size = cfg.dino.image_size
    pixels = torch.randn((2, 2, size, size, 3), generator=gen)
    ids = torch.randint(0, 1000, (2, 6), generator=gen)
    with torch.no_grad(), profiling.tallying() as tally:
        vlm.vla_forward(params, cfg, ids, torch.ones_like(ids), pixels)
    c = tally.counters
    assert c["norm.calls"] == _norms_of_a_forward(cfg) and c["norm.kernel"] == 0
    towers = [t for t in (cfg.dino, cfg.siglip) if t is not None]
    assert c["blocks.vision"] == sum(t.tap_layer for t in towers) and c["blocks.llm"] == cfg.llm.num_layers
    assert (family == "phi") == any(t.pre_norm for t in towers)


def _flat(t):
    return t.reshape(-1, t.shape[-1]).float()


def _emulated_fwd(x, weight, bias, eps):
    """norm_fwd's arithmetic (csrc/norm.cu's header) in torch, counted as
    the wrapper counts a launch."""
    xf = _flat(x)
    if bias is None:
        mean, rstd = None, torch.rsqrt((xf * xf).mean(-1) + eps)
        y = norm.rms_norm_plain(x, weight, eps)
    else:
        mean = xf.mean(-1)
        rstd = torch.rsqrt(((xf - mean[:, None]) ** 2).mean(-1) + eps)
        y = norm.layer_norm_plain(x, weight, bias, eps)
    norm.launches["fwd"] += 1
    profiling.count("norm.kernel")
    return y, mean, rstd


def _emulated_bwd(x, dy, weight, mean, rstd):
    """norm_bwd's dx, as the header writes it."""
    xf, d, r = _flat(x), _flat(dy), rstd[:, None]
    if mean is None:
        g = (d * weight.float()).to(x.dtype).float()
        dx = g * r - xf * r**3 * (g * xf).mean(-1, keepdim=True)
    else:
        g, h = d * weight.float(), (xf - mean[:, None]) * r
        dx = r * (g - g.mean(-1, keepdim=True) - h * (g * h).mean(-1, keepdim=True))
    norm.launches["bwd"] += 1
    return dx.to(x.dtype).view(x.shape)


def _emulated_wgrad(x, dy, mean, rstd):
    """norm_wgrad's dweight and dbias, as the header writes them."""
    xf, d, r = _flat(x), _flat(dy), rstd[:, None]
    if mean is None:
        dw, db = (d * (xf * r).to(x.dtype).float()).sum(0), None
    else:
        dw, db = (d * (xf - mean[:, None]) * r).sum(0), d.sum(0).to(x.dtype)
    norm.launches["wgrad"] += 1
    return dw.to(x.dtype), db


@pytest.fixture
def emulated(monkeypatch):
    """The kernel path on the CPU: the dispatch takes every input and the
    wrappers run their kernels' arithmetic in torch, counting launches as
    on the card; the launch counts start at 0."""
    monkeypatch.setattr(norm, "takes_kernel", lambda *a: True)
    monkeypatch.setattr(norm, "norm_fwd", _emulated_fwd)
    monkeypatch.setattr(norm, "norm_bwd", _emulated_bwd)
    monkeypatch.setattr(norm, "norm_wgrad", _emulated_wgrad)
    norm.reset_launches()
    yield norm.launches
    norm.reset_launches()


@pytest.mark.parametrize("kind", ["layer", "rms"])
def test_the_kernels_backward_arithmetic_is_the_plain_chains_gradient(kind, emulated):
    """The header's dx, dweight and dbias, run through the autograd
    Function in f32, give the plain chain's autograd gradients; dx alone
    where the weights take none (the attack's)."""
    x, w, b = _operands((3, 5, 48), torch.float32, seed=3)
    dy = torch.randn((3, 5, 48), generator=torch.Generator().manual_seed(4))
    params = (w, b) if kind == "layer" else (w,)
    grads = {}
    for path in ("kernel", "plain"):
        leaves = [t.clone().requires_grad_() for t in (x, *params)]
        if path == "kernel":
            out = (norm.layer_norm if kind == "layer" else norm.rms_norm)(*leaves, 1e-5)
        else:
            out = (norm.layer_norm_plain if kind == "layer" else norm.rms_norm_plain)(*leaves, 1e-5)
        grads[path] = torch.autograd.grad(out, leaves, dy)
    for got, want in zip(grads["kernel"], grads["plain"]):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())
    assert emulated == {"fwd": 1, "bwd": 1, "wgrad": 1}
    out = (norm.layer_norm if kind == "layer" else norm.rms_norm)(x.clone().requires_grad_(), *params, 1e-5)
    out.backward(dy)
    assert emulated == {"fwd": 2, "bwd": 2, "wgrad": 1}


@pytest.mark.parametrize("family", ["llama", "phi", "deepseek"])
def test_an_attack_step_launches_every_norm_on_the_kernels(family, emulated):
    """One UADA outer step of 2 inner steps under per-block recomputation
    launches a forward for every norm it runs (2 a tower block three times,
    CLIP's pre-norm twice, each decoder block's norms twice, the final norm
    once) and a backward for every norm once; the patch is the only leaf,
    so no weight gradient."""
    from roboticattack_torch.attacks import engine
    from roboticattack_torch.attacks.optimizer import adam_init
    from vlabench.common import inputs

    inner, bs, pad_to, patch_hw = 2, 2, 32, 10
    cfg = dataclasses.replace(_family(family), remat=True)
    params = init_vla_params(torch.Generator().manual_seed(0), cfg)
    spec = engine.AttackSpec(objective="uada", inner_loop=inner, optimizer="adamW")
    size = cfg.dino.image_size
    batch = engine.batch_to_device(engine.AttackBatch(*next(inputs.batches(3, size, bs, pad_to))), "cpu")
    draws = engine.draw_step(torch.Generator().manual_seed(1), spec, (bs, size, size, 3), (patch_hw,) * 2,
                             (bs, pad_to))
    patch = inputs.initial_patch(3, patch_hw)
    state = engine.AttackState(patch=patch.clone(), opt=adam_init(patch), grad_acc=torch.zeros_like(patch))
    engine.make_attack_step(spec, cfg, None, range(7))(params, state, batch, 2e-3, True, draws)
    towers = [t for t in (cfg.dino, cfg.siglip) if t is not None]
    blocks, pre = sum(t.tap_layer for t in towers), sum(t.pre_norm for t in towers)
    per_block = {"LlamaConfig": 2, "PhiConfig": 1, "DeepseekV3Config": 3}[type(cfg.llm).__name__]
    decoder = per_block * cfg.llm.num_layers
    assert emulated == {"fwd": inner * (6 * blocks + 2 * pre + 2 * decoder + 1),
                        "bwd": inner * (2 * blocks + pre + decoder + 1), "wgrad": 0}


@pytest.mark.parametrize("frozen", [True, False], ids=["towers_frozen", "towers_trained"])
def test_a_trainer_step_launches_the_weight_gradients_of_the_trained_norms(frozen, emulated):
    """One VLATrainer step of the tiny VLA: a forward for every norm, and a
    backward and a weight-gradient launch for every norm whose weights are
    trained (the frozen towers' take neither)."""
    from roboticattack_torch.data import batch_iterator, dummy_frame_iterator
    from roboticattack_torch.models.config import VLA_TINY
    from roboticattack_torch.parallel import distributed
    from roboticattack_torch.training import TrainConfig, VLATrainer
    from roboticattack_torch.utils.prompting import WordStubTokenizer

    cfg = VLA_TINY
    params = init_vla_params(torch.Generator().manual_seed(0), cfg)
    batch = next(batch_iterator(dummy_frame_iterator(WordStubTokenizer(), image_size=cfg.dino.image_size, seed=0),
                                batch_size=2, pad_to=48))
    try:  # the trainer joins a world of one in this process: leave it for the worker's later tests
        trainer = VLATrainer(params, cfg, TrainConfig(strategy="fsdp", learning_rate=1e-3, max_steps=2,
                                                      warmup_ratio=0.0, freeze_vision_backbone=frozen), device="cpu")
        trainer.run_training(iter([batch]), 1)
    finally:
        distributed.shutdown()
    towers = 2 * (cfg.dino.tap_layer + cfg.siglip.tap_layer)
    decoder = 2 * cfg.llm.num_layers + 1
    trained = decoder + (0 if frozen else towers)
    assert not cfg.remat and type(cfg.llm).__name__ == "LlamaConfig"
    assert emulated == {"fwd": towers + decoder, "bwd": trained, "wgrad": trained}

"""The normalisation kernels (roboticattack_torch/csrc/norm.cu) against their
plain PyTorch versions, on the card: forward and backward at every
benchmark cell's norm shape, the gradients against the plain chain in f32,
bit-equal launches, a captured and replayed forward and backward, and one
trainer step of the tiny VLA against the same step with plain norms.

Every test here carries the `cuda` marker and skips where no card is
present. The file imports neither jax nor the JAX package, so it runs on a
machine that has only PyTorch (the repository's conftest imports jax, hence
`--noconftest`):

    python -m pytest tests/test_torch_norm_cuda.py -m cuda --noconftest -q
"""

import dataclasses

import pytest
import torch

from roboticattack_torch.ops import norm

# the benchmark cells' norms: [rows, width] (rows = bs 8 x the sequence)
CELL_SHAPES = {
    "dinov2": (2088, 1024),      # 8 x (256 patches + cls + 4 registers)
    "siglip": (2048, 1152),      # 8 x 256
    "clip": (4616, 1024),        # 8 x (576 + cls)
    "phi2": (4864, 2560),        # 8 x 608
    "mistral": (2304, 4096),     # 8 x 288
    "moonlight": (2304, 2048),
    "mla_kv_norm": (2304, 512),
}
# ragged row counts (a block's last row groups past the end) and the other widths the port runs
OTHER_SHAPES = {"ragged_1152": (7, 1152), "ragged_2560": (5, 2560), "ragged_4096": (3, 4096),
                "one_row": (1, 1024), "llama13b": (9, 5120), "tiny_32": (6, 32), "tiny_48": (10, 48),
                "tiny_64": (13, 64)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _operands(rows, n, device, seed=0):
    """bf16 x [rows, n] (a mean and scale that differ by row), weight, bias
    and dy."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((rows, n), generator=gen, device=device) * torch.rand((rows, 1), generator=gen, device=device)
    x = (3.0 * x + torch.randn((rows, 1), generator=gen, device=device)).to(torch.bfloat16)
    w = (1.0 + 0.2 * torch.randn(n, generator=gen, device=device)).to(torch.bfloat16)
    b = (0.2 * torch.randn(n, generator=gen, device=device)).to(torch.bfloat16)
    dy = torch.randn((rows, n), generator=gen, device=device).to(torch.bfloat16)
    return x, w, b, dy


def _close(got, want):
    """Both sides sum in f32 in different orders and round to bf16: within a
    couple of bf16 ulps (2^-8 relative) of the largest value, as the B1/B2
    tests."""
    assert torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2**-7 * want.float().abs().max().item(), err


def _entry(kind, x, w, b):
    return norm.layer_norm(x, w, b, 1e-5) if kind == "layer" else norm.rms_norm(x, w, 1e-5)


def _plain(kind, x, w, b):
    return norm.layer_norm_plain(x, w, b, 1e-5) if kind == "layer" else norm.rms_norm_plain(x, w, 1e-5)


def _grads(fn, kind, x, w, b, dy):
    """(y, dx, dw, db) of fn through autograd, every operand a leaf (x as
    it lies: a strided view stays one); db is None for RMSNorm."""
    leaves = [t.detach().requires_grad_() for t in (x, w, b)]
    y = fn(kind, *leaves)
    y.backward(dy)
    return (y.detach(), *(t.grad for t in leaves))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(CELL_SHAPES.values()) + list(OTHER_SHAPES.values()),
                         ids=list(CELL_SHAPES) + list(OTHER_SHAPES))
@pytest.mark.parametrize("kind", ["layer", "rms"])
def test_forward_and_backward_against_the_plain_chain(kind, shape, cuda):
    """The entry's y and dx (the kernels') against the plain chain's, both
    in bf16, launches counted."""
    x, w, b, dy = _operands(*shape, cuda)
    assert norm.takes_kernel(x, w, b)
    before = dict(norm.launches)
    xg = x.clone().requires_grad_()
    y = _entry(kind, xg, w, b)
    y.backward(dy)
    torch.cuda.synchronize()
    assert norm.launches == {**before, "fwd": before["fwd"] + 1, "bwd": before["bwd"] + 1}
    xp = x.clone().requires_grad_()
    yp = _plain(kind, xp, w, b)
    yp.backward(dy)
    assert y.dtype == torch.bfloat16 and y.shape == x.shape
    _close(y, yp)
    _close(xg.grad, xp.grad)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["odd_width", "past_max_width", "f32_weight", "f16_input"])
@pytest.mark.parametrize("kind", ["layer", "rms"])
def test_the_entry_raises_on_the_card_for_rows_the_kernels_do_not_take(kind, case, cuda):
    """On the card only f32 and f64 input take the plain chain; any other
    input the kernels refuse raises with their reason, and launches
    nothing."""
    n = {"odd_width": 1004, "past_max_width": norm.MAX_WIDTH + 8}.get(case, 1024)
    x, w, b, _ = _operands(5, n, cuda)
    if case == "f32_weight":
        w = w.float()
    elif case == "f16_input":
        x = x.half()
    before = dict(norm.launches)
    with pytest.raises(ValueError, match="the CUDA norm kernels take"):
        _entry(kind, x, w, b)
    assert norm.launches == before
    got = _entry(kind, x.float(), w.float(), b.float())
    assert norm.launches == before and torch.equal(got, _plain(kind, x.float(), w.float(), b.float()))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["layer", "rms"])
def test_the_entry_runs_the_kernel_under_inference_mode(kind, cuda):
    """Serving's decode calls the entry under torch.inference_mode: the
    kernel runs there too and gives what it gives with autograd on."""
    x, w, b, _ = _operands(*CELL_SHAPES["mistral"], cuda, seed=5)
    before = norm.launches["fwd"]
    with torch.inference_mode():
        y = _entry(kind, x, w, b)
    assert norm.launches["fwd"] == before + 1 and not y.requires_grad
    assert torch.equal(y, _entry(kind, x.clone().requires_grad_(), w, b).detach())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(CELL_SHAPES.values()) + [OTHER_SHAPES["ragged_2560"], OTHER_SHAPES["tiny_48"]],
                         ids=list(CELL_SHAPES) + ["ragged_2560", "tiny_48"])
@pytest.mark.parametrize("kind", ["layer", "rms"])
def test_gradients_against_the_plain_chain_in_f32(kind, shape, cuda):
    """dx, dweight (and dbias) of the kernels, weights requiring grad as in
    the trainer, against the plain chain's autograd on the same values in
    f32."""
    x, w, b, dy = _operands(*shape, cuda, seed=1)
    before = norm.launches["wgrad"]
    got = _grads(_entry, kind, x, w, b, dy)
    assert norm.launches["wgrad"] == before + 1
    want = _grads(_plain, kind, x.float(), w.float(), b.float(), dy.float())
    for g, v in zip(got, want):
        if v is not None:
            assert g.dtype == torch.bfloat16
            _close(g, v)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [CELL_SHAPES["phi2"], CELL_SHAPES["mistral"], OTHER_SHAPES["ragged_1152"]],
                         ids=["phi2", "mistral", "ragged_1152"])
@pytest.mark.parametrize("kind", ["layer", "rms"])
def test_two_launches_are_bit_equal(kind, shape, cuda):
    """Fixed-order sums, no atomics: y, the statistics, dx and the weight
    gradients equal to the bit from launch to launch."""
    x, w, b, dy = _operands(*shape, cuda, seed=2)
    bias = b if kind == "layer" else None
    runs = []
    for _ in range(2):
        y, mean, rstd = norm.norm_fwd(x, w, bias, 1e-5)
        dx = norm.norm_bwd(x, dy, w, mean, rstd)
        dw, db = norm.norm_wgrad(x, dy, mean, rstd)
        runs.append([t for t in (y, mean, rstd, dx, dw, db) if t is not None])
    torch.cuda.synchronize()
    assert all(torch.equal(p, q) for p, q in zip(*runs))


@pytest.mark.cuda
def test_a_slice_of_a_wider_row_is_read_in_place(cuda):
    """MLA's kv latent: the first 512 columns of a [rows, 576] projection go
    in as a strided view, and give what the contiguous copy gives."""
    wide = torch.randn((2304, 576), device=cuda).to(torch.bfloat16)
    _, w, _, dy = _operands(2304, 512, cuda)
    view = wide[:, :512]
    assert norm._rows(view).data_ptr() == wide.data_ptr()
    a = _grads(_entry, "rms", view, w, w, dy)
    c = _grads(_entry, "rms", view.contiguous(), w, w, dy)
    torch.cuda.synchronize()
    assert all(torch.equal(p, q) for p, q in zip(a[:3], c[:3]))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["layer", "rms"])
def test_a_captured_forward_and_backward_replays_bit_equal_to_eager(kind, cuda):
    """The forward and the backward (dx and, the weights requiring grad, the
    weight gradients) captured in one CUDA graph and replayed on new input
    give what the eager calls give, to the bit; the replay launches nothing
    from the host."""
    rows, n = CELL_SHAPES["mistral"] if kind == "rms" else CELL_SHAPES["clip"]
    x, w, b, dy = _operands(rows, n, cuda, seed=3)
    xs, dys = x.clone(), dy.clone()
    wl, bl = w.clone().requires_grad_(), b.clone().requires_grad_()

    def step():
        xg = xs.detach().requires_grad_()
        y = _entry(kind, xg, wl, bl)
        params = (wl, bl) if kind == "layer" else (wl,)
        return (y, *torch.autograd.grad(y, (xg, *params), dys))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()  # warm up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = step()
    x2, _, _, dy2 = _operands(rows, n, cuda, seed=4)
    xs.copy_(x2)
    dys.copy_(dy2)
    before = dict(norm.launches)
    graph.replay()
    torch.cuda.synchronize()
    assert norm.launches == before
    eager = step()
    torch.cuda.synchronize()
    assert all(torch.equal(p, q) for p, q in zip(outs, eager))


@pytest.mark.cuda
def test_a_trainer_step_with_the_kernels_against_plain_norms(cuda, monkeypatch):
    """One VLATrainer step of the tiny VLA in bf16 (every norm's weights
    trained): the loss within 1e-2 relative, each gradient's cosine to the
    plain norms' at least 0.99, and the kernels' weight-gradient pass run.
    Leaves whose gradient is under a billionth of the largest leaf's are
    left out: the first tower's norms get ~1e-9 against the projector's
    ~17, below the rounding of the step's sums, where the plain chain in
    bf16 and the same step in f32 agree no better (cosine ~0.01 on the
    CPU)."""
    from roboticattack_torch.data import batch_iterator, dummy_frame_iterator
    from roboticattack_torch.models.config import VLA_TINY
    from roboticattack_torch.models.vlm import init_vla_params
    from roboticattack_torch.parallel import distributed
    from roboticattack_torch.training import TrainConfig, VLATrainer
    from roboticattack_torch.utils.prompting import WordStubTokenizer

    cfg = dataclasses.replace(VLA_TINY, dtype="bfloat16")
    params = init_vla_params(torch.Generator().manual_seed(0), cfg)
    batch = next(batch_iterator(dummy_frame_iterator(WordStubTokenizer(), image_size=56, seed=0),
                                batch_size=8, pad_to=48))
    tcfg = TrainConfig(strategy="ddp", learning_rate=5e-3, max_steps=2, warmup_ratio=0.0, seed=0,
                       freeze_vision_backbone=False)
    results = {}
    try:  # each trainer joins a world of one in this process: leave it for the later tests
        for kernels in (True, False):
            with monkeypatch.context() as m:
                if not kernels:
                    m.setattr(norm, "takes_kernel", lambda *a: False)
                trainer = VLATrainer(_clone(params), cfg, tcfg, device="cuda")
                before = norm.launches["wgrad"]
                loss, grads = trainer.compute_grads(trainer.place(batch))
                torch.cuda.synchronize()
                assert (norm.launches["wgrad"] > before) == kernels
                results[kernels] = float(loss), grads
    finally:
        distributed.shutdown()
    (loss_k, grads_k), (loss_p, grads_p) = results[True], results[False]
    assert abs(loss_k - loss_p) <= 1e-2 * abs(loss_p)
    assert grads_k.keys() == grads_p.keys()
    stacked = {k: {p: (torch.stack(g) if isinstance(g, list) else g).float() for p, g in grads.items()}
               for k, grads in ((True, grads_k), (False, grads_p))}
    floor = 1e-9 * max(g.norm().item() for g in stacked[False].values())
    held = [p for p, g in stacked[False].items() if g.norm().item() > floor]
    assert any("ln1_scale" in p for p in held) and any("attn_norm" in p for p in held)
    for path in held:
        gk, gp = stacked[True][path], stacked[False][path]
        cos = torch.nn.functional.cosine_similarity(gk.flatten(), gp.flatten(), dim=0).item()
        assert cos >= 0.99, (path, cos)


def _clone(tree):
    """A deep copy of a parameter tree (the trainer updates its tensors)."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone() if isinstance(tree, torch.Tensor) else tree

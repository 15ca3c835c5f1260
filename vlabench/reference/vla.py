"""Plain PyTorch reference of the attacked VLA, in float32 with TF32 off.

It follows the published descriptions and the configuration file alone:
the patch paste, affine warp and composite; the per-tower image
normalization; the vision towers (DINOv2 with register tokens and
LayerScale, SigLIP, CLIP with pre-norm and quick-GELU), tapped at the
second-to-last block; the MLP projector (fused 3-layer or single 2-layer);
the decoder (Llama-family: RMSNorm, rotary, grouped-query attention,
sliding window, SwiGLU; or Phi-2: LayerNorm, partial rotary, parallel
attention and MLP, biases); the UADA objective; its gradient with respect
to the patch pixels; and the AdamW update of the patch.

The weights are the benchmark's own draw, in the nested layout the
program takes (stacked [L, ...] input-major stacks); every leaf is read in
its stored dtype and cast to float32 where it is used, one block at a time,
and each block is recomputed in the backward, so the reference fits beside
the weights. It imports nothing of the program.

`Precision` is where the control enters: `fp8=True` rounds both operands of
every matrix product to float8 e4m3 (a per-tensor scale) before an f32
product, the precision step below the configuration's bfloat16. The
backward's products read the rounded operands; the gradients themselves
stay float32.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

DINO_MEAN = (0.484375, 0.455078125, 0.40625)
DINO_STD = (0.228515625, 0.2236328125, 0.224609375)
SIGLIP_MEAN = SIGLIP_STD = (0.5, 0.5, 0.5)
ACTION_MIN, ACTION_ZERO, ACTION_BEGIN, N_BINS = 31744, 31872, 31743, 256
IGNORE = -100


@dataclass(frozen=True)
class Precision:
    fp8: bool = False

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if not self.fp8:
            return x
        # rounded in the forward; the backward's products then read the
        # rounded operands, and the gradient passes the rounding as it is
        scale = x.detach().abs().amax().clamp_min(1e-12) / 448.0
        rounded = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        return x + (rounded - x.detach())

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.q(a) @ self.q(b)


@contextlib.contextmanager
def float32_exact():
    """TF32 off for the reference's products (and back as it was after)."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def layer_norm(x, w, b, eps):
    return F.layer_norm(x, (x.shape[-1],), w.float(), b.float(), eps)


def rms_norm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def attention(pr: Precision, q, k, v, mask):
    """q [B, H, S, d], k/v [B, Hkv, S, d]; mask bool [.., S, S] (True = may
    attend) or None."""
    if k.shape[1] != q.shape[1]:
        rep = q.shape[1] // k.shape[1]
        k, v = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
    scores = pr.mm(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if mask is not None:
        scores = scores.masked_fill(~mask, float("-inf"))
    return pr.mm(torch.softmax(scores, dim=-1), v)


# ----------------------------------------------------------------- patch


def paste(patch, x: int, y: int, size: int, fill: float = -100.0):
    ph, pw, c = patch.shape
    x, y = min(max(x, 0), size - pw), min(max(y, 0), size - ph)
    left = torch.full((ph, x, c), fill, device=patch.device)
    right = torch.full((ph, size - x - pw, c), fill, device=patch.device)
    row = torch.cat([left, patch, right], dim=1)
    top = torch.full((y, size, c), fill, device=patch.device)
    bottom = torch.full((size - y - ph, size, c), fill, device=patch.device)
    return torch.cat([top, row, bottom], dim=0)


def warp(canvas, m):
    """Bilinear sampling of `canvas` [H, W, C] at the normalized input
    coordinates that the 3x3 matrix `m` maps each output pixel centre to
    (align_corners=False), coordinates clamped to the border."""
    h, w, _ = canvas.shape
    xs = (2.0 * torch.arange(w, device=canvas.device) + 1.0) / w - 1.0
    ys = (2.0 * torch.arange(h, device=canvas.device) + 1.0) / h - 1.0
    gx = m[0, 0] * xs[None, :] + m[0, 1] * ys[:, None] + m[0, 2]
    gy = m[1, 0] * xs[None, :] + m[1, 1] * ys[:, None] + m[1, 2]
    ix = (((gx + 1.0) * w - 1.0) / 2.0).clamp(0.0, w - 1.0)
    iy = (((gy + 1.0) * h - 1.0) / 2.0).clamp(0.0, h - 1.0)
    x0, y0 = ix.floor(), iy.floor()
    wx, wy = (ix - x0)[..., None], (iy - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    x1, y1 = (x0 + 1).clamp(max=w - 1), (y0 + 1).clamp(max=h - 1)
    top = canvas[y0, x0] * (1 - wx) + canvas[y0, x1] * wx
    bottom = canvas[y1, x0] * (1 - wx) + canvas[y1, x1] * wx
    return top * (1 - wy) + bottom * wy


def patched_images(images, patch, xy, matrices):
    """Each image with the patch pasted at its (x, y), warped by its matrix,
    and composited where the warped canvas is not the fill (< -20)."""
    size = images.shape[1]
    out = []
    for i in range(images.shape[0]):
        canvas = warp(paste(patch, int(xy[i][0]), int(xy[i][1]), size), matrices[i].float())
        out.append(torch.where(canvas < -20.0, images[i], canvas))
    return torch.stack(out)


def normalize(images, mean, std):
    return (images - torch.tensor(mean, device=images.device)) / torch.tensor(std, device=images.device)


# ----------------------------------------------------------------- vision


def vit_block(pr: Precision, t: Dict, p: Dict, li: int, x):
    b, s, d = x.shape
    h = t["num_heads"]
    y = layer_norm(x, p["ln1_scale"][li], p["ln1_bias"][li], t["ln_eps"])
    qkv = (pr.mm(y, p["qkv_w"][li].float()) + p["qkv_b"][li].float()).reshape(b, s, 3, h, d // h)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    a = attention(pr, q, k, v, None).transpose(1, 2).reshape(b, s, d)
    a = pr.mm(a, p["proj_w"][li].float()) + p["proj_b"][li].float()
    if t["layerscale"]:
        a = a * p["ls1"][li].float()
    x = x + a
    y = layer_norm(x, p["ln2_scale"][li], p["ln2_bias"][li], t["ln_eps"])
    y = pr.mm(y, p["fc1_w"][li].float()) + p["fc1_b"][li].float()
    y = y * torch.sigmoid(1.702 * y) if t["quick_gelu"] else F.gelu(y)
    y = pr.mm(y, p["fc2_w"][li].float()) + p["fc2_b"][li].float()
    if t["layerscale"]:
        y = y * p["ls2"][li].float()
    return x + y


def vit(pr: Precision, t: Dict, p: Dict, images):
    """images [B, H, W, 3] normalized -> the patch tokens of the
    second-to-last block [B, N, D]: depth - 1 blocks run."""
    b, hgt, _, c = images.shape
    ps = t["patch_size"]
    g = hgt // ps
    x = images.reshape(b, g, ps, g, ps, c).permute(0, 1, 3, 2, 4, 5).reshape(b, g * g, ps * ps * c)
    x = pr.mm(x, p["patch_embed"]["kernel"].float())
    if "bias" in p["patch_embed"]:
        x = x + p["patch_embed"]["bias"].float()
    x = x + p["pos_embed"].float()
    prefix = []
    if t["cls"]:
        prefix.append(p["cls_token"].float().expand(b, 1, -1))
    if t["num_reg_tokens"]:
        prefix.append(p["reg_tokens"].float().expand(b, t["num_reg_tokens"], -1))
    x = torch.cat(prefix + [x], dim=1)
    if t["pre_norm"]:
        x = layer_norm(x, p["norm_pre"]["scale"], p["norm_pre"]["bias"], t["ln_eps"])
    blocks = p["blocks"]
    for li in range(t["depth"] - 1):
        x = checkpoint(vit_block, pr, t, blocks, li, x, use_reentrant=False)
    return x[:, int(t["cls"]) + t["num_reg_tokens"]:]


def projector(pr: Precision, p: Dict, feats):
    x = F.gelu(pr.mm(feats, p["fc1_w"].float()) + p["fc1_b"].float())
    x = pr.mm(x, p["fc2_w"].float()) + p["fc2_b"].float()
    if "fc3_w" in p:
        x = pr.mm(F.gelu(x), p["fc3_w"].float()) + p["fc3_b"].float()
    return x


def visual_tokens(pr: Precision, cfg: Dict, params: Dict, images):
    """images [B, H, W, 3] in [0, 1] -> projected patch tokens [B, N, D]:
    the first tower sees DINO-normalized pixels, a second SigLIP-normalized
    ones, and their features are concatenated."""
    towers = cfg["vision"]["towers"]
    norms = [(DINO_MEAN, DINO_STD), (SIGLIP_MEAN, SIGLIP_STD)]
    names = ["dino", "siglip"]
    feats = [vit(pr, t, params["vision"][names[i]], normalize(images, *norms[i])) for i, t in enumerate(towers)]
    return projector(pr, params["projector"], torch.cat(feats, dim=-1))


# ----------------------------------------------------------------- decoders


def rope(x, pos, dim: int, theta: float):
    """Rotary embedding (non-interleaved halves) on the first `dim`
    channels of x [B, H, S, hd]; the rest pass through."""
    inv = 1.0 / theta ** (torch.arange(0, dim, 2, device=x.device, dtype=torch.float32) / dim)
    ang = pos.float()[:, None] * inv[None]
    cos, sin = torch.cat([ang, ang], -1).cos(), torch.cat([ang, ang], -1).sin()
    r, rest = x[..., :dim], x[..., dim:]
    rot = torch.cat([-r[..., dim // 2:], r[..., : dim // 2]], dim=-1)
    return torch.cat([r * cos + rot * sin, rest], dim=-1)


def llama_block(pr: Precision, c: Dict, p: Dict, li: int, x, mask, pos):
    b, s, _ = x.shape
    h, hkv, hd = c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"]
    y = rms_norm(x, p["attn_norm"][li], c["rms_norm_eps"])
    q = pr.mm(y, p["q_w"][li].float()).reshape(b, s, h, hd).transpose(1, 2)
    k = pr.mm(y, p["k_w"][li].float()).reshape(b, s, hkv, hd).transpose(1, 2)
    v = pr.mm(y, p["v_w"][li].float()).reshape(b, s, hkv, hd).transpose(1, 2)
    q, k = rope(q, pos, hd, c["rope_theta"]), rope(k, pos, hd, c["rope_theta"])
    a = attention(pr, q, k, v, mask).transpose(1, 2).reshape(b, s, h * hd)
    x = x + pr.mm(a, p["o_w"][li].float())
    y = rms_norm(x, p["mlp_norm"][li], c["rms_norm_eps"])
    g = F.silu(pr.mm(y, p["gate_w"][li].float())) * pr.mm(y, p["up_w"][li].float())
    return x + pr.mm(g, p["down_w"][li].float())


def phi_block(pr: Precision, c: Dict, p: Dict, li: int, x, mask, pos):
    b, s, d = x.shape
    h = c["num_attention_heads"]
    hd = d // h
    rot = int(hd * c["partial_rotary_factor"])
    y = layer_norm(x, p["ln_scale"][li], p["ln_bias"][li], c["layer_norm_eps"])

    def heads(n):
        return (pr.mm(y, p[f"{n}_w"][li].float()) + p[f"{n}_b"][li].float()).reshape(b, s, h, hd).transpose(1, 2)

    q, k = rope(heads("q"), pos, rot, c["rope_theta"]), rope(heads("k"), pos, rot, c["rope_theta"])
    a = attention(pr, q, k, heads("v"), mask).transpose(1, 2).reshape(b, s, d)
    a = pr.mm(a, p["o_w"][li].float()) + p["o_b"][li].float()
    m = F.gelu(pr.mm(y, p["fc1_w"][li].float()) + p["fc1_b"][li].float(), approximate="tanh")
    m = pr.mm(m, p["fc2_w"][li].float()) + p["fc2_b"][li].float()
    return x + a + m


def text_logits(pr: Precision, cfg: Dict, params: Dict, input_ids, attention_mask, vis):
    """The multimodal sequence [BOS, visual tokens, text tokens 1..] through
    the decoder -> f32 logits of the text region [B, T, V]."""
    c, llm = cfg["llm"], params["llm"]
    emb = llm["embed"][input_ids].float()
    x = torch.cat([emb[:, :1], vis, emb[:, 1:]], dim=1)
    b, s, _ = x.shape
    keep = torch.cat([attention_mask[:, :1], torch.ones(vis.shape[:2], dtype=attention_mask.dtype,
                                                           device=vis.device), attention_mask[:, 1:]], 1).bool()
    i = torch.arange(s, device=x.device)
    allowed = i[None, :] <= i[:, None]
    window = c.get("sliding_window")
    if window:
        allowed = allowed & (i[None, :] > i[:, None] - window)
    mask = allowed[None, None] & keep[:, None, None, :]
    block = phi_block if c["family"] == "phi" else llama_block
    for li in range(c["num_hidden_layers"]):
        x = checkpoint(block, pr, c, llm["layers"], li, x, mask, i, use_reentrant=False)
    x = x[:, s - input_ids.shape[1]:]
    if c["family"] == "phi":
        x = layer_norm(x, llm["norm"]["scale"], llm["norm"]["bias"], c["layer_norm_eps"])
        return pr.mm(x, llm["lm_head"]["w"].float()) + llm["lm_head"]["b"].float()
    return pr.mm(rms_norm(x, llm["norm"], c["rms_norm_eps"]), llm["lm_head"].float())


# ----------------------------------------------------------------- objective


def uada_loss(logits, labels, mse_weight: float = 5.0):
    """UADA on every action dimension: the action-slice expectation's
    squared distance from the far end of the label's half, plus 1 / CE.
    Position j of the text logits predicts label j + 1."""
    sl, gt = logits[:, :-1], labels[:, 1:]
    valid = gt != IGNORE
    logp = torch.log_softmax(sl, dim=-1)
    nll = -torch.gather(logp, -1, torch.where(valid, gt, 0)[..., None])[..., 0]
    ce = (nll * valid).sum() / valid.sum()
    act = gt > ACTION_BEGIN
    probs = torch.softmax(sl[..., ACTION_MIN:ACTION_MIN + N_BINS], dim=-1)
    expectation = (probs * torch.arange(1, N_BINS + 1, device=sl.device) / N_BINS).sum(-1)
    hard = torch.where(gt > ACTION_ZERO, 0.0, 1.0)
    mse = (((mse_weight * expectation - mse_weight * hard) ** 2) * act).sum() / act.sum()
    return mse + 1.0 / ce


def adamw(patch, grad, m, v, t: int, lr: float, b1=0.9, b2=0.999, eps=1e-6):
    """One AdamW step (bias-corrected step size, eps outside the root, no
    weight decay), then the clamp to [0, 1]."""
    m = b1 * m + (1 - b1) * grad
    v = b2 * v + (1 - b2) * grad * grad
    step = lr * math.sqrt(1 - b2 ** t) / (1 - b1 ** t)
    return (patch - step * m / (v.sqrt() + eps)).clamp(0.0, 1.0), m, v


@dataclass
class AttackTrace:
    losses: List[float]
    patch: torch.Tensor
    m: torch.Tensor
    v: torch.Tensor


def attack_steps(cfg: Dict, params: Dict, batch, patch0: torch.Tensor, draws, lr: float,
                 device, precision: Precision = Precision(), rows: Optional[int] = None) -> AttackTrace:
    """The patch attack from `patch0` through one inner step per entry of
    `draws` on one batch (host arrays), at learning rate `lr`. `rows` keeps
    the batch's first rows only (a fault planted in the reference)."""
    n = batch.images.shape[0] if rows is None else rows
    images = torch.as_tensor(batch.images[:n], device=device)
    ids = torch.as_tensor(batch.input_ids[:n], device=device)
    mask = torch.as_tensor(batch.attention_mask[:n], device=device)
    labels = torch.as_tensor(batch.labels[:n], device=device)
    patch = patch0.to(device=device, dtype=torch.float32)
    m, v = torch.zeros_like(patch), torch.zeros_like(patch)
    losses = []
    with float32_exact():
        for t, d in enumerate(draws, start=1):
            p = patch.detach().requires_grad_(True)
            imgs = patched_images(images, p, d.xy[:n].tolist(), d.matrix[:n].to(device))
            loss = uada_loss(text_logits(precision, cfg, params, ids, mask,
                                         visual_tokens(precision, cfg, params, imgs)), labels)
            (grad,) = torch.autograd.grad(loss, p)
            losses.append(float(loss.detach()))
            patch, m, v = adamw(patch, grad, m, v, t, lr)
    return AttackTrace(losses, patch.detach(), m, v)

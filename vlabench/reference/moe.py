"""Plain PyTorch reference of the attacked VLA with a DeepSeek-V3 decoder
(multi-head latent attention, a dense first layer, sparse experts with
shared experts), in float32 with TF32 off.

The decoder follows the model's own `modeling_deepseek.py` (DeepSeek-V3)
and the configuration file alone: RMSNorm; the latent attention without a
query compression (q = y W_q; [c, k_pe] = y W_kv_a; [k_nope, v] =
RMSNorm(c) W_kv_b; the rotary part in DeepSeek's interleaved channel
order, one rotary key for every head; softmax scale (nope + rope)^-0.5);
the dense SwiGLU of the first layers; in the others the sigmoid router,
the top-k choice on the scores plus the correction bias, the chosen
unbiased scores normalized and scaled by routed_scaling_factor, the routed
SwiGLU experts and the shared ones. The towers, projector, patch ops,
objective and AdamW are `reference/vla.py`'s.

The weights are the benchmark's own draw in the program's layout
(`layers` stacked over every layer, `dense` and `moe` over their layers,
the experts as [E, ...] stacks); each block's weights are cast to float32
where they are used, an expert's one expert at a time, and each block is
recomputed in the backward, so the reference fits beside the weights. It
imports nothing of the program.

The expert choice is an input of the comparison, as the batch and the
draws are: `attack_steps` takes the program's choice of each sparse layer
and inner step (`routes`) and runs its experts on it, with weights from
its own float32 scores. A bfloat16 program and this float32 reference
pick a different sixth expert for tokens near a tie, and each such token
changes the next layer's input; with the choice shared the two compare the
experts' arithmetic alone. The choice is checked on its own: at the first
sparse layer, whose input the two compute alike but for rounding, the
reference also makes its own choice (`chosen`), and `route_miss` is the
share of tokens whose experts differ from the program's there.

Departures from the published code, none of which changes the function:
- the experts run as a loop over the experts, each on the tokens that
  chose it (`index_select`, then `index_add` of its weighted output), where
  `moe_infer` sorts the tokens by expert; the float32 sums run in another
  order;
- given `routes`, the experts run on the program's choice (above);
- the group-limited step of `noaux_tc` is left out: with n_group =
  topk_group = 1 it keeps every expert (`check_implemented` refuses other
  values, and every other variant Moonlight does not use);
- no KV cache, no dropout, no auxiliary loss (inference code).

`Precision` is the control, as in `vla.py`: every matrix product's
operands rounded to float8 e4m3, the router's included. `fault` plants a
fault of the sparse-expert layer in the reference: "no_shared_experts"
leaves the shared experts out, "routed_scale_1" takes routed_scaling_factor
as 1, "unbiased_routing" chooses without the correction bias (its own
choice; on given routes the experts run as given).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from vlabench.reference.vla import (AttackTrace, Precision, adamw, attention, float32_exact, patched_images, rms_norm,
                                    rope, uada_loss, visual_tokens)

FAULTS = ("no_shared_experts", "routed_scale_1", "unbiased_routing")
# the attention and routing variants implemented here and in the program (Moonlight's)
IMPLEMENTED = {"model_type": "deepseek_v3", "q_lora_rank": None, "scoring_func": "sigmoid",
               "topk_method": "noaux_tc", "n_group": 1, "topk_group": 1, "norm_topk_prob": True,
               "moe_layer_freq": 1, "hidden_act": "silu", "attention_bias": False, "tie_word_embeddings": False}


@dataclass
class MoeTrace(AttackTrace):
    """`AttackTrace` with the reference's own expert choice at the first
    sparse layer, one [T, k] an inner step (on the CPU)."""

    chosen: List[torch.Tensor] = field(default_factory=list)


def check_implemented(cfg: Dict) -> None:
    """ValueError where the configuration asks for a variant not implemented."""
    other = {k: cfg.get(k) for k, v in IMPLEMENTED.items() if cfg.get(k) != v}
    if other:
        raise ValueError(f"{cfg.get('name')}: {other} is not implemented (implemented: {IMPLEMENTED})")


def halves(x):
    """DeepSeek's interleaved rotary channels (pairs 0-1, 2-3, ...) as
    rotate_half's halves (`view(..., d/2, 2).transpose(-1, -2)`)."""
    *lead, d = x.shape
    return x.reshape(*lead, d // 2, 2).transpose(-1, -2).reshape(*lead, d)


def latent_attention(pr: Precision, c: Dict, p: Dict, li: int, x, mask, pos):
    b, s, _ = x.shape
    h, dn, dr, dv = c["num_attention_heads"], c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
    rank, eps = c["kv_lora_rank"], c["rms_norm_eps"]
    y = rms_norm(x, p["attn_norm"][li], eps)
    q = pr.mm(y, p["q_w"][li].float()).reshape(b, s, h, dn + dr).transpose(1, 2)
    kv_a = pr.mm(y, p["kv_a_w"][li].float())
    kv = pr.mm(rms_norm(kv_a[..., :rank], p["kv_norm"][li], eps), p["kv_b_w"][li].float())
    kv = kv.reshape(b, s, h, dn + dv).transpose(1, 2)
    q_pe = rope(halves(q[..., dn:]), pos, dr, c["rope_theta"])
    k_pe = rope(halves(kv_a[..., rank:])[:, None], pos, dr, c["rope_theta"])
    q = torch.cat([q[..., :dn], q_pe], dim=-1)
    k = torch.cat([kv[..., :dn], k_pe.expand(b, h, s, dr)], dim=-1)
    a = attention(pr, q, k, kv[..., dn:], mask).transpose(1, 2).reshape(b, s, h * dv)
    return x + pr.mm(a, p["o_w"][li].float())


def swiglu(pr: Precision, y, gate_w, up_w, down_w):
    return pr.mm(F.silu(pr.mm(y, gate_w.float())) * pr.mm(y, up_w.float()), down_w.float())


def sparse_experts(pr: Precision, c: Dict, m: Dict, li: int, y, fault: Optional[str], given=None,
                   seen: Optional[Dict] = None):
    """The routed experts' sum for y [T, D]: each expert on the tokens that
    chose it, weighted by their normalized, scaled scores. The choice is
    `given` ([T, k]) where there is one, else this layer's own; the own
    choice of the first sparse layer goes to `seen[0]`."""
    scores = torch.sigmoid(pr.mm(y, m["router_w"][li].float()))
    bias = 0.0 if fault == "unbiased_routing" else m["e_bias"][li].float()
    own = torch.topk(scores.detach() + bias, c["num_experts_per_tok"], dim=-1).indices
    if seen is not None and li == 0:
        seen.setdefault(0, own)  # the forward's (a recomputation chooses alike)
    idx = own if given is None else given
    w = scores.gather(-1, idx)
    scale = 1.0 if fault == "routed_scale_1" else c["routed_scaling_factor"]
    w = w / (w.sum(dim=-1, keepdim=True) + 1e-20) * scale
    out = torch.zeros_like(y)
    for e in range(c["n_routed_experts"]):
        hit = idx == e
        tokens = hit.any(dim=-1).nonzero()[:, 0]
        if tokens.numel() == 0:
            continue
        ye = y.index_select(0, tokens)
        we = (w * hit).sum(dim=-1).index_select(0, tokens)
        ge = swiglu(pr, ye, m["gate_w"][li][e], m["up_w"][li][e], m["down_w"][li][e])
        out = out.index_add(0, tokens, ge * we[:, None])
    return out


def block(pr: Precision, c: Dict, p: Dict, li: int, x, mask, pos, fault: Optional[str], given=None,
          seen: Optional[Dict] = None):
    layers = p["layers"]
    x = latent_attention(pr, c, layers, li, x, mask, pos)
    y = rms_norm(x, layers["mlp_norm"][li], c["rms_norm_eps"])
    first = c["first_k_dense_replace"]
    if li < first:
        d = p["dense"]
        return x + swiglu(pr, y, d["gate_w"][li], d["up_w"][li], d["down_w"][li])
    m, j = p["moe"], li - first
    b, s, dim = y.shape
    out = sparse_experts(pr, c, m, j, y.reshape(b * s, dim), fault, given, seen).reshape(b, s, dim)
    if fault != "no_shared_experts":
        out = out + swiglu(pr, y, m["shared_gate_w"][j], m["shared_up_w"][j], m["shared_down_w"][j])
    return x + out


def text_logits(pr: Precision, cfg: Dict, params: Dict, input_ids, attention_mask, vis, fault: Optional[str],
                routes: Optional[List] = None, seen: Optional[Dict] = None):
    """The multimodal sequence [BOS, visual tokens, text tokens 1..] through
    the decoder -> f32 logits of the text region [B, T, V]; `routes` gives
    each sparse layer's expert choice ([B * S, k], rows by sequence)."""
    llm = params["llm"]
    emb = llm["embed"][input_ids].float()
    x = torch.cat([emb[:, :1], vis, emb[:, 1:]], dim=1)
    s = x.shape[1]
    keep = torch.cat([attention_mask[:, :1], torch.ones(vis.shape[:2], dtype=attention_mask.dtype,
                                                           device=vis.device), attention_mask[:, 1:]], 1).bool()
    i = torch.arange(s, device=x.device)
    mask = (i[None, :] <= i[:, None])[None, None] & keep[:, None, None, :]
    first = cfg["first_k_dense_replace"]
    for li in range(cfg["num_hidden_layers"]):
        given = routes[li - first] if routes is not None and li >= first else None
        x = checkpoint(block, pr, cfg, llm, li, x, mask, i, fault, given, seen, use_reentrant=False)
    x = rms_norm(x[:, s - input_ids.shape[1]:], llm["norm"], cfg["rms_norm_eps"])
    return pr.mm(x, llm["lm_head"].float())


def attack_steps(cfg: Dict, params: Dict, batch, patch0: torch.Tensor, draws, lr: float, device,
                 precision: Precision = Precision(), rows: Optional[int] = None,
                 fault: Optional[str] = None, routes: Optional[List[List[torch.Tensor]]] = None) -> MoeTrace:
    """`vla.attack_steps` on this decoder: the patch attack from `patch0`
    through one inner step per entry of `draws` on one batch, at learning
    rate `lr`; `rows` keeps the batch's first rows only and `fault` plants a
    fault of the sparse-expert layer (each fault of the reference put in
    the program's place). `routes[t][j]` is the expert choice of inner step
    t at sparse layer j for the whole batch ([B * S, k]); without it the
    reference routes on its own."""
    check_implemented(cfg)
    if fault not in (None,) + FAULTS:
        raise ValueError(f"no fault {fault!r} (one of {FAULTS})")
    n = batch.images.shape[0] if rows is None else rows
    images = torch.as_tensor(batch.images[:n], device=device)
    ids = torch.as_tensor(batch.input_ids[:n], device=device)
    mask = torch.as_tensor(batch.attention_mask[:n], device=device)
    labels = torch.as_tensor(batch.labels[:n], device=device)
    patch = patch0.to(device=device, dtype=torch.float32)
    m, v = torch.zeros_like(patch), torch.zeros_like(patch)
    losses, chosen = [], []
    with float32_exact():
        for t, d in enumerate(draws, start=1):
            p = patch.detach().requires_grad_(True)
            imgs = patched_images(images, p, d.xy[:n].tolist(), d.matrix[:n].to(device))
            vis = visual_tokens(precision, cfg, params, imgs)
            given = None if routes is None else [rows_of(r, batch.images.shape[0], n, device) for r in routes[t - 1]]
            seen: Dict = {}
            loss = uada_loss(text_logits(precision, cfg, params, ids, mask, vis, fault, given, seen), labels)
            (grad,) = torch.autograd.grad(loss, p)
            losses.append(float(loss.detach()))
            chosen.append(seen[0].cpu())
            patch, m, v = adamw(patch, grad, m, v, t, lr)
    return MoeTrace(losses, patch.detach(), m, v, chosen)


def rows_of(route: torch.Tensor, batch: int, n: int, device) -> torch.Tensor:
    """A sparse layer's choice [batch * S, k] for the first n sequences."""
    k = route.shape[-1]
    return route.reshape(batch, -1, k)[:n].reshape(-1, k).to(device)


def route_miss(got: List[torch.Tensor], want: List[torch.Tensor]) -> float:
    """The share of tokens, over the inner steps, whose k experts at the
    first sparse layer (`got`, one [T, k] an inner step) are not the k of
    `want` (its first T rows); inf where the inner steps differ in
    number."""
    if len(got) != len(want) or not got:
        return float("inf")
    miss = tokens = 0
    for g, w in zip(got, want):
        g = g.cpu().sort(dim=-1).values
        w = w.cpu()[: g.shape[0]].sort(dim=-1).values
        miss += int((g != w).any(dim=-1).sum())
        tokens += g.shape[0]
    return miss / tokens

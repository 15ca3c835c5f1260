"""Attack objectives (TMA / UADA / UPA) and their metrics over (logits,
labels), as masked reductions on the device (the JAX package's
`attacks/losses.py`).

Conventions:
  logits: [B, S, V] f32 text-region logits (models/vlm.py VLAOutput)
  labels: [B, S] with IGNORE_INDEX outside the 7 action tokens (+EOS)
  the action slice of the vocab is [31744, 32000): slot 0 <-> token 31744
  <-> action ~ +1; slot 255 <-> token 31999 <-> action ~ -1.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Tuple

import torch

from ..models.config import VLAConfig
from ..models.vlm import action_logit_slice
from ..utils.action_tokenizer import decode_tokens
from ..utils.constants import (
    ACTION_TOKEN_BEGIN_IDX,
    ACTION_TOKEN_MIN,
    ACTION_TOKEN_ZERO,
    IGNORE_INDEX,
    N_ACTION_BINS,
)


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(x.dtype)
    return (x * m).sum() / m.sum().clamp(min=1.0)


def _row_masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(x.dtype)
    return (x * m).sum(dim=-1) / m.sum(dim=-1).clamp(min=1.0)


def _first_selected(mask: torch.Tensor, n: int) -> torch.Tensor:
    """Indices of each row's first n selected positions, in order (a stable
    sort of ~mask)."""
    return torch.argsort((~mask).to(torch.uint8), dim=-1, stable=True)[:, :n]


def cosine_similarity(x: torch.Tensor, y: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """F.cosine_similarity over the last axis, each norm clamped to eps
    separately."""
    dot = (x * y).sum(dim=-1)
    nx = torch.linalg.vector_norm(x, dim=-1).clamp(min=eps)
    ny = torch.linalg.vector_norm(y, dim=-1).clamp(min=eps)
    return dot / (nx * ny)


def shifted_action_logits(logits: torch.Tensor, cfg: VLAConfig, text_len: int) -> torch.Tensor:
    """[B, S-1, V]: position j predicts labels[:, 1 + j]."""
    return action_logit_slice(logits, cfg, text_len)


def action_preds_and_mask(
    logits: torch.Tensor, labels: torch.Tensor, cfg: VLAConfig
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(argmax token preds [B, S-1], gt labels [B, S-1], action mask [B, S-1])."""
    sl = shifted_action_logits(logits, cfg, labels.shape[1])
    gt = labels[:, 1:]
    return sl.argmax(dim=-1), gt, gt > ACTION_TOKEN_BEGIN_IDX


def _decode_gt(gt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return decode_tokens(torch.where(mask, gt, torch.full_like(gt, ACTION_TOKEN_ZERO)))


def _expectation(sl: torch.Tensor, weights_over: float) -> torch.Tensor:
    """sum softmax(action-slice logits) * (i + 1) / weights_over."""
    probs = torch.softmax(sl[..., ACTION_TOKEN_MIN : ACTION_TOKEN_MIN + N_ACTION_BINS], dim=-1)
    reweigh = torch.arange(1, N_ACTION_BINS + 1, dtype=torch.float32, device=sl.device)
    if weights_over != 1.0:
        reweigh = reweigh / weights_over
    return (probs * reweigh).sum(dim=-1)


# --- TMA -----------------------------------------------------------------------

def relative_distance_target(pred_actions, gt_actions, mask) -> torch.Tensor:
    """mean over masked tokens of |pred - gt| / max(1 - gt, gt + 1)."""
    max_boundary = torch.maximum(1.0 - gt_actions, gt_actions + 1.0)
    return _masked_mean((pred_actions - gt_actions).abs() / max_boundary, mask)


class TMAMetrics(NamedTuple):
    ce_loss: torch.Tensor
    l1: torch.Tensor
    asr: torch.Tensor
    relative_distance: torch.Tensor


def tma_metrics(logits, target_labels, ce_loss, cfg: VLAConfig) -> TMAMetrics:
    preds, gt, mask = action_preds_and_mask(logits, target_labels, cfg)
    pred_act = decode_tokens(preds)
    gt_act = _decode_gt(gt, mask)
    l1 = _masked_mean((pred_act - gt_act).abs(), mask)
    rel = relative_distance_target(pred_act, gt_act, mask)
    per_tok_ok = (pred_act == gt_act) | ~mask
    asr = _masked_mean(per_tok_ok.all(dim=-1).float(), mask.any(dim=-1))
    return TMAMetrics(ce_loss=ce_loss, l1=l1, asr=asr, relative_distance=rel)


def gripper_asr_counts(preds, gt, mask) -> Dict[str, torch.Tensor]:
    """Flip counts for gripper targets (raw counts, for aggregation)."""
    gt_is_zero = (gt == ACTION_TOKEN_ZERO) & mask
    gt_is_one = (gt == ACTION_TOKEN_MIN) & mask
    gt_other = mask & (gt != ACTION_TOKEN_ZERO) & (gt != ACTION_TOKEN_MIN)
    return {
        "zero_flipped": (gt_is_zero & (preds != ACTION_TOKEN_ZERO)).sum(),
        "zero_total": gt_is_zero.sum(),
        "one_flipped": (gt_is_one & (preds != ACTION_TOKEN_MIN)).sum(),
        "one_total": gt_is_one.sum(),
        "other_to_zero": (gt_other & (preds == ACTION_TOKEN_ZERO)).sum(),
        "other_total": gt_other.sum(),
    }


# --- UADA ----------------------------------------------------------------------

class UADAResult(NamedTuple):
    loss: torch.Tensor
    mse_distance: torch.Tensor
    uad: torch.Tensor
    ce_loss: torch.Tensor


def uada_loss(logits, labels, ce_loss, cfg: VLAConfig, mse_weight: float = 5.0,
              add_inverse_ce: bool = True) -> UADAResult:
    """UADA soft expected-bin loss: E = sum softmax(action slice) * (i+1)/256;
    the hard target is 0.0 for negative gt actions (the reference's int64
    truncation of 1/256) and 1.0 otherwise; loss = MSE(w E, w target), plus
    1/CE when `add_inverse_ce`."""
    sl = shifted_action_logits(logits, cfg, labels.shape[1])
    gt = labels[:, 1:]
    mask = gt > ACTION_TOKEN_BEGIN_IDX
    expectation = _expectation(sl, float(N_ACTION_BINS))
    hard_target = torch.where(gt > ACTION_TOKEN_ZERO, 0.0, 1.0)
    sq = (mse_weight * expectation - mse_weight * hard_target) ** 2
    mse_distance = _masked_mean(sq, mask)

    action_slice = sl[..., ACTION_TOKEN_MIN : ACTION_TOKEN_MIN + N_ACTION_BINS]
    pred_act = decode_tokens(action_slice.argmax(dim=-1) + ACTION_TOKEN_MIN)
    gt_act = _decode_gt(gt, mask)
    max_distance = torch.where(gt_act > 0, (gt_act + 1.0).abs(), (gt_act - 1.0).abs())
    uad = _masked_mean((pred_act - gt_act).abs() / max_distance, mask)

    loss = mse_distance + (1.0 / ce_loss if add_inverse_ce else 0.0)
    return UADAResult(loss=loss, mse_distance=mse_distance, uad=uad, ce_loss=ce_loss)


# --- UPA -----------------------------------------------------------------------

class UPAResult(NamedTuple):
    loss: torch.Tensor
    angle_loss: torch.Tensor
    distance_loss: torch.Tensor
    ce_loss: torch.Tensor


def _xyz(expectation: torch.Tensor, gt: torch.Tensor, is_action: torch.Tensor):
    """Predicted and gt xyz of the first three action tokens, mapped to
    [0, 1]."""
    order = _first_selected(is_action, 3)
    xyz_pred = (torch.gather(expectation, -1, order) - 1.0) / (N_ACTION_BINS - 1.0)
    xyz_gt = (torch.gather(gt, -1, order) - (ACTION_TOKEN_BEGIN_IDX + 1)).float() / (N_ACTION_BINS - 1.0)
    return xyz_pred, xyz_gt


def upa_loss(logits, labels, ce_loss, cfg: VLAConfig, alpha: float = 0.8, beta: float = 0.2) -> UPAResult:
    """UPA reverse-direction loss: the predicted xyz direction anti-parallel
    (cos-sim -> -1) and far (1/dist -> 0) from the gt."""
    sl = shifted_action_logits(logits, cfg, labels.shape[1])
    gt = labels[:, 1:]
    xyz_pred, xyz_gt = _xyz(_expectation(sl, 1.0), gt, gt > ACTION_TOKEN_BEGIN_IDX)
    angle_loss = (cosine_similarity(xyz_pred, xyz_gt) + 1.0).mean()
    distance_loss = 1.0 / (torch.linalg.vector_norm(xyz_pred - xyz_gt, dim=-1).mean() + 1e-3)
    loss = alpha * angle_loss + beta * distance_loss
    return UPAResult(loss=loss, angle_loss=angle_loss, distance_loss=distance_loss, ce_loss=ce_loss)


# --- per-dim relative distance (UADA logging) ------------------------------------

def per_dim_relative_distance(pred_actions, gt_actions, mask, maskidx: Sequence[int]) -> Dict[str, torch.Tensor]:
    """Mean relative distance per selected action dim; each row's k-th
    masked token is the maskidx[k]-th action dim."""
    order = _first_selected(mask, len(maskidx))
    p = torch.gather(pred_actions, -1, order)
    g = torch.gather(gt_actions, -1, order)
    rel = (p - g).abs() / torch.maximum(1.0 - g, g + 1.0)
    return {str(d): rel[:, k].mean() for k, d in enumerate(maskidx)}


# --- per-example metrics (val aggregation with host-side example filters) -------

def per_example_ce(logits, labels, cfg: VLAConfig) -> torch.Tensor:
    """[B]: mean CE over each row's valid shifted labels."""
    sl = shifted_action_logits(logits, cfg, labels.shape[1])
    gt = labels[:, 1:]
    valid = gt != IGNORE_INDEX
    lp = torch.log_softmax(sl, dim=-1)
    tok = torch.gather(lp, -1, torch.where(valid, gt, torch.zeros_like(gt)).long()[..., None])[..., 0]
    return _row_masked_mean(-tok, valid)


def per_example_metrics(logits, labels, cfg: VLAConfig, objective: str,
                        mse_weight: float = 5.0) -> Dict[str, torch.Tensor]:
    """Per-row versions of each objective's val metrics."""
    preds, gt, mask = action_preds_and_mask(logits, labels, cfg)
    pred_act = decode_tokens(preds)
    gt_act = _decode_gt(gt, mask)
    out: Dict[str, torch.Tensor] = {"ce": per_example_ce(logits, labels, cfg)}
    if objective == "tma":
        out["l1"] = _row_masked_mean((pred_act - gt_act).abs(), mask)
        out["success"] = ((pred_act == gt_act) | ~mask).all(dim=-1).float()
        max_boundary = torch.maximum(1.0 - gt_act, gt_act + 1.0)
        out["rel_dist"] = _row_masked_mean((pred_act - gt_act).abs() / max_boundary, mask)
    elif objective == "uada":
        sl = shifted_action_logits(logits, cfg, labels.shape[1])
        expectation = _expectation(sl, float(N_ACTION_BINS))
        hard = torch.where(gt > ACTION_TOKEN_ZERO, 0.0, 1.0)
        out["mse_distance"] = _row_masked_mean((mse_weight * expectation - mse_weight * hard) ** 2, mask)
        max_d = torch.where(gt_act > 0, (gt_act + 1.0).abs(), (gt_act - 1.0).abs())
        out["uad"] = _row_masked_mean((pred_act - gt_act).abs() / max_d, mask)
    elif objective.startswith("upa"):
        sl = shifted_action_logits(logits, cfg, labels.shape[1])
        xyz_pred, xyz_gt = _xyz(_expectation(sl, 1.0), gt, mask)
        out["angle"] = cosine_similarity(xyz_pred, xyz_gt) + 1.0
        out["xyz_dist"] = torch.linalg.vector_norm(xyz_pred - xyz_gt, dim=-1)
    return out


def clip_grad_l1(grad: torch.Tensor, max_norm: float) -> torch.Tensor:
    """torch.nn.utils.clip_grad_norm_(norm_type=1) semantics."""
    total = grad.abs().sum()
    return grad * (max_norm / (total + 1e-6)).clamp(max=1.0)

"""Real-checkpoint acceptance machinery of the port: golden manifest,
activation parity, attack smoke, quantized-serving agreement.

The JAX package's `models/verify.py`, on the port's own model code. Four
independent legs, each cheaper than the next so failures surface before long
work:

1. `manifest_report` — tensor NAMES/SHAPES/DTYPES against a golden manifest
   derived from the VLAConfig, from the safetensors headers alone
   (`models/safetensors_io.py`): a truncated download, a wrong repo, or a
   layout drift fails in seconds.
2. `parity_report` — per-module activation parity of the port's converted
   tree against `transformers` modules built DIRECTLY from the raw checkpoint
   names (Dinov2WithRegisters / SiglipVisionModel / CLIPVisionModel /
   LlamaForCausalLM; the mapping never passes through the port's converter,
   so a converter bug cannot cancel out), plus an end-to-end multimodal
   logits comparison. Both sides run in true fp32 on the port's device: on a
   CUDA card TF32 is switched off for the leg (matmuls and cuDNN, so the
   patch-embedding convolutions too). `transformers` is imported inside the
   leg; the port itself never needs it.
3. `tma_smoke` — a short TMA attack on synthetic frames through the port's
   attack engine: the loss must descend and a patch must come out.
4. `quant_decode_report` — greedy-decode token agreement of quantized
   serving configurations against the full-precision decode.
"""

from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import not_ported
from .config import LlamaConfig, ViTConfig, VLAConfig, torch_dtype
from .safetensors_io import read_safetensors_headers

# ------------------------------------------------------------------ manifest --

# safetensors dtype name -> byte width (for size accounting)
_DTYPE_BYTES = {
    "F64": 8, "F32": 4, "F16": 2, "BF16": 2, "I64": 8, "I32": 4, "I16": 2,
    "I8": 1, "U8": 1, "BOOL": 1,
}


@dataclass
class TensorRule:
    """One required checkpoint tensor: any of `names` must exist (alternates
    cover layout variants like ls1.scale_factor vs ls1.gamma), with one of
    the allowed `shapes` (multiple cover e.g. pos-embed with/without the cls
    row)."""
    names: Tuple[str, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    optional: bool = False


def _vit_rules(prefix: str, cfg: ViTConfig) -> List[TensorRule]:
    d, h, p = cfg.embed_dim, cfg.mlp_hidden, cfg.patch_size
    g2 = cfg.num_patches
    rules = [
        TensorRule((prefix + "patch_embed.proj.weight",), ((d, 3, p, p),)),
        TensorRule((prefix + "pos_embed",), ((1, g2, d), (1, g2 + 1, d))),
    ]
    if not cfg.pre_norm:
        rules.append(TensorRule((prefix + "patch_embed.proj.bias",), ((d,),)))
    if cfg.use_cls_token:
        rules.append(TensorRule((prefix + "cls_token",), ((1, 1, d),)))
    if cfg.num_reg_tokens:
        rules.append(TensorRule((prefix + "reg_token",), ((1, cfg.num_reg_tokens, d),)))
    if cfg.pre_norm:
        rules.append(TensorRule((prefix + "norm_pre.weight",), ((d,),)))
        rules.append(TensorRule((prefix + "norm_pre.bias",), ((d,),)))
    # only blocks [0, tap_layer) execute; the final block + norm are dead in
    # the second-to-last-layer tap path and land in the report's
    # `unconsumed` note instead
    for i in range(cfg.tap_layer):
        b = f"{prefix}blocks.{i}."
        for nm, shape in (
            ("norm1.weight", (d,)), ("norm1.bias", (d,)),
            ("attn.qkv.weight", (3 * d, d)), ("attn.qkv.bias", (3 * d,)),
            ("attn.proj.weight", (d, d)), ("attn.proj.bias", (d,)),
            ("norm2.weight", (d,)), ("norm2.bias", (d,)),
            ("mlp.fc1.weight", (h, d)), ("mlp.fc1.bias", (h,)),
            ("mlp.fc2.weight", (d, h)), ("mlp.fc2.bias", (d,)),
        ):
            rules.append(TensorRule((b + nm,), (shape,)))
        if cfg.use_layerscale:
            rules.append(TensorRule((b + "ls1.scale_factor", b + "ls1.gamma"), ((d,),)))
            rules.append(TensorRule((b + "ls2.scale_factor", b + "ls2.gamma"), ((d,),)))
    return rules


def _llama_rules(cfg: LlamaConfig) -> List[TensorRule]:
    hid, inter = cfg.hidden_size, cfg.intermediate_size
    kv = cfg.num_kv_heads * cfg.head_dim
    rules = [
        TensorRule(("language_model.model.embed_tokens.weight",), ((cfg.vocab_size, hid),)),
        TensorRule(("language_model.model.norm.weight",), ((hid,),)),
        TensorRule(("language_model.lm_head.weight",), ((cfg.vocab_size, hid),)),
    ]
    for i in range(cfg.num_layers):
        b = f"language_model.model.layers.{i}."
        for nm, shape in (
            ("input_layernorm.weight", (hid,)),
            ("self_attn.q_proj.weight", (hid, hid)),
            ("self_attn.k_proj.weight", (kv, hid)),
            ("self_attn.v_proj.weight", (kv, hid)),
            ("self_attn.o_proj.weight", (hid, hid)),
            ("post_attention_layernorm.weight", (hid,)),
            ("mlp.gate_proj.weight", (inter, hid)),
            ("mlp.up_proj.weight", (inter, hid)),
            ("mlp.down_proj.weight", (hid, inter)),
        ):
            rules.append(TensorRule((b + nm,), (shape,)))
    return rules


def expected_checkpoint_rules(cfg: VLAConfig) -> List[TensorRule]:
    """The golden manifest: every tensor the converter reads from an HF
    OpenVLA-layout checkpoint (models/convert.py), with shapes derived purely
    from the config — so validation needs no reference download."""
    if not isinstance(cfg.llm, LlamaConfig):
        raise NotImplementedError(
            "manifest validation covers the OpenVLA (Llama-family) layout; "
            f"got {type(cfg.llm).__name__}"
        )
    rules = _vit_rules("vision_backbone.featurizer.", cfg.dino)
    v = cfg.vision_dim
    L = cfg.llm.hidden_size
    if cfg.siglip is not None:
        rules += _vit_rules("vision_backbone.fused_featurizer.", cfg.siglip)
        proj = (
            ("projector.fc1.weight", (4 * v, v)), ("projector.fc1.bias", (4 * v,)),
            ("projector.fc2.weight", (L, 4 * v)), ("projector.fc2.bias", (L,)),
            ("projector.fc3.weight", (L, L)), ("projector.fc3.bias", (L,)),
        )
    else:
        proj = (
            ("projector.fc1.weight", (L, v)), ("projector.fc1.bias", (L,)),
            ("projector.fc2.weight", (L, L)), ("projector.fc2.bias", (L,)),
        )
    rules += [TensorRule((nm,), (shape,)) for nm, shape in proj]
    rules += _llama_rules(cfg.llm)
    return rules


@dataclass
class ManifestReport:
    ok: bool
    n_tensors: int
    total_bytes: int
    dtypes: Dict[str, int]
    missing: List[str] = field(default_factory=list)
    shape_mismatches: List[str] = field(default_factory=list)
    unconsumed: List[str] = field(default_factory=list)

    def to_json(self) -> Dict:
        return {
            "ok": self.ok, "n_tensors": self.n_tensors,
            "total_bytes": self.total_bytes, "dtypes": self.dtypes,
            "missing": self.missing, "shape_mismatches": self.shape_mismatches,
            "n_unconsumed": len(self.unconsumed),
            "unconsumed_sample": self.unconsumed[:20],
        }


def manifest_report(ckpt_dir: str, cfg: VLAConfig) -> ManifestReport:
    """Validate a safetensors checkpoint directory against the golden
    manifest. Reads only headers; reports EVERY missing/mis-shaped tensor."""
    return validate_manifest(read_safetensors_headers(ckpt_dir), cfg)


# torch dtype -> safetensors dtype name, so in-memory manifests share
# _DTYPE_BYTES and histogram keys with the header-scan path
_TORCH_TO_ST = {
    torch.float64: "F64", torch.float32: "F32", torch.float16: "F16",
    torch.bfloat16: "BF16", torch.int64: "I64", torch.int32: "I32",
    torch.int16: "I16", torch.int8: "I8", torch.uint8: "U8", torch.bool: "BOOL",
}


def manifest_report_from_state(state: Mapping[str, torch.Tensor], cfg: VLAConfig) -> ManifestReport:
    """Manifest validation over an in-memory (HF-named) state dict — the
    prismatic .pt path, which has no header scan (torch.load reads
    everything anyway)."""
    headers = {k: (_TORCH_TO_ST[v.dtype], tuple(v.shape)) for k, v in state.items()}
    return validate_manifest(headers, cfg)


def validate_manifest(headers: Dict[str, Tuple[str, Tuple[int, ...]]],
                      cfg: VLAConfig) -> ManifestReport:
    missing: List[str] = []
    mismatched: List[str] = []
    consumed = set()
    for rule in expected_checkpoint_rules(cfg):
        present = [n for n in rule.names if n in headers]
        if not present:
            if not rule.optional:
                missing.append(" | ".join(rule.names))
            continue
        name = present[0]
        consumed.add(name)
        _, shape = headers[name]
        if shape not in rule.shapes:
            mismatched.append(
                f"{name}: got {list(shape)}, want one of "
                f"{[list(s) for s in rule.shapes]}"
            )
    dtypes: Dict[str, int] = {}
    total = 0
    for name, (dtype, shape) in headers.items():
        dtypes[dtype] = dtypes.get(dtype, 0) + 1
        total += int(np.prod(shape, dtype=np.int64)) * _DTYPE_BYTES.get(dtype, 4)
    return ManifestReport(
        ok=not missing and not mismatched,
        n_tensors=len(headers),
        total_bytes=total,
        dtypes=dtypes,
        missing=missing,
        shape_mismatches=mismatched,
        unconsumed=sorted(set(headers) - consumed),
    )


# ------------------------------------------------------------------- parity --

def _split_qkv(w: torch.Tensor, b: torch.Tensor, d: int):
    return (w[:d], w[d : 2 * d], w[2 * d :]), (b[:d], b[d : 2 * d], b[2 * d :])


def _with_zero_cls_row(pos: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """[1, N or 1+N, D] -> HF's [1, 1+N, D]: a tower whose cls token takes no
    position (timm's no_embed_class, or a cls position already folded into
    the token) gets a zero cls-position row."""
    if pos.shape[1] == cfg.num_patches:
        pos = torch.cat([torch.zeros_like(pos[:, :1]), pos], dim=1)
    return pos


def _load(model, sd: Dict[str, torch.Tensor]):
    """Copy the reference module's weights (load_state_dict casts each to
    the module's fp32 on its device); unexpected keys mean the mapping
    drifted from transformers' names."""
    ret = model.load_state_dict(sd, strict=False)
    if ret.unexpected_keys:
        raise KeyError(f"keys {ret.unexpected_keys} are not in {type(model).__name__}")
    return model


def _build(cls, hf_cfg, device):
    """A transformers module in fp32 whose parameters are made on `device`
    (their random init runs there, then the checkpoint overwrites them)."""
    with torch.device(device):
        return cls(hf_cfg).float().eval()


def _vit_block_sd(get, state, prefix: str, cfg: ViTConfig, hf_block: str, names: Dict[str, str]):
    """One tower's blocks under transformers' names; `names` maps the keys
    that differ between the model families (attention, layer norms)."""
    sd = {}
    d = cfg.embed_dim
    for i in range(cfg.depth):
        b, hb = f"blocks.{i}.", hf_block.format(i)
        if prefix + b + "norm1.weight" not in state:
            # converted-back checkpoints may omit the dead final block; keep
            # the module's random init there (never read at the tap)
            continue
        (qw, kw, vw), (qb, kb, vb) = _split_qkv(get(b + "attn.qkv.weight"), get(b + "attn.qkv.bias"), d)
        sd.update({
            hb + names["norm1"] + ".weight": get(b + "norm1.weight"),
            hb + names["norm1"] + ".bias": get(b + "norm1.bias"),
            hb + names["q"] + ".weight": qw, hb + names["q"] + ".bias": qb,
            hb + names["k"] + ".weight": kw, hb + names["k"] + ".bias": kb,
            hb + names["v"] + ".weight": vw, hb + names["v"] + ".bias": vb,
            hb + names["out"] + ".weight": get(b + "attn.proj.weight"),
            hb + names["out"] + ".bias": get(b + "attn.proj.bias"),
            hb + names["norm2"] + ".weight": get(b + "norm2.weight"),
            hb + names["norm2"] + ".bias": get(b + "norm2.bias"),
            hb + "mlp.fc1.weight": get(b + "mlp.fc1.weight"),
            hb + "mlp.fc1.bias": get(b + "mlp.fc1.bias"),
            hb + "mlp.fc2.weight": get(b + "mlp.fc2.weight"),
            hb + "mlp.fc2.bias": get(b + "mlp.fc2.bias"),
        })
        if names.get("ls1"):
            ls1 = state.get(prefix + b + "ls1.scale_factor", state.get(prefix + b + "ls1.gamma"))
            ls2 = state.get(prefix + b + "ls2.scale_factor", state.get(prefix + b + "ls2.gamma"))
            sd[hb + names["ls1"]] = ls1
            sd[hb + names["ls2"]] = ls2
    return sd


_CLIP_NAMES = {"norm1": "layer_norm1", "norm2": "layer_norm2", "q": "self_attn.q_proj",
               "k": "self_attn.k_proj", "v": "self_attn.v_proj", "out": "self_attn.out_proj"}


def build_hf_dinov2(state: Mapping[str, torch.Tensor], cfg: ViTConfig,
                    prefix: str = "vision_backbone.featurizer.", device="cpu"):
    """transformers' Dinov2WithRegistersModel loaded from the checkpoint's
    timm-layout names (the architecture timm's vit_large_patch14_reg4_dinov2
    encodes). The qkv split / LayerScale / pos-embed handling here is an
    INDEPENDENT reading of the checkpoint — it never touches the converter."""
    from transformers import Dinov2WithRegistersConfig, Dinov2WithRegistersModel

    hf_cfg = Dinov2WithRegistersConfig(
        hidden_size=cfg.embed_dim, num_hidden_layers=cfg.depth,
        num_attention_heads=cfg.num_heads,
        # Dinov2 has no intermediate_size; transformers 5 types the ratio int
        mlp_ratio=(cfg.mlp_hidden // cfg.embed_dim if cfg.mlp_hidden % cfg.embed_dim == 0
                   else cfg.mlp_hidden / cfg.embed_dim),
        image_size=cfg.image_size, patch_size=cfg.patch_size,
        num_register_tokens=cfg.num_reg_tokens, hidden_act="gelu",
        layer_norm_eps=cfg.ln_eps,
    )
    model = _build(Dinov2WithRegistersModel, hf_cfg, device)
    get = lambda n: state[prefix + n]  # noqa: E731
    sd = {
        "embeddings.cls_token": get("cls_token"),
        "embeddings.register_tokens": get("reg_token"),
        "embeddings.patch_embeddings.projection.weight": get("patch_embed.proj.weight"),
        "embeddings.patch_embeddings.projection.bias": get("patch_embed.proj.bias"),
        "embeddings.position_embeddings": _with_zero_cls_row(get("pos_embed"), cfg),
    }
    sd.update(_vit_block_sd(get, state, prefix, cfg, "encoder.layer.{}.", {
        "norm1": "norm1", "norm2": "norm2", "q": "attention.attention.query",
        "k": "attention.attention.key", "v": "attention.attention.value",
        "out": "attention.output.dense", "ls1": "layer_scale1.lambda1",
        "ls2": "layer_scale2.lambda1"}))
    return _load(model, sd)


def build_hf_clip(state: Mapping[str, torch.Tensor], cfg: ViTConfig,
                  prefix: str = "vision_backbone.featurizer.", device="cpu"):
    """transformers' CLIPVisionModel from the checkpoint's timm CLIP-tower
    names (pre-norm `norm_pre`, bias-less patch embed, quick-GELU — the zoo's
    `vit_*_clip_*.openai` towers)."""
    from transformers import CLIPVisionConfig, CLIPVisionModel

    hf_cfg = CLIPVisionConfig(
        hidden_size=cfg.embed_dim, num_hidden_layers=cfg.depth,
        num_attention_heads=cfg.num_heads, intermediate_size=cfg.mlp_hidden,
        image_size=cfg.image_size, patch_size=cfg.patch_size,
        hidden_act="quick_gelu" if cfg.use_quick_gelu else "gelu",
        layer_norm_eps=cfg.ln_eps,
    )
    model = _build(CLIPVisionModel, hf_cfg, device)
    get = lambda n: state[prefix + n]  # noqa: E731
    sd = {
        "vision_model.embeddings.patch_embedding.weight": get("patch_embed.proj.weight"),
        "vision_model.embeddings.class_embedding": get("cls_token").reshape(cfg.embed_dim),
        "vision_model.embeddings.position_embedding.weight": _with_zero_cls_row(get("pos_embed"), cfg)[0],
        "vision_model.pre_layrnorm.weight": get("norm_pre.weight"),
        "vision_model.pre_layrnorm.bias": get("norm_pre.bias"),
    }
    sd.update(_vit_block_sd(get, state, prefix, cfg, "vision_model.encoder.layers.{}.", _CLIP_NAMES))
    return _load(model, sd)


def build_hf_siglip(state: Mapping[str, torch.Tensor], cfg: ViTConfig,
                    prefix: str = "vision_backbone.fused_featurizer.", device="cpu"):
    from transformers import SiglipVisionConfig, SiglipVisionModel

    hf_cfg = SiglipVisionConfig(
        hidden_size=cfg.embed_dim, num_hidden_layers=cfg.depth,
        num_attention_heads=cfg.num_heads, intermediate_size=cfg.mlp_hidden,
        image_size=cfg.image_size, patch_size=cfg.patch_size,
        hidden_act="gelu", layer_norm_eps=cfg.ln_eps,
    )
    model = _build(SiglipVisionModel, hf_cfg, device)
    get = lambda n: state[prefix + n]  # noqa: E731
    sd = {
        "vision_model.embeddings.patch_embedding.weight": get("patch_embed.proj.weight"),
        "vision_model.embeddings.patch_embedding.bias": get("patch_embed.proj.bias"),
        "vision_model.embeddings.position_embedding.weight": get("pos_embed")[0],
    }
    sd.update(_vit_block_sd(get, state, prefix, cfg, "vision_model.encoder.layers.{}.", _CLIP_NAMES))
    return _load(model, sd)


def tower_builder(cfg: ViTConfig):
    """The reference-module builder for a tower config, or a clear error for
    combinations the harness doesn't cover yet."""
    if cfg.pre_norm:
        return build_hf_clip
    if cfg.num_reg_tokens or cfg.use_layerscale:
        return build_hf_dinov2
    if cfg.use_cls_token:
        raise NotImplementedError(
            "plain cls-token tower (IN1K-style) has no reference builder in "
            "the parity harness yet"
        )
    return build_hf_siglip


def build_hf_llama(state: Mapping[str, torch.Tensor], cfg: LlamaConfig, device="cpu"):
    """transformers' LlamaForCausalLM straight from the checkpoint's
    language_model.* names (they ARE HF Llama names modulo the prefix)."""
    from transformers import LlamaConfig as HFLlamaConfig
    from transformers import LlamaForCausalLM

    hf_cfg = HFLlamaConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size, num_hidden_layers=cfg.num_layers,
        num_attention_heads=cfg.num_heads, num_key_value_heads=cfg.num_kv_heads,
        max_position_embeddings=cfg.max_seq_len, rms_norm_eps=cfg.rms_eps,
        rope_theta=cfg.rope_theta, attn_implementation="eager",
    )
    model = _build(LlamaForCausalLM, hf_cfg, device)
    model.load_state_dict(
        {k[len("language_model."):]: v for k, v in state.items() if k.startswith("language_model.")},
        strict=False,
    )
    return model


def _torch_projector(state: Mapping[str, torch.Tensor], features: torch.Tensor) -> torch.Tensor:
    """The fused 3-layer (or single-tower 2-layer) projector in plain torch
    (modeling_prismatic.py:127-156), straight from checkpoint tensors."""
    import torch.nn.functional as F

    def w(name):
        return state[name].to(features.device, torch.float32)

    x = F.gelu(F.linear(features, w("projector.fc1.weight"), w("projector.fc1.bias")))
    x = F.linear(x, w("projector.fc2.weight"), w("projector.fc2.bias"))
    if "projector.fc3.weight" not in state:
        return x
    return F.linear(F.gelu(x), w("projector.fc3.weight"), w("projector.fc3.bias"))


def _diff(got: torch.Tensor, want: torch.Tensor) -> Dict[str, float]:
    got = got.detach().float().cpu().numpy()
    want = want.detach().float().cpu().numpy()
    abs_diff = np.abs(got - want)
    denom = np.maximum(np.abs(want), 1e-3)
    return {
        "max_abs": float(abs_diff.max()),
        "max_rel": float((abs_diff / denom).max()),
        "mean_abs": float(abs_diff.mean()),
        "ref_scale": float(np.abs(want).mean()),
    }


@contextlib.contextmanager
def true_fp32():
    """TF32 off for matmuls and cuDNN (convolutions) inside the block: fp32
    on a CUDA card is then fp32, as on the CPU."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def tree_to(tree: Mapping, device, dtype) -> Dict:
    return {k: tree_to(v, device, dtype) if isinstance(v, Mapping) else v.to(device, dtype)
            for k, v in tree.items()}


def parity_report(
    state: Mapping[str, torch.Tensor],
    cfg: VLAConfig,
    params: Optional[Dict] = None,
    modules: Sequence[str] = ("dino", "siglip", "projector", "llm", "full"),
    batch: int = 2,
    seq: int = 24,
    seed: int = 0,
    rel_tol: float = 2e-2,
    device="cpu",
) -> Dict[str, Dict]:
    """Per-module activation parity of the port's converted tree vs
    transformers modules built independently from the raw checkpoint, both
    in fp32 on `device` (TF32 off), so residual diffs reflect conversion
    errors, not hardware precision. The inputs are the JAX package's draws
    from numpy's `default_rng(seed)`.

    Returns {module: {max_abs, max_rel, mean_abs, ref_scale, ok}}. `rel_tol`
    gates max_rel (relative to a 1e-3-floored reference magnitude): fp32
    re-execution of a bf16 checkpoint agrees to ~1e-6; anything near 1 means
    a wrong tensor, transpose, or tap point."""
    from .convert import convert_state_dict
    from .llama import embed_tokens, llama_apply
    from .vit import vit_features
    from .vlm import projector_apply, vla_forward

    dev = torch.device(device)
    if params is None:
        params = convert_state_dict(state, cfg, dev)
    params32 = tree_to(params, dev, torch.float32)
    if isinstance(cfg.llm, LlamaConfig) and cfg.llm.attn_impl == "flash":
        # the CUDA attention kernels take bf16; the fp32 forward runs the
        # plain attention of the same math (the kernels are held to it
        # elsewhere), so the leg checks the conversion alone
        cfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, attn_impl="xla"))
    rng = np.random.default_rng(seed)
    out: Dict[str, Dict] = {}

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def record(name: str, got, want):
        d = _diff(got, want)
        d["ok"] = d["max_rel"] <= rel_tol
        out[name] = d

    pixels = rng.standard_normal((batch, 2, cfg.dino.image_size, cfg.dino.image_size, 3)).astype(np.float32)

    def tower_features(model, images_nhwc, depth, n_prefix):
        hf = model(t(images_nhwc.transpose(0, 3, 1, 2)), output_hidden_states=True)
        # hidden_states[k] = after block k-1 -> second-to-last tap = [depth-1]
        return hf.hidden_states[depth - 1][:, n_prefix:]

    with true_fp32(), torch.no_grad():
        hf_dino = hf_sig = None
        if "dino" in modules or "full" in modules:
            hf_dino = tower_builder(cfg.dino)(state, cfg.dino, device=dev)
        if cfg.siglip is not None and ("siglip" in modules or "full" in modules):
            hf_sig = build_hf_siglip(state, cfg.siglip, device=dev)

        if "dino" in modules:
            want = tower_features(hf_dino, pixels[:, 0], cfg.dino.depth, cfg.dino.num_prefix_tokens)
            record("dino", vit_features(params32["vision"]["dino"], cfg.dino, t(pixels[:, 0])), want)
        if cfg.siglip is not None and "siglip" in modules:
            want = tower_features(hf_sig, pixels[:, 1], cfg.siglip.depth, 0)
            record("siglip", vit_features(params32["vision"]["siglip"], cfg.siglip, t(pixels[:, 1])), want)
        if "projector" in modules:
            feats = t(rng.standard_normal((batch, 7, cfg.vision_dim)).astype(np.float32))
            record("projector", projector_apply(params32["projector"], feats), _torch_projector(state, feats))

        hf_llama = None
        if "llm" in modules or "full" in modules:
            hf_llama = build_hf_llama(state, cfg.llm, device=dev)
        ids = rng.integers(5, 31000, size=(batch, seq))
        mask = np.ones((batch, seq), np.int32)
        mask[-1, seq - 5 :] = 0
        valid = torch.from_numpy(mask.astype(bool))
        if "llm" in modules:
            want = hf_llama(input_ids=t(ids), attention_mask=t(mask)).logits
            got = llama_apply(params32["llm"], cfg.llm, embed_tokens(params32["llm"], t(ids)),
                              attention_mask=t(mask))
            # compare only valid (unmasked) positions: padded rows are arbitrary
            record("llm", got.cpu()[valid], want.cpu()[valid])

        if "full" in modules:
            # the end-to-end multimodal forward vs the reference composition
            # (modeling_prismatic.py:362-415): towers -> channel concat ->
            # projector -> insert after BOS -> decoder logits on the text tail
            feats = tower_features(hf_dino, pixels[:, 0], cfg.dino.depth, cfg.dino.num_prefix_tokens)
            if cfg.siglip is not None:
                feats = torch.cat([feats, tower_features(hf_sig, pixels[:, 1], cfg.siglip.depth, 0)], -1)
            proj = _torch_projector(state, feats)
            emb = hf_llama.get_input_embeddings()(t(ids))
            n_patch = proj.shape[1]
            mm_mask = torch.cat([t(mask[:, :1]), torch.ones((batch, n_patch), dtype=torch.int32, device=dev),
                                 t(mask[:, 1:])], dim=1)
            want_full = hf_llama(inputs_embeds=torch.cat([emb[:, :1], proj, emb[:, 1:]], dim=1),
                                 attention_mask=mm_mask).logits[:, n_patch:]
            got_full = vla_forward(params32, cfg, t(ids), t(mask), t(pixels)).logits
            record("full", got_full.cpu()[valid], want_full.cpu()[valid])
    return out


# -------------------------------------------------------------------- smoke --

def tma_smoke(
    params,
    cfg: VLAConfig,
    iters: int = 20,
    batch_size: int = 2,
    patch_hw: Tuple[int, int] = (50, 50),
    lr: float = 5e-2,
    pad_to: int = 32,
    seed: int = 0,
) -> Dict:
    """Short TMA run on synthetic frames against the loaded weights (on
    their device) through the port's attack engine: the target-CE loss must
    descend and a patch must materialize — the end-to-end differentiability
    check. Returns {losses, decreased, patch [H,W,3] float32 in [0,1]}."""
    from ..attacks.engine import AttackSpec, batch_to_device, draw_step, init_attack_state, make_attack_step
    from ..data import batch_iterator, dummy_frame_iterator
    from ..utils.labels import build_tma_target_tokens
    from ..utils.prompting import WordStubTokenizer

    device = params["llm"]["embed"].device
    maskidx = [0, 1, 2, 3, 4, 5, 6]
    target = build_tma_target_tokens(np.zeros(7), maskidx)
    spec = AttackSpec(objective="tma", geometry=True, inner_loop=1)
    step = make_attack_step(spec, cfg, target, maskidx)
    state = init_attack_state(torch.Generator().manual_seed(seed), patch_hw, device)
    frames = dummy_frame_iterator(WordStubTokenizer(), image_size=cfg.dino.image_size, seed=seed)
    batch = batch_to_device(next(batch_iterator(frames, batch_size, pad_to=pad_to)), device)
    losses: List[float] = []
    for i in range(iters):
        draws = draw_step(torch.Generator().manual_seed(seed * 7919 + i), spec, batch.images.shape,
                          patch_hw, batch.labels.shape)
        state, metrics = step(params, state, batch, lr, True, draws)
        losses.append(float(metrics["loss"][-1]))
    k = max(min(5, iters // 2), 1)
    decreased = float(np.mean(losses[-k:])) < float(np.mean(losses[:k]))
    return {"losses": losses, "decreased": decreased, "patch": state.patch.float().cpu().numpy()}


# -------------------------------------------------------------------- quant --

def parse_quant_mode(mode: str) -> Tuple[Optional[str], Optional[str], Optional[int], bool]:
    """'<int8|w8a8|int4|none>[+kv8|kv4][+vt<k>][+qk]' (or a bare 'kv8'/
    'kv4'/'vt<k>' for a single-lever config) -> (weights_mode | None,
    kv_cache | None, visual_tokens | None, int4_kernel: bool). '+qk' routes
    the decode tail through the CUDA int4 dequant-matmul kernel (int4
    weights only; on the CPU its plain version). Raises ValueError on
    anything else — callers validate the full mode list BEFORE running
    expensive legs."""
    from ..utils.quant_args import parse_suffixes

    parts = mode.split("+")
    weights, suffixes = parts[0], parts[1:]
    if weights in ("kv8", "kv4") or (weights.startswith("vt") and weights[2:].isdigit()):
        suffixes = [weights] + suffixes  # bare single-lever config
        weights = "none"
    if weights not in ("int8", "w8a8", "int4", "none"):
        raise ValueError(
            f"quant mode {mode!r}: weights must be int8, w8a8, int4, or "
            f"none (for a kv/vt-only config), got {weights!r}"
        )
    kv_cache, visual_tokens, qk = parse_suffixes(suffixes, context=f"quant mode {mode!r}: ")
    if qk and weights != "int4":
        raise ValueError(
            f"quant mode {mode!r}: +qk requires int4 weights (the kernel "
            f"contracts the packed-s4 layout)"
        )
    return (None if weights == "none" else weights), kv_cache, visual_tokens, qk


def quant_decode_report(
    params,
    cfg: VLAConfig,
    modes: Sequence[str] = ("int8", "w8a8", "int4", "int8+kv8", "int4+kv4"),
    batch_size: int = 2,
    n_batches: int = 2,
    prompt_pad: int = 32,
    seed: int = 0,
    min_agreement: float = 0.9,
    gate_modes: Sequence[str] = ("int8",),
    tp: int = 1,
) -> Dict:
    """Quantized-serving acceptance: greedy-decode token agreement of each
    quantized configuration against the full-precision decode on the SAME
    synthetic frames/prompts, on the device `params` live on. Mode strings as
    `parse_quant_mode`. Each mode's quantized tree is dropped before the next
    is built, so the peak is the cooked tree plus one quantized copy.

    Gate: `ok` per mode = all-token agreement >= min_agreement, applied only
    to `gate_modes` (int8 weight-only is near-lossless on real LLM weights;
    the other entries are reported for the user's own A/B). `tp` > 1 (the
    deployment's tensor-parallel group size) is not ported."""
    import gc

    from ..utils.normalization import dual_normalize
    from ..utils.prompting import WordStubTokenizer
    from ..utils.quant_args import resolve_quantize
    from ..data import batch_iterator, dummy_frame_iterator
    from .decode import decode_layout_params, greedy_decode_actions
    from .quant import int4_group_size_for, quantize_decode_params

    if tp != 1:
        raise not_ported("quant_decode_report(tp > 1)", "slice 3: TP and DP")
    parsed = [(m, parse_quant_mode(m)) for m in modes]  # validate ALL first
    device = params["llm"]["embed"].device
    dtype = torch_dtype(cfg)
    cooked = decode_layout_params(tree_to(params, device, dtype))
    frames = dummy_frame_iterator(WordStubTokenizer(), image_size=cfg.dino.image_size, seed=seed)
    inputs = []
    for b in batch_iterator(frames, batch_size, pad_to=prompt_pad):
        px = dual_normalize(torch.from_numpy(np.asarray(b.images, np.float32)).to(device)).to(dtype)
        inputs.append((torch.from_numpy(np.asarray(b.input_ids)).to(device),
                       torch.from_numpy(np.asarray(b.attention_mask)).to(device), px))
        if len(inputs) == n_batches:
            break

    def run(tree, kv_cache, visual_tokens=None, act_quant=None, int4_kernel=False):
        toks, acts = [], []
        with torch.inference_mode():
            for ids, mask, px in inputs:
                r = greedy_decode_actions(tree, cfg, ids, mask, px, cooked_weights=True,
                                          kv_cache=kv_cache, visual_tokens=visual_tokens,
                                          act_quant=act_quant, int4_kernel=int4_kernel)
                toks.append(r.tokens.cpu().numpy())
                acts.append(r.actions.float().cpu().numpy())
        return np.concatenate(toks), np.concatenate(acts)

    ref_tokens, ref_actions = run(cooked, None)
    report: Dict = {}
    for mode, (wq, kv_cache, visual_tokens, qk) in parsed:
        wq, act, _ = resolve_quantize(wq)
        qp = (quantize_decode_params(cooked, mode=wq, group_size=int4_group_size_for(cfg))
              if wq is not None else cooked)
        tokens, actions = run(qp, kv_cache, visual_tokens, act, qk)
        del qp
        gc.collect()
        agree = float(np.mean(tokens == ref_tokens))
        entry = {
            "token_agreement": round(agree, 4),
            "first_token_agreement": round(float(np.mean(tokens[:, 0] == ref_tokens[:, 0])), 4),
            "max_abs_action_delta": round(float(np.max(np.abs(actions - ref_actions))), 6),
            "n_tokens": int(ref_tokens.size),
        }
        if mode in gate_modes:
            entry["ok"] = agree >= min_agreement
        report[mode] = entry
    return report

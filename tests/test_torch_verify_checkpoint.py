"""Slice 4b of the port on the CPU: `models/verify.py` and
`cli/verify_checkpoint.py` against the JAX package's, on tiny checkpoints the
port writes (`chip_smoke.export_checkpoint`, the released OpenVLA layout).

Tolerances: manifest rules, reports, the quant-mode grammar and the quant
leg's reports exactly equal to the JAX package's; the parity leg's own gate
(max_rel <= 2e-2, the JAX default) and max_rel < 5e-3 on a faithful
checkpoint, as tests/test_verify_checkpoint.py holds the JAX leg. The TMA
smoke runs 20 iterations (the CLI default): the port draws its placements
from torch generators, not JAX keys, and on the tiny model's random weights
10 draws are too few for a mean to move past the placement noise."""

import json
import os

# transformers, imported by the parity leg, would otherwise import
# TensorFlow as well (~10 s a process); the leg needs only its torch models
os.environ.setdefault("USE_TF", "0")

import numpy as np
import jax
import pytest
import torch

from roboticattack_tpu.models import VLA_TINY as J_TINY
from roboticattack_tpu.models import init_vla_params as jax_init_vla_params
from roboticattack_tpu.models import verify as jverify
from roboticattack_tpu.models.config import get_config as jax_get_config
from roboticattack_torch.models import verify as tverify
from roboticattack_torch.models.bridge import params_from_jax
from roboticattack_torch.models.config import VLA_TINY, get_config
from roboticattack_torch.models.convert import convert_state_dict
from roboticattack_torch.models.safetensors_io import read_state_dict
from roboticattack_torch.models.vlm import init_vla_params

import chip_smoke

pytest.importorskip("transformers")


def write_tiny(path, seed=0, edit=None):
    """VLA_TINY's random weights, with O(1) LayerScale (real DINOv2
    checkpoints carry such values; the init's 1e-5 would deaden both
    residual branches and blind the parity leg), written by the port's
    exporter. `edit(hf_state)` changes the tensors before they are written."""
    params = init_vla_params(torch.Generator().manual_seed(seed), VLA_TINY)
    g = torch.Generator().manual_seed(seed + 1)
    blocks = params["vision"]["dino"]["blocks"]
    for k in ("ls1", "ls2"):
        blocks[k] = torch.rand(blocks[k].shape, generator=g) * 0.9 + 0.1
    if edit is None:
        chip_smoke.export_checkpoint(params, VLA_TINY, str(path), "vla-tiny", chip_smoke.CKPT_STATS)
        return params
    sd = chip_smoke.hf_state(params, VLA_TINY)
    edit(sd)
    chip_smoke.write_safetensors(str(path / "model.safetensors"), sd)
    return params


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("verify_ckpt")
    write_tiny(path, seed=2)
    return path


@pytest.mark.parametrize("name", ["vla-tiny", "openvla-7b"])
def test_manifest_rules_equal_jax(name):
    """The golden manifest from the config alone: the same rules, names,
    shapes and order as the JAX package's (no tensors are read)."""
    def rules(mod, cfg):
        return [(r.names, r.shapes, r.optional) for r in mod.expected_checkpoint_rules(cfg)]

    got, want = rules(tverify, get_config(name)), rules(jverify, jax_get_config(name))
    assert got == want
    llm = get_config(name).llm
    assert sum(r[0][0].startswith("language_model.") for r in got) == 3 + 9 * llm.num_layers


def test_headers_and_manifest_report_equal_jax(tiny_dir):
    assert tverify.read_safetensors_headers(str(tiny_dir)) == jverify.read_safetensors_headers(str(tiny_dir))
    got = tverify.manifest_report(str(tiny_dir), VLA_TINY)
    assert got.to_json() == jverify.manifest_report(str(tiny_dir), J_TINY).to_json()
    assert got.ok and got.dtypes == {"F32": got.n_tensors}
    # the exporter writes the dead final blocks and norms too: unconsumed
    dead = (f"vision_backbone.featurizer.blocks.{VLA_TINY.dino.depth - 1}.",
            f"vision_backbone.fused_featurizer.blocks.{VLA_TINY.siglip.depth - 1}.")
    assert got.unconsumed and all(n.startswith(dead) or ".norm." in n for n in got.unconsumed)


def test_manifest_reports_all_missing_and_misshaped_as_jax(tmp_path):
    def edit(sd):
        del sd["projector.fc2.bias"]
        del sd["language_model.model.layers.0.self_attn.q_proj.weight"]
        sd["vision_backbone.featurizer.blocks.0.attn.proj.weight"] = torch.zeros(3, 3)

    write_tiny(tmp_path, seed=1, edit=edit)
    got = tverify.manifest_report(str(tmp_path), VLA_TINY)
    assert got.to_json() == jverify.manifest_report(str(tmp_path), J_TINY).to_json()
    assert not got.ok and len(got.missing) == 2 and len(got.shape_mismatches) == 1
    state = read_state_dict(str(tmp_path))
    assert tverify.manifest_report_from_state(state, VLA_TINY).to_json() == got.to_json()


def test_parity_passes_on_a_checkpoint_the_port_writes(tiny_dir):
    state = read_state_dict(str(tiny_dir))
    pr = tverify.parity_report(state, VLA_TINY, seed=3)
    assert set(pr) == {"dino", "siglip", "projector", "llm", "full"}
    for name, d in pr.items():
        assert d["ok"] and d["max_rel"] < 5e-3, (name, d)


def test_parity_catches_a_corrupted_conversion(tiny_dir):
    """A converter bug (a transposed attention projection in the port's
    tree) fails parity: the reference reads the raw checkpoint itself."""
    state = read_state_dict(str(tiny_dir))
    params = convert_state_dict(state, VLA_TINY)
    params["vision"]["dino"]["blocks"]["proj_w"] = params["vision"]["dino"]["blocks"]["proj_w"].transpose(1, 2)
    pr = tverify.parity_report(state, VLA_TINY, params=params, modules=("dino", "siglip"), seed=5)
    assert not pr["dino"]["ok"], pr["dino"]
    assert pr["siglip"]["ok"], pr["siglip"]
    layers = dict(convert_state_dict(state, VLA_TINY)["llm"]["layers"])
    params = convert_state_dict(state, VLA_TINY)
    params["llm"]["layers"] = dict(layers, o_w=layers["o_w"].flip(0))  # layers swapped
    assert not tverify.parity_report(state, VLA_TINY, params=params, modules=("llm",))["llm"]["ok"]


def test_clip_single_tower_parity():
    """The CLIP-family tower (pre-norm, quick-GELU, bias-less patch embed)
    with a 2-layer projector: parity passes and a corrupted tower fails."""
    from roboticattack_tpu.models import TINY_LLAMA as J_LLAMA
    from roboticattack_tpu.models.config import ViTConfig as JViT
    from roboticattack_tpu.models.config import VLAConfig as JVLA
    from roboticattack_torch.models import TINY_LLAMA
    from roboticattack_torch.models.config import ViTConfig, VLAConfig
    from test_convert_roundtrip import _t, _vit_state

    kw = dict(embed_dim=32, depth=3, num_heads=2, mlp_hidden=64, patch_size=14, image_size=56,
              use_cls_token=True, pre_norm=True, use_quick_gelu=True, ln_eps=1e-5)
    jcfg = JVLA(name="tiny-clip", dino=JViT(**kw), siglip=None, llm=J_LLAMA, dtype="float32")
    cfg = VLAConfig(name="tiny-clip", dino=ViTConfig(**kw), siglip=None, llm=TINY_LLAMA, dtype="float32")
    params = jax.device_get(jax_init_vla_params(jax.random.key(12), jcfg))
    sd = _vit_state(params["vision"]["dino"], "vision_backbone.featurizer.", jcfg.dino, use_ls=False)
    tower = params["vision"]["dino"]
    sd["vision_backbone.featurizer.norm_pre.weight"] = np.asarray(tower["norm_pre"]["scale"])
    sd["vision_backbone.featurizer.norm_pre.bias"] = np.asarray(tower["norm_pre"]["bias"])
    for i in (1, 2):
        sd[f"projector.fc{i}.weight"] = _t(params["projector"][f"fc{i}_w"])
        sd[f"projector.fc{i}.bias"] = np.asarray(params["projector"][f"fc{i}_b"])
    state = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}
    llm, pre = params_from_jax(params["llm"]), "language_model."
    state[pre + "model.embed_tokens.weight"] = llm["embed"]
    state[pre + "model.norm.weight"] = llm["norm"]
    state[pre + "lm_head.weight"] = llm["lm_head"].T
    from roboticattack_torch.models.convert import LLAMA_LAYER_NAMES

    for i in range(TINY_LLAMA.num_layers):
        for k, name in LLAMA_LAYER_NAMES.items():
            w = llm["layers"][k][i]
            state[f"{pre}model.layers.{i}.{name}"] = w.T if k.endswith("_w") else w
    pr = tverify.parity_report(state, cfg, modules=("dino", "projector", "llm", "full"), seq=16, seed=13)
    assert all(d["ok"] for d in pr.values()), pr
    bad = convert_state_dict(state, cfg)
    bad["vision"]["dino"]["blocks"]["proj_w"] = bad["vision"]["dino"]["blocks"]["proj_w"].transpose(1, 2)
    assert not tverify.parity_report(state, cfg, params=bad, modules=("dino",), seed=13)["dino"]["ok"]


def test_true_fp32_switches_tf32_off_and_back():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        with tverify.true_fp32():
            assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def test_tma_smoke_descends():
    params = init_vla_params(torch.Generator().manual_seed(6), VLA_TINY)
    sm = tverify.tma_smoke(params, VLA_TINY, iters=20, batch_size=2, lr=5e-2, seed=6)
    assert len(sm["losses"]) == 20 and np.all(np.isfinite(sm["losses"]))
    assert sm["decreased"], sm["losses"]
    assert sm["patch"].shape == (50, 50, 3) and 0.0 <= sm["patch"].min() and sm["patch"].max() <= 1.0


MODES = ["int8", "w8a8", "w8a8+kv8+vt128", "int4+kv8", "kv8", "none+kv8", "int8+kv4", "kv4", "int8+vt128",
         "vt64", "int4+kv4+vt128", "int4+qk", "int4+kv4+qk", "int8+qk", "kv8+qk", "fp8", "int8+fp8kv",
         "int8+vt0", "int8+kv8+kv4", "int4+qk+qk", "vt", "int4+jw"]


@pytest.mark.parametrize("mode", MODES)
def test_parse_quant_mode_equals_jax(mode):
    """The same grammar: equal results, or the same error and message."""
    try:
        want = jverify.parse_quant_mode(mode)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tverify.parse_quant_mode(mode)
        assert str(got.value) == str(e)
        return
    assert tverify.parse_quant_mode(mode) == want


def test_quant_decode_report_equals_jax():
    """Same weights and seed: the same per-mode agreement, action deltas and
    gate as the JAX leg. (The int4 tail through the kernel's wrapper, int4+qk,
    is held to JAX's Pallas kernel by test_torch_q4_matmul.py and
    test_torch_decode_options.py; here it runs in the CLI tests.)"""
    jparams = jax.device_get(jax_init_vla_params(jax.random.key(11), J_TINY))
    modes = ("int8", "vt8")
    want = jverify.quant_decode_report(jparams, J_TINY, modes=modes, n_batches=1, min_agreement=0.5)
    got = tverify.quant_decode_report(params_from_jax(jparams), VLA_TINY, modes=modes, n_batches=1,
                                      min_agreement=0.5)
    assert got == want
    assert "ok" in got["int8"] and "ok" not in got["vt8"]
    # tp picks the int4 group size of the deployment (tiny: 32 at tp=2)
    want = jverify.quant_decode_report(jparams, J_TINY, modes=("int4",), n_batches=1, tp=2)
    assert tverify.quant_decode_report(params_from_jax(jparams), VLA_TINY, modes=("int4",), n_batches=1,
                                       tp=2) == want


# ------------------------------------------------------------------ the CLI
def run_cli(argv):
    from roboticattack_torch.cli.verify_checkpoint import main

    return main(argv)


def test_cli_end_to_end_on_the_cpu(tiny_dir, tmp_path):
    out = tmp_path / "verify_out"
    rc = run_cli(["--model", "vla-tiny", "--checkpoint", str(tiny_dir), "--device", "cpu",
                  "--output", str(out), "--parity-seq", "16", "--quant-modes", "int8,int4+qk",
                  "--quant-min-agreement", "0"])
    assert rc == 0
    report = json.loads((out / "verify_report.json").read_text())
    assert report["ok"] is True and report["device"] == "cpu" and report["layout"] == "safetensors"
    assert report["steps"]["manifest"]["ok"] is True
    assert set(report["steps"]["parity"]) == {"dino", "siglip", "projector", "llm", "full"}
    assert all(d["ok"] for d in report["steps"]["parity"].values())
    assert report["steps"]["smoke"]["decreased"] is True and len(report["steps"]["smoke"]["losses"]) == 20
    patch = torch.load(out / "smoke" / "patch.pt", weights_only=True)
    assert tuple(patch.shape) == (3, 50, 50)
    assert set(report["steps"]["quant"]) == {"int8", "int4+qk"}


def test_cli_fails_fast_on_a_bad_manifest(tmp_path):
    write_tiny(tmp_path, seed=8, edit=lambda sd: sd.pop("projector.fc1.weight"))
    out = tmp_path / "verify_out"
    assert run_cli(["--model", "vla-tiny", "--checkpoint", str(tmp_path), "--device", "cpu",
                    "--output", str(out)]) == 1
    report = json.loads((out / "verify_report.json").read_text())
    assert report["ok"] is False and set(report["steps"]) == {"manifest"}


def test_cli_quant_gate_rejects(tiny_dir, tmp_path):
    out = tmp_path / "verify_out_q"
    assert run_cli(["--model", "vla-tiny", "--checkpoint", str(tiny_dir), "--device", "cpu",
                    "--output", str(out), "--steps", "manifest,quant", "--quant-modes", "int8",
                    "--quant-min-agreement", "1.01"]) == 1
    report = json.loads((out / "verify_report.json").read_text())
    assert report["steps"]["manifest"]["ok"] is True and report["steps"]["quant"]["int8"]["ok"] is False


@pytest.mark.parametrize("flags,error", [
    (["--quant-modes", "fp8"], ValueError),
    (["--quant-modes", "int8+vt999"], SystemExit),
    (["--quant-tp", "3"], ValueError),
])
def test_cli_refuses_before_any_leg(tiny_dir, tmp_path, flags, error):
    with pytest.raises(error):
        run_cli(["--model", "vla-tiny", "--checkpoint", str(tiny_dir), "--device", "cpu",
                 "--output", str(tmp_path / "o")] + flags)
    assert not (tmp_path / "o" / "verify_report.json").exists()


def test_cli_asks_for_cuda_by_default(tiny_dir, tmp_path, monkeypatch):
    from roboticattack_torch.cli.verify_checkpoint import build_parser

    assert build_parser().parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_cli(["--model", "vla-tiny", "--checkpoint", str(tiny_dir), "--output", str(tmp_path / "o")])


def test_cli_accepts_a_prismatic_pt_layout(tmp_path):
    """A legacy prismatic .pt directory: the renamed in-memory state passes
    the manifest and the parity leg."""
    params = init_vla_params(torch.Generator().manual_seed(20), VLA_TINY)
    g = torch.Generator().manual_seed(21)
    for k in ("ls1", "ls2"):
        params["vision"]["dino"]["blocks"][k] = torch.rand(params["vision"]["dino"]["blocks"][k].shape,
                                                           generator=g) * 0.9 + 0.1
    inverse = {"vision_backbone.featurizer.": "vision_backbone.dino_featurizer.",
               "vision_backbone.fused_featurizer.": "vision_backbone.siglip_featurizer.",
               "projector.fc1.": "projector.projector.0.", "projector.fc2.": "projector.projector.2.",
               "projector.fc3.": "projector.projector.4.", "language_model.": "llm_backbone.llm."}
    modules = {"vision_backbone": {}, "projector": {}, "llm_backbone": {}}
    for key, val in chip_smoke.hf_state(params, VLA_TINY).items():
        for new, old in inverse.items():
            if key.startswith(new):
                key = old + key[len(new):]
                break
        module, rest = key.split(".", 1)
        modules[module][rest] = val.contiguous()
    (tmp_path / "checkpoints").mkdir()
    torch.save({"model": modules}, tmp_path / "checkpoints" / "latest-checkpoint.pt")
    out = tmp_path / "verify_out"
    assert run_cli(["--model", "vla-tiny", "--checkpoint", str(tmp_path), "--device", "cpu", "--output",
                    str(out), "--steps", "manifest,parity", "--parity-seq", "16"]) == 0
    report = json.loads((out / "verify_report.json").read_text())
    assert report["layout"] == "prismatic-pt" and report["steps"]["manifest"]["ok"] is True
    assert all(d["ok"] for d in report["steps"]["parity"].values())
    assert os.path.exists(out / "verify_report.json")


def test_chip_smoke_verify_phase_on_the_cpu(monkeypatch, tmp_path):
    """chip_smoke.phase_verify rehearsed on vla-tiny (flash attention and
    remat, the kernels' plain versions counted): the CLI's exit 0, the
    manifest's rule count, every parity module, the smoke's B1/B2 count and
    the quant leg's B4 count, each leg timed; the smoke's first step against the
    plain attention path and each int4+qk decode against the plain int4 tail."""
    from test_torch_eval_libero import rehearse_on_the_cpu

    root = rehearse_on_the_cpu(monkeypatch, tmp_path)
    out = chip_smoke.phase_verify("CPU", root)
    layers = VLA_TINY.llm.num_layers
    assert out["rules"] == len(tverify.expected_checkpoint_rules(VLA_TINY))
    assert set(out["parity"]) == {"dino", "siglip", "projector", "llm", "full"}
    assert out["smoke_launches"] == {"fwd": 2 * layers * 20, "bwd": layers * 20}
    assert out["quant_launches"] == 2 * 6 * layers * 7
    assert set(out["legs"]) == {"parity_report", "tma_smoke", "quant_decode_report"}
    rel, cos = out["legs"]["tma_smoke"]["against_plain"]  # the smoke's first step on plain attention
    assert rel <= 1e-2 and cos >= 0.99
    assert len(out["quant_against_plain"]) == 2  # each int4+qk decode against the plain int4 tail
    assert all(c["rel_max"] <= chip_smoke.TAIL_LOGITS_TOL for c in out["quant_against_plain"])

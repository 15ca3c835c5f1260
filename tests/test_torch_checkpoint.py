"""Slice 4 of the port on the CPU: its safetensors reader against the
`safetensors` library and the JAX package's header parser, its converter
bit for bit against the JAX `load_checkpoint_dir` on the same tiny
directories, the norm stats, the failures of a missing directory, shard or
tensor, `load_policy` and both CLIs from a checkpoint directory, and
`chip_smoke.py`'s exporter and safetensors writer."""

import ast
import dataclasses
import json
import os
import re
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import jax
import pytest
import torch

from roboticattack_tpu.eval.policy import load_policy as jax_load_policy
from roboticattack_tpu.models import VLA_TINY as J_TINY
from roboticattack_tpu.models import init_vla_params as jax_init_vla_params
from roboticattack_tpu.models.config import VLAConfig as JVLAConfig
from roboticattack_tpu.models.convert import load_checkpoint_dir as jax_load_checkpoint_dir
from roboticattack_tpu.models.verify import read_safetensors_headers as jax_read_headers
from roboticattack_torch.cli import attack as attack_cli
from roboticattack_torch.eval.policy import VLAPolicy, get_action, get_model, load_policy
from roboticattack_torch.models import safetensors_io as stio
from roboticattack_torch.models.bridge import params_from_jax
from roboticattack_torch.models.config import VLA_TINY, VLAConfig
from roboticattack_torch.models.convert import load_checkpoint_dir, load_norm_stats
from roboticattack_torch.models.vlm import init_vla_params
from roboticattack_torch.utils.prompting import WordStubTokenizer
from test_convert_roundtrip import _full_state, _vit_state

import chip_smoke

REPO = Path(__file__).resolve().parents[1]
STATS = {"bridge_orig": {"action": {"q01": [-0.3] * 7, "q99": [0.6] * 7,
                                    "mask": [True] * 6 + [False]}}}
TASKS = ["pick up the block", "close the drawer"]


def _frames(n, seed=0, size=56):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8)


def _write_dir(path, state, dtype=torch.bfloat16, shards=2, stats=STATS):
    """{HF name: numpy} -> `shards` safetensors files (the `safetensors`
    library's writer) with an index, in `dtype`, plus dataset statistics."""
    from safetensors.torch import save_file

    keys = sorted(state)
    weight_map = {}
    for k in range(shards):
        part = keys[k::shards]
        fname = f"model-{k + 1:05d}-of-{shards:05d}.safetensors"
        save_file({n: torch.from_numpy(np.array(state[n], order="C")).to(dtype) for n in part},
                  str(path / fname))
        weight_map.update(dict.fromkeys(part, fname))
    (path / "model.safetensors.index.json").write_text(json.dumps({"weight_map": weight_map}))
    if stats is not None:
        (path / "dataset_statistics.json").write_text(json.dumps(stats))
    return path


def _assert_trees_equal(got, want, prefix=""):
    assert set(got) == set(want), (prefix, sorted(got), sorted(want))
    for k, w in want.items():
        if isinstance(w, dict):
            _assert_trees_equal(got[k], w, f"{prefix}{k}.")
        else:
            g = got[k]
            assert g.dtype == w.dtype and g.shape == w.shape, (prefix + k, g.dtype, w.dtype)
            assert torch.equal(g, w), prefix + k


def _jax_tree(path, cfg):
    return params_from_jax(jax.device_get(jax_load_checkpoint_dir(str(path), cfg)), "cpu")


@pytest.fixture(scope="module")
def jax_params():
    return jax.device_get(jax_init_vla_params(jax.random.key(21), J_TINY))


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory, jax_params):
    """VLA_TINY in bf16 shards, two of them, with an index."""
    return _write_dir(tmp_path_factory.mktemp("tiny_ckpt"), _full_state(jax_params))


# ------------------------------------------------------------------ reader
ALL_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}


def _every_dtype(seed=0):
    g = torch.Generator().manual_seed(seed)
    out = {}
    for i, (name, dtype) in enumerate(ALL_DTYPES.items()):
        shape = (i % 3 + 1, 5 - i % 4)
        if dtype.is_floating_point:
            out[name.lower()] = torch.randn(shape, generator=g).to(dtype)
        elif dtype == torch.bool:
            out[name.lower()] = torch.rand(shape, generator=g) > 0.5
        else:
            out[name.lower()] = torch.randint(0, 100, shape, generator=g).to(dtype)
    out["scalar"] = torch.tensor(2.5)
    out["empty"] = torch.zeros(0, 3, dtype=torch.bfloat16)
    return out


@pytest.mark.parametrize("shards", [1, 2])
def test_reader_matches_the_safetensors_library_for_every_dtype(tmp_path, shards):
    from safetensors.torch import load_file, save_file

    tensors = _every_dtype()
    keys = sorted(tensors)
    files = []
    for k in range(shards):
        fname = f"model-{k + 1:05d}-of-{shards:05d}.safetensors"
        save_file({n: tensors[n] for n in keys[k::shards]}, str(tmp_path / fname))
        files.append(fname)
    if shards > 1:
        wm = {n: files[i % shards] for i, n in enumerate(keys)}
        (tmp_path / "model.safetensors.index.json").write_text(json.dumps({"weight_map": wm}))
    assert stio.checkpoint_shard_files(str(tmp_path)) == files
    got = stio.read_state_dict(str(tmp_path))
    want = {}
    for f in files:
        want.update(load_file(str(tmp_path / f)))
    assert set(got) == set(want) == set(tensors)
    for n in tensors:
        assert got[n].dtype == want[n].dtype and got[n].shape == want[n].shape, n
        assert torch.equal(got[n], want[n]), n
    assert stio.read_safetensors_headers(str(tmp_path)) == jax_read_headers(str(tmp_path))
    assert {n: ALL_DTYPES[d] for n, (d, _) in stio.read_safetensors_headers(str(tmp_path)).items()} \
        == {n: t.dtype for n, t in tensors.items()}


def test_reader_views_are_copy_on_write(tmp_path):
    from safetensors.torch import load_file, save_file

    save_file({"w": torch.arange(6, dtype=torch.float32)}, str(tmp_path / "m.safetensors"))
    view = stio.load_file(str(tmp_path / "m.safetensors"))["w"]
    view[0] = 100.0
    assert load_file(str(tmp_path / "m.safetensors"))["w"][0] == 0.0
    assert stio.load_file(str(tmp_path / "m.safetensors"))["w"][0] == 0.0


def _raw_file(path, header: dict, data: bytes):
    blob = json.dumps(header).encode()
    path.write_bytes(len(blob).to_bytes(8, "little") + blob + data)


@pytest.mark.parametrize("header,data,match", [
    ({"a": {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]}}, b"\0" * 12, "holds 12"),
    ({"a": {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]}}, b"\0" * 4, "holds 4"),
    ({"a": {"dtype": "F32", "shape": [2], "data_offsets": [0, 4]}}, b"\0" * 4, "do not cover"),
    ({"a": {"dtype": "F32", "shape": [1], "data_offsets": [4, 8]}}, b"\0" * 8, "do not cover"),
    ({"a": {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]},
      "b": {"dtype": "F32", "shape": [1], "data_offsets": [4, 8]}}, b"\0" * 8, "do not cover"),
    ({"a": {"dtype": "C64", "shape": [1], "data_offsets": [0, 8]}}, b"\0" * 8, "C64"),
])
def test_reader_refuses_a_header_that_does_not_cover_the_data(tmp_path, header, data, match):
    _raw_file(tmp_path / "m.safetensors", header, data)
    with pytest.raises(ValueError, match=match):
        stio.read_state_dict(str(tmp_path))


# ------------------------------------------------------------------ converter
def _clip_cfg(jcfg):
    """A pre-norm (CLIP-style) single tower over the tiny Llama."""
    dino = dataclasses.replace(jcfg.dino, num_reg_tokens=0, use_layerscale=False, pre_norm=True,
                               use_quick_gelu=True, ln_eps=1e-5)
    return dataclasses.replace(jcfg, name="tiny-clip", dino=dino, siglip=None)


def _case(name, jax_params):
    """(jax config, HF-name state, dtype) of one converter case."""
    if name == "vla_tiny_f32":
        return J_TINY, _full_state(jax_params), torch.float32
    if name == "vla_tiny_bf16":
        return J_TINY, _full_state(jax_params), torch.bfloat16
    if name == "embed_class_pos":
        sd = _full_state(jax_params)
        pos = sd["vision_backbone.featurizer.pos_embed"]
        cls_pos = np.random.default_rng(0).standard_normal((1, 1, pos.shape[-1])).astype(pos.dtype)
        sd["vision_backbone.featurizer.pos_embed"] = np.concatenate([cls_pos, pos], axis=1)
        return J_TINY, sd, torch.bfloat16
    if name == "pre_norm_two_layer_projector":
        cfg = _clip_cfg(J_TINY)
        tower = jax.device_get(jax_init_vla_params(jax.random.key(5), cfg))
        pre = "vision_backbone.featurizer."
        sd = _vit_state(tower["vision"]["dino"], pre, cfg.dino, use_ls=False)
        sd[pre + "norm_pre.weight"] = np.asarray(tower["vision"]["dino"]["norm_pre"]["scale"])
        sd[pre + "norm_pre.bias"] = np.asarray(tower["vision"]["dino"]["norm_pre"]["bias"])
        for i in (1, 2):
            sd[f"projector.fc{i}.weight"] = np.asarray(tower["projector"][f"fc{i}_w"]).T
            sd[f"projector.fc{i}.bias"] = np.asarray(tower["projector"][f"fc{i}_b"])
        # the same tiny Llama as VLA_TINY: take its names and values from there
        sd.update({k: v for k, v in _full_state(jax_params).items() if k.startswith("language_model.")})
        return cfg, sd, torch.bfloat16
    if name == "resampled_pos_embed":
        # saved at 56px (grid 4), loaded into 84px towers (grid 6)
        cfg = dataclasses.replace(J_TINY, dino=dataclasses.replace(J_TINY.dino, image_size=84),
                                  siglip=dataclasses.replace(J_TINY.siglip, image_size=84))
        return cfg, _full_state(jax_params), torch.bfloat16
    if name == "layerscale_gamma":
        sd = {re.sub(r"\.(ls[12])\.scale_factor$", r".\1.gamma", k): v
              for k, v in _full_state(jax_params).items()}
        assert any(k.endswith("ls1.gamma") for k in sd)
        return J_TINY, sd, torch.bfloat16
    raise KeyError(name)


def _torch_cfg(jcfg):
    """The port's config with the JAX config's fields."""
    from roboticattack_torch.models import config as tc

    def conv(c, cls):
        return cls(**dataclasses.asdict(c))

    return VLAConfig(
        name=jcfg.name, dino=conv(jcfg.dino, tc.ViTConfig),
        siglip=None if jcfg.siglip is None else conv(jcfg.siglip, tc.ViTConfig),
        llm=conv(jcfg.llm, tc.LlamaConfig),
        **{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(JVLAConfig)
           if f.name not in ("name", "dino", "siglip", "llm")},
    )


@pytest.mark.parametrize("case", [
    "vla_tiny_f32", "vla_tiny_bf16", "embed_class_pos", "pre_norm_two_layer_projector",
    "resampled_pos_embed", "layerscale_gamma",
])
def test_load_checkpoint_dir_is_bit_equal_to_jax(tmp_path, jax_params, case):
    """The port's converted tree equals the JAX converter's leaf for leaf
    (dtype, shape, bits) on the same directory."""
    jcfg, state, dtype = _case(case, jax_params)
    _write_dir(tmp_path, state, dtype)
    got = load_checkpoint_dir(str(tmp_path), _torch_cfg(jcfg), device="cpu")
    _assert_trees_equal(got, _jax_tree(tmp_path, jcfg))
    if case == "resampled_pos_embed":
        assert got["vision"]["dino"]["pos_embed"].shape == (36, jcfg.dino.embed_dim)
    if case == "pre_norm_two_layer_projector":
        assert set(got["projector"]) == {"fc1_w", "fc1_b", "fc2_w", "fc2_b"}
        assert "bias" not in got["vision"]["dino"]["patch_embed"]


def test_converted_tree_equals_the_drawn_params(tiny_dir, jax_params):
    """Round trip: the JAX params, written as bf16 shards and converted by
    the port, are the params rounded to bf16."""
    got = load_checkpoint_dir(str(tiny_dir), VLA_TINY, device="cpu")
    want = params_from_jax(jax_params, "cpu")
    flat_g = dict(torch.utils._pytree.tree_flatten_with_path(got)[0])
    for path, w in torch.utils._pytree.tree_flatten_with_path(want)[0]:
        assert torch.equal(flat_g[path], w.to(torch.bfloat16)), path


def test_norm_stats_from_either_source(tmp_path):
    (tmp_path / "dataset_statistics.json").write_text(json.dumps(STATS))
    (tmp_path / "config.json").write_text(json.dumps({"norm_stats": {"other": {}}}))
    assert load_norm_stats(str(tmp_path)) == STATS
    os.remove(tmp_path / "dataset_statistics.json")
    assert load_norm_stats(str(tmp_path)) == {"other": {}}


def test_missing_directory_shard_or_tensor_raises(tmp_path, jax_params):
    with pytest.raises(FileNotFoundError, match="/nonexistent/ckpt"):
        load_checkpoint_dir("/nonexistent/ckpt", VLA_TINY, device="cpu")
    with pytest.raises(FileNotFoundError, match="no \\*.safetensors shards"):
        load_checkpoint_dir(str(tmp_path), VLA_TINY, device="cpu")
    state = _full_state(jax_params)
    del state["language_model.model.layers.1.mlp.up_proj.weight"]
    _write_dir(tmp_path, state)
    with pytest.raises(KeyError, match="language_model.model.layers.1.mlp.up_proj.weight"):
        load_checkpoint_dir(str(tmp_path), VLA_TINY, device="cpu")
    os.remove(tmp_path / "model-00002-of-00002.safetensors")
    with pytest.raises(FileNotFoundError, match="model-00002-of-00002.safetensors"):
        load_checkpoint_dir(str(tmp_path), VLA_TINY, device="cpu")


def test_load_checkpoint_dir_on_cuda_raises_without_a_card(monkeypatch, tiny_dir):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_checkpoint_dir(str(tiny_dir), VLA_TINY)


# ------------------------------------------------------------------ policy
def test_load_policy_from_a_checkpoint_matches_jax(tiny_dir):
    """`load_policy(dir, "vla-tiny", device="cpu")` gives the JAX
    `load_policy` actions on the same directory (the serving parity
    tolerance), and is bit-equal to a VLAPolicy built from the same
    converted tree."""
    frames = _frames(2, seed=4)
    got_pol = load_policy(str(tiny_dir), "vla-tiny", device="cpu")
    want_pol = jax_load_policy(str(tiny_dir), "vla-tiny")
    got = got_pol.get_action_multi(frames, TASKS)
    want = want_pol.get_action_multi(frames, TASKS)
    np.testing.assert_array_equal(got_pol.last_tokens, np.asarray(want_pol.last_tokens))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)

    tree = load_checkpoint_dir(str(tiny_dir), VLA_TINY, device="cpu")
    tree = torch.utils._pytree.tree_map(lambda t: t.float(), tree)
    direct = VLAPolicy(tree, VLA_TINY, WordStubTokenizer(), STATS, device="cpu")
    np.testing.assert_array_equal(direct.get_action_multi(frames, TASKS), got)
    np.testing.assert_array_equal(direct.last_tokens, got_pol.last_tokens)

    # the reference's dispatch shims
    shim = get_model(str(tiny_dir), model_name="vla-tiny", device="cpu")
    np.testing.assert_array_equal(get_action(shim, {"full_image": frames[0]}, TASKS[0]), got[0])
    with pytest.raises(ValueError, match="model family"):
        get_model(str(tiny_dir), model_family="llava")


# ------------------------------------------------------------------ CLIs
def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def test_serve_cli_serves_a_checkpoint(tiny_dir):
    cmd = [sys.executable, "-m", "roboticattack_torch.cli.serve", "--checkpoint", str(tiny_dir),
           "--model", "vla-tiny", "--device", "cpu", "--port", "0", "--max_batch", "2",
           "--no_warmup"]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        base, deadline = None, time.monotonic() + 120
        while base is None and time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            m = re.search(r"serving on (http://\S+)", line)
            base = m and m.group(1)
        assert base, "the server did not report its address"
        frame = _frames(1, seed=6)[0]
        code, body = _post(base + "/act", {"task": TASKS[0], "image": frame.tolist()})
        assert code == 200 and len(body["action"]) == 7 and np.all(np.isfinite(body["action"]))
        want = load_policy(str(tiny_dir), "vla-tiny", device="cpu").get_action(frame, TASKS[0])
        np.testing.assert_allclose(body["action"], want, rtol=0, atol=1e-12)
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def _train_losses(out_dir):
    lines = [json.loads(ln) for ln in (out_dir / "run-metrics.jsonl").read_text().splitlines()]
    return [ln["TRAIN_loss"] for ln in lines if "TRAIN_loss" in ln]


def test_attack_cli_from_a_checkpoint_equals_the_seeded_run(tmp_path):
    """chip_smoke's check on the CPU: the seeded weights of `--seed`,
    exported in the released layout, give `--checkpoint` step losses equal
    to the seeded run's."""
    seed = 3
    params = init_vla_params(torch.Generator().manual_seed(seed), VLA_TINY)
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    chip_smoke.export_checkpoint(params, VLA_TINY, str(ckpt), "vla-tiny", STATS)
    argv = ["--attack", "uada", "--device", "cpu", "--model", "vla-tiny", "--dataset", "dummy",
            "--iter", "2", "--innerLoop", "2", "--bs", "2", "--eval_every", "1",
            "--eval_batches", "1", "--seed", str(seed)]
    attack_cli.main(argv + ["--checkpoint", str(ckpt), "--output", str(tmp_path / "a")])
    attack_cli.main(argv + ["--output", str(tmp_path / "b")])
    got, want = _train_losses(tmp_path / "a"), _train_losses(tmp_path / "b")
    assert len(got) == 2 and np.all(np.isfinite(got))
    assert got == want


# ------------------------------------------------------------------ chip_smoke's exporter
def test_chip_smoke_exporter_round_trips_through_the_converter(tmp_path):
    """`chip_smoke.export_checkpoint` writes the released layout (3 shards,
    index, config.json naming the model, dataset_statistics.json, the dead
    final ViT blocks and norms, a zero cls row in DINOv2's pos_embed): the
    port's converter gives every leaf equal to the drawn params, and the
    `safetensors` library reads the files identically."""
    from safetensors.torch import load_file

    params = init_vla_params(torch.Generator().manual_seed(8), VLA_TINY)
    nbytes = chip_smoke.export_checkpoint(params, VLA_TINY, str(tmp_path), "vla-tiny", STATS)
    shards = sorted(f for f in os.listdir(tmp_path) if f.endswith(".safetensors"))
    assert shards == [f"model-0000{k}-of-00003.safetensors" for k in (1, 2, 3)]
    assert nbytes == sum(os.path.getsize(tmp_path / f) for f in shards)
    assert json.loads((tmp_path / "config.json").read_text())["model_id"] == "vla-tiny"
    assert load_norm_stats(str(tmp_path)) == STATS
    index = json.loads((tmp_path / "model.safetensors.index.json").read_text())["weight_map"]
    headers = stio.read_safetensors_headers(str(tmp_path))
    assert set(index) == set(headers)
    depth = VLA_TINY.dino.depth
    assert f"vision_backbone.featurizer.blocks.{depth - 1}.attn.qkv.weight" in headers
    assert "vision_backbone.featurizer.norm.weight" in headers
    assert headers["vision_backbone.featurizer.pos_embed"][1] == (1, VLA_TINY.dino.num_patches + 1, 32)

    assert chip_smoke.check_tree_equal(load_checkpoint_dir(str(tmp_path), VLA_TINY, device="cpu"),
                                       params) > 40
    mine = stio.read_state_dict(str(tmp_path))
    for f in shards:
        for name, t in load_file(str(tmp_path / f)).items():
            assert mine[name].dtype == t.dtype and torch.equal(mine[name], t), name
    # and the JAX converter reads the same directory to the same values
    jtree = _jax_tree(tmp_path, J_TINY)
    _assert_trees_equal(load_checkpoint_dir(str(tmp_path), VLA_TINY, device="cpu"), jtree)


def test_chip_smoke_writer_matches_the_safetensors_library(tmp_path):
    from safetensors.torch import load_file

    tensors = _every_dtype(seed=1)
    n = chip_smoke.write_safetensors(str(tmp_path / "m.safetensors"), tensors)
    assert n == os.path.getsize(tmp_path / "m.safetensors")
    back = load_file(str(tmp_path / "m.safetensors"))
    for name, t in tensors.items():
        assert back[name].dtype == t.dtype and torch.equal(back[name], t), name


# ------------------------------------------------------------------ guards
def _module_and_function_imports(path: Path):
    """(module, is_top_level) for every import of a file."""
    tree = ast.parse(path.read_text(), filename=str(path))
    nested = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            nested.update(id(n) for n in ast.walk(node) if n is not node)
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names = [node.module]
        for name in names:
            yield name.split(".")[0], id(node) not in nested


def test_port_never_imports_safetensors_and_imports_hf_lazily():
    files = sorted((REPO / "roboticattack_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    bad = []
    for f in files:
        for mod, top in _module_and_function_imports(f):
            if mod in ("safetensors", "ml_dtypes") or (top and mod in ("transformers", "huggingface_hub")):
                bad.append(f"{f.relative_to(REPO)}: {mod}")
    assert not bad, bad

"""The port's model zoo against the JAX package's on the CPU: every registry
ID and name, `build_config` field for field, `hub_files`, descriptions, the
image processor per ID, `load` through a mock hub (the OpenVLA safetensors
layout and the legacy prismatic `.pt` layout), the Prismatic processor for
each resize strategy and tower statistics, the prompt builders, and the HF
tokenizer adapter on a tiny tokenizer."""

import dataclasses
import json

import numpy as np
import jax
import pytest
import torch

from roboticattack_tpu.models import VLA_TINY as J_TINY
from roboticattack_tpu.models import init_vla_params as jax_init_vla_params
from roboticattack_tpu.models import processing as jproc
from roboticattack_tpu.models import registry as jreg
from roboticattack_tpu.utils import prompting as jprompt
from roboticattack_torch.models import processing as tproc
from roboticattack_torch.models import registry as treg
from roboticattack_torch.models.bridge import params_from_jax
from roboticattack_torch.models.config import VLA_TINY
from roboticattack_torch.utils import prompting as tprompt
from test_convert_roundtrip import _full_state

NAMES = jreg.available_model_names()


def test_registry_ids_and_names_match_jax():
    assert treg.available_models() == jreg.available_models()
    assert treg.available_model_names() == NAMES
    assert len(treg.available_models()) >= 54
    with pytest.raises(ValueError, match="not-a-model"):
        treg.get_model_description("not-a-model")
    for fn in (treg.build_config, treg.hub_files, treg.make_image_processor):
        with pytest.raises(KeyError, match="not-a-model"):
            fn("not-a-model")


@pytest.mark.parametrize("name", NAMES)
def test_each_zoo_entry_matches_jax(name):
    """Description, hub files, the structural config (field for field, or
    UnsupportedArchitecture where JAX raises it) and the image processor's
    size, strategy and per-tower statistics."""
    assert treg.get_model_description(name) == jreg.get_model_description(name)
    assert treg.hub_files(name) == jreg.hub_files(name)
    try:
        want = dataclasses.asdict(jreg.build_config(name))
    except jreg.UnsupportedArchitecture:
        with pytest.raises(treg.UnsupportedArchitecture):
            treg.build_config(name)
    else:
        assert dataclasses.asdict(treg.build_config(name)) == want
        got_p, want_p = treg.make_image_processor(name), jreg.make_image_processor(name)
        assert dataclasses.asdict(got_p) == dataclasses.asdict(want_p)


def test_config_for_dir_matches_jax(tmp_path):
    assert treg._config_for_dir(str(tmp_path)) == treg.build_config("openvla-7b")
    (tmp_path / "config.json").write_text(json.dumps({"_name_or_path": "TRI-ML/llama2+13b"}))
    got, want = treg._config_for_dir(str(tmp_path)), jreg._config_for_dir(str(tmp_path))
    assert dataclasses.asdict(got) == dataclasses.asdict(want) and got.llm.num_layers == 40


def test_prismatic_rename_shim_matches_jax():
    keys = {
        "vision_backbone.dino_featurizer.blocks.0.attn.qkv.weight": 1,
        "vision_backbone.siglip_featurizer.pos_embed": 2,
        "vision_backbone.clip_featurizer.cls_token": 3,
        "projector.projector.0.weight": 4, "projector.projector.2.bias": 5,
        "projector.projector.4.weight": 6,
        "llm_backbone.llm.model.layers.0.self_attn.q_proj.weight": 7,
        "other.key": 8,
    }
    assert treg.prismatic_to_hf_names(keys) == jreg.prismatic_to_hf_names(keys)


# ------------------------------------------------------------------ load
@pytest.fixture(scope="module")
def jax_params():
    return jax.device_get(jax_init_vla_params(jax.random.key(31), J_TINY))


def _assert_trees_equal(got, want, prefix=""):
    assert set(got) == set(want), prefix
    for k, w in want.items():
        if isinstance(w, dict):
            _assert_trees_equal(got[k], w, f"{prefix}{k}.")
        else:
            assert got[k].dtype == w.dtype and torch.equal(got[k], w), prefix + k


def test_load_openvla_id_via_mock_hub(tmp_path, jax_params):
    from safetensors.numpy import save_file

    sd = {k: np.array(v, np.float32, order="C") for k, v in _full_state(jax_params).items()}
    save_file(sd, str(tmp_path / "model-00001-of-00001.safetensors"))
    stats = {"bridge_orig": {"action": {"q01": [0.0] * 7, "q99": [1.0] * 7}}}
    (tmp_path / "dataset_statistics.json").write_text(json.dumps(stats))
    calls = []

    def fake_hub(repo_id, patterns, cache_dir, hf_token):
        calls.append((repo_id, patterns))
        return str(tmp_path)

    params, cfg, got_stats = treg.load("openvla-7b", download_fn=fake_hub, config=VLA_TINY,
                                       device="cpu")
    jparams, _, jstats = jreg.load("openvla-7b", download_fn=fake_hub, config=J_TINY)
    assert calls[0] == calls[1] == ("openvla/openvla-7b", jreg.hub_files("openvla-7b")[1])
    assert cfg is VLA_TINY and got_stats == jstats == stats
    _assert_trees_equal(params, params_from_jax(jax.device_get(jparams)))
    _assert_trees_equal(params, params_from_jax(jax_params))
    # a local directory is used in place, with the given config
    local, _, _ = treg.load(str(tmp_path), config=VLA_TINY, device="cpu")
    _assert_trees_equal(local, params)
    with pytest.raises(KeyError, match="neither a local directory"):
        treg.load("no-such-model", device="cpu")


def test_load_prismatic_id_via_mock_hub(tmp_path, jax_params):
    """The legacy layout: a torch .pt holding {'model': {module: state}}
    under vlms/prismatic.py's module names, renamed by the shim."""
    inverse = {
        "vision_backbone.featurizer.": "vision_backbone.dino_featurizer.",
        "vision_backbone.fused_featurizer.": "vision_backbone.siglip_featurizer.",
        "projector.fc1.": "projector.projector.0.", "projector.fc2.": "projector.projector.2.",
        "projector.fc3.": "projector.projector.4.", "language_model.": "llm_backbone.llm.",
    }
    modules = {"vision_backbone": {}, "projector": {}, "llm_backbone": {}}
    for key, val in _full_state(jax_params).items():
        for new, old in inverse.items():
            if key.startswith(new):
                key = old + key[len(new):]
                break
        module, rest = key.split(".", 1)
        modules[module][rest] = torch.from_numpy(np.array(val, np.float32, order="C"))
    model_id = "prism-dinosiglip-224px+7b"
    (tmp_path / model_id / "checkpoints").mkdir(parents=True)
    torch.save({"model": modules}, tmp_path / model_id / "checkpoints" / "latest-checkpoint.pt")

    params, cfg, stats = treg.load(model_id, download_fn=lambda *a: str(tmp_path),
                                   config=VLA_TINY, device="cpu")
    jparams, _, _ = jreg.load(model_id, download_fn=lambda *a: str(tmp_path), config=J_TINY)
    assert stats is None and cfg is VLA_TINY
    _assert_trees_equal(params, params_from_jax(jax.device_get(jparams)))


# ------------------------------------------------------------------ processor
TOWER_STATS = {
    "openvla": (tproc.DINO_MEAN, tproc.SIGLIP_MEAN), "dinoclip": (tproc.IMAGENET_MEAN, tproc.CLIP_MEAN),
    "inception": (tproc.INCEPTION_MEAN,),
}
TOWER_STDS = {
    "openvla": (tproc.DINO_STD, tproc.SIGLIP_STD), "dinoclip": (tproc.IMAGENET_STD, tproc.CLIP_STD),
    "inception": (tproc.INCEPTION_STD,),
}


@pytest.mark.parametrize("stats", sorted(TOWER_STATS))
@pytest.mark.parametrize("strategy", ["resize-naive", "resize-crop", "letterbox"])
@pytest.mark.parametrize("hw", [(100, 300), (407, 301), (224, 224)])
def test_image_processor_matches_jax(strategy, stats, hw):
    img = np.random.default_rng(sum(hw)).integers(0, 256, (*hw, 3), dtype=np.uint8)
    kw = dict(image_size=224, image_resize_strategy=strategy, means=TOWER_STATS[stats],
              stds=TOWER_STDS[stats])
    got = tproc.PrismaticImageProcessor(**kw)(img)
    want = jproc.PrismaticImageProcessor(**kw)(img)
    assert got.dtype == np.float32 and got.shape == (len(TOWER_STATS[stats]), 224, 224, 3)
    np.testing.assert_array_equal(got, want)


def test_processor_call_matches_jax():
    rng = np.random.default_rng(3)
    images = [rng.integers(0, 256, (120, 90, 3), dtype=np.uint8) for _ in range(2)]
    texts = ["In: pick up the cup\nOut: ", "In: open the drawer and look inside\nOut: "]
    for pad_to in (None, 24):
        got = tproc.PrismaticProcessor(tprompt.WordStubTokenizer())(texts, images, pad_to=pad_to)
        want = jproc.PrismaticProcessor(jprompt.WordStubTokenizer())(texts, images, pad_to=pad_to)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(tproc.PrismaticProcessor.as_nchw6(got["pixel_values"]),
                                      jproc.PrismaticProcessor.as_nchw6(want["pixel_values"]))


# ------------------------------------------------------------------ prompts
BUILDERS = ["PurePromptBuilder", "VicunaV15ChatPromptBuilder", "LLaMa2ChatPromptBuilder",
            "MistralInstructPromptBuilder", "PhiPromptBuilder"]


@pytest.mark.parametrize("builder", BUILDERS)
def test_prompt_builder_matches_jax(builder):
    turns = [("human", "What is in <image> the picture?"), ("gpt", "A red cup."),
             ("human", "  And behind it? "), ("gpt", ""), ("human", "Thanks")]
    for system in (None, "Be brief."):
        got = getattr(tprompt, builder)("openvla", system_prompt=system)
        want = getattr(jprompt, builder)("openvla", system_prompt=system)
        for role, msg in turns:
            assert got.add_turn(role, msg) == want.add_turn(role, msg)
            assert got.get_prompt() == want.get_prompt()
            assert got.get_potential_prompt("next?") == want.get_potential_prompt("next?")
        with pytest.raises(ValueError, match="turn 5 is a 'gpt' turn"):
            got.add_turn("human", "out of turn")
    assert {k: v.__name__ for k, v in tprompt.PROMPT_BUILDERS.items()} == \
        {k: v.__name__ for k, v in jprompt.PROMPT_BUILDERS.items()}


# ------------------------------------------------------------------ tokenizer
def test_hf_tokenizer_adapter_matches_jax(tmp_path):
    tokenizers = pytest.importorskip("tokenizers")
    transformers = pytest.importorskip("transformers")
    from roboticattack_tpu.data.rlds import _tokenizer_from_checkpoint as jax_tokenizer_from_checkpoint

    words = ["<unk>", "<s>", "</s>", "In:", "Out:", "what", "action", "should", "the", "robot",
             "take", "to", "pick", "up", "cup?"]
    tok = tokenizers.Tokenizer(tokenizers.models.WordLevel(
        {w: i for i, w in enumerate(words)}, unk_token="<unk>"))
    tok.pre_tokenizer = tokenizers.pre_tokenizers.WhitespaceSplit()
    tok.post_processor = tokenizers.processors.TemplateProcessing(
        single="<s> $A", special_tokens=[("<s>", 1)])
    fast = transformers.PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="<unk>",
                                                bos_token="<s>", eos_token="</s>")
    fast.save_pretrained(str(tmp_path))

    got = tprompt.tokenizer_from_checkpoint(str(tmp_path))
    want = jax_tokenizer_from_checkpoint(str(tmp_path))
    assert isinstance(got, tprompt.HFTokenizerAdapter)
    text = "In: what action should the robot take to pick up the cup?\nOut:"
    for add_bos in (True, False):
        assert got.encode(text, add_bos=add_bos) == want.encode(text, add_bos=add_bos)
    assert got.encode(text)[0] == 1 and got.encode(text, add_bos=False)[0] == 3


@pytest.mark.parametrize("where", [None, "missing", "no_tokenizer_files"])
def test_tokenizer_from_checkpoint_falls_back_to_the_stub(tmp_path, capsys, where):
    path = {None: None, "missing": str(tmp_path / "absent"), "no_tokenizer_files": str(tmp_path)}[where]
    got = tprompt.tokenizer_from_checkpoint(path)
    assert isinstance(got, tprompt.WordStubTokenizer)
    assert "WordStubTokenizer" in capsys.readouterr().err

"""The port's run configs, LLaVA preprocessing and dataset download
(roboticattack_torch/training/{conf,preprocessing,download}.py) against the
JAX package's, exactly: every registered `VLARunConfig` and `DatasetConfig`
variant field by field (with `grad_accumulation_steps` and
`to_train_config`, which drops `unfreeze_last_llm_layer` in both); the
`ConversationDataset` ids, labels and images in the align and finetune
stages and `SplitModalitySampler`'s batches; `download_extract`'s tree from
the same local zip fixtures through an injected fetch (no network), with
the `.part` rename and `convert_to_jpg`."""

import dataclasses
import json
import os
import zipfile
from pathlib import Path

import numpy as np
import pytest

from roboticattack_tpu.training import conf as jconf
from roboticattack_tpu.training import download as jdl
from roboticattack_tpu.training import preprocessing as jpre
from roboticattack_tpu.utils.prompting import PhiPromptBuilder as JPhi
from roboticattack_tpu.utils.prompting import WordStubTokenizer as JStub
from roboticattack_torch.training import conf as tconf
from roboticattack_torch.training import download as tdl
from roboticattack_torch.training import preprocessing as tpre
from roboticattack_torch.utils.prompting import PhiPromptBuilder, WordStubTokenizer


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("root", ["VLARunConfig", "DatasetConfig"])
def test_every_registered_variant_equals_jax(root):
    jroot, troot = getattr(jconf, root), getattr(tconf, root)
    names = sorted(troot.registered_choices())
    assert names == sorted(jroot.registered_choices()) and len(names) >= 5
    for name in names:
        j, t = jroot.get_choice_class(name)(), troot.get_choice_class(name)()
        assert _fields(t) == _fields(j), name
        assert troot.get_choice_name(type(t)) == name
        if root == "VLARunConfig":
            assert t.grad_accumulation_steps == j.grad_accumulation_steps
            for steps in (None, 77):
                assert _fields(t.to_train_config(steps)) == _fields(j.to_train_config(steps)), name
    if root == "VLARunConfig":
        # the dropped flag: a last_layer variant trains no LLM layer
        cfg = troot.get_choice_class("siglip-224px-last_layer+mx-tdroid_carrot_in_bowl")()
        assert cfg.unfreeze_last_llm_layer and cfg.to_train_config().freeze_llm_backbone
        assert "unfreeze_last_llm_layer" not in _fields(cfg.to_train_config())


def _records(tmp_path: Path) -> Path:
    from PIL import Image

    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    rng = np.random.default_rng(0)
    Image.fromarray(rng.integers(0, 256, (32, 40, 3), np.uint8)).save(img_dir / "a.jpg")
    Image.fromarray(rng.integers(0, 256, (50, 30, 3), np.uint8)).save(img_dir / "b.png")
    records = [
        {"id": 0, "image": "a.jpg", "conversations": [
            {"from": "human", "value": "<image>\nwhat is shown?"},
            {"from": "gpt", "value": "a noisy square"},
            {"from": "human", "value": "and its color?"},
            {"from": "gpt", "value": "many colors"},
        ]},
        {"id": 1, "conversations": [
            {"from": "human", "value": "say hi"},
            {"from": "gpt", "value": "hi"},
        ]},
        {"id": 2, "image": "b.png", "conversations": [
            {"from": "human", "value": "describe <image>"},
            {"from": "gpt", "value": ""},
        ]},
    ]
    (tmp_path / "data.json").write_text(json.dumps(records))
    return img_dir


@pytest.mark.parametrize("builder", ["pure", "phi"])
@pytest.mark.parametrize("align", [False, True])
def test_conversation_dataset_equals_jax(tmp_path, align, builder):
    img_dir = _records(tmp_path)
    extra = ({"prompt_builder_cls": JPhi}, {"prompt_builder_cls": PhiPromptBuilder}) if builder == "phi" else ({}, {})
    j = jpre.ConversationDataset(str(tmp_path / "data.json"), str(img_dir), JStub(), align=align,
                                 image_size=64, **extra[0])
    t = tpre.ConversationDataset(str(tmp_path / "data.json"), str(img_dir), WordStubTokenizer(),
                                 align=align, image_size=64, **extra[1])
    assert len(t) == len(j) == 3 and t.get_modality_lengths() == j.get_modality_lengths()
    for i in range(len(j)):
        want, got = j[i], t[i]
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{i} {k}")
    assert t[0]["image"].shape == (64, 64, 3) and "image" not in t[1]


@pytest.mark.parametrize("batch_size,seed", [(2, 0), (3, 5)])
def test_split_modality_sampler_equals_jax(batch_size, seed):
    lengths = [(bool(i % 3), (i * 7) % 11) for i in range(23)]
    j = jpre.SplitModalitySampler(lengths, batch_size=batch_size, seed=seed)
    t = tpre.SplitModalitySampler(lengths, batch_size=batch_size, seed=seed)
    assert list(t) == list(j) and len(t) == len(j)
    for b in t:
        assert len({lengths[i][0] for i in b}) == 1


def test_registry_equals_jax():
    assert tdl.DATASET_REGISTRY == jdl.DATASET_REGISTRY


def _fixtures(tmp_path: Path) -> dict:
    """url -> bytes of each registered component of a fake dataset: a json,
    and zips of images (png and gif included)."""
    from io import BytesIO

    from PIL import Image

    def img(fmt, seed):
        buf = BytesIO()
        Image.fromarray(np.random.default_rng(seed).integers(0, 256, (8, 8, 3), np.uint8)).save(buf, fmt)
        return buf.getvalue()

    blobs = {"http://x/blob_meta.json": json.dumps({"ok": 1}).encode()}
    for name, members in (("payload.zip", {"raw_images/0.jpg": img("JPEG", 0), "raw_images/1.png": img("PNG", 1)}),
                          ("ocr.zip", {"ocr/2.gif": img("GIF", 2), "ocr/3.png": img("PNG", 3)})):
        path = tmp_path / name
        with zipfile.ZipFile(path, "w") as zf:
            for member, data in members.items():
                zf.writestr(member, data)
        blobs[f"http://x/{name}"] = path.read_bytes()
    return blobs


def _tree(root: Path) -> dict:
    return {str(p.relative_to(root)): (p.read_bytes() if p.is_file() else None)
            for p in sorted(root.rglob("*"))}


def test_download_extract_equals_jax(tmp_path, monkeypatch):
    blobs = _fixtures(tmp_path)
    registry = {"fake-ds": [
        {"name": "meta.json", "extract": False, "url": "http://x/blob_meta.json", "do_rename": True},
        {"name": "nested/images", "extract": True, "extract_type": "directory",
         "url": "http://x/payload.zip", "do_rename": True},
        {"name": "ocr", "extract": True, "extract_type": "directory", "url": "http://x/ocr.zip",
         "do_rename": False},
    ]}
    trees = {}
    for side, mod in (("jax", jdl), ("torch", tdl)):
        monkeypatch.setattr(mod, "DATASET_REGISTRY", registry)
        fetched = []

        def fetch(url, dest, fetched=fetched):
            assert dest.name.endswith(".part") and not dest.exists()  # written aside, then renamed
            fetched.append(url)
            dest.write_bytes(blobs[url])

        root = tmp_path / side
        out = mod.download_extract("fake-ds", root, fetch=fetch)
        assert out == root / "download" / "fake-ds" and len(fetched) == 3
        assert not list(out.rglob("*.part"))
        mod.convert_to_jpg(out / "ocr")
        mod.download_extract("fake-ds", root, fetch=fetch)  # all present: no fetch
        assert len(fetched) == 3
        trees[side] = _tree(out)
    assert trees["torch"] == trees["jax"]
    assert {"meta.json", "nested/images/0.jpg", "nested/images/1.png", "ocr/2.jpg", "ocr/3.jpg",
            "payload.zip", "ocr.zip"} <= set(trees["torch"])


def test_download_skips_existing_and_extract_modes(tmp_path):
    (tmp_path / "file.json").write_text("{}")
    calls = []
    out = tdl.download_with_progress("http://example.com/file.json", tmp_path,
                                     fetch=lambda url, dest: calls.append(url))
    assert out == tmp_path / "file.json" and calls == []
    multi = tmp_path / "multi.zip"
    with zipfile.ZipFile(multi, "w") as zf:
        zf.writestr("d/a.txt", "a")
        zf.writestr("d/b.txt", "b")
    zdir = tmp_path / "z"
    assert tdl.extract_with_progress(multi, zdir, "directory") == zdir / "d" / "a.txt"
    with pytest.raises(AssertionError, match="> 1 member"):
        tdl.extract_with_progress(multi, zdir, "file")
    with pytest.raises(ValueError, match="not defined"):
        tdl.extract_with_progress(multi, zdir, "weird")
    (tmp_path / "img").mkdir()
    (tmp_path / "img" / "weird.bmp").write_bytes(b"BM")
    with pytest.raises(ValueError, match="unexpected image format"):
        tdl.convert_to_jpg(tmp_path / "img")
    assert os.listdir(tmp_path / "img") == ["weird.bmp"]

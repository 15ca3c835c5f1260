"""Dataset download + extraction utilities for the VLM-pretrain datasets.

The JAX package's `training/download.py`, after the reference's
prismatic/preprocessing/download.py: the
LLaVA v1.5 dataset registry (same component names/URLs/extract semantics),
streaming download with skip-if-exists, .zip extraction (file vs directory),
post-download rename, and the OCR-VQA GIF/PNG -> JPG conversion pass. Rich
progress bars are replaced by plain stderr logging; the HTTP fetch is
injectable (and urllib-based) so the machinery is testable offline.
"""

from __future__ import annotations

import os
import shutil
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional
from zipfile import ZipFile

# === Dataset registry w/ links (download.py:33-105, content-identical) ===
DATASET_REGISTRY: Dict[str, List[Dict]] = {
    # LLaVa v1.5 pretrain (align) split
    "llava-laion-cc-sbu-558k": [
        {
            "name": "chat.json",  # {"human" -> prompt, "gpt" -> caption} traces
            "extract": False,
            "url": "https://huggingface.co/datasets/liuhaotian/LLaVA-Pretrain/resolve/main/blip_laion_cc_sbu_558k.json",
            "do_rename": True,
        },
        {
            "name": "images",  # LLaVa processed 224x224 jpgs
            "extract": True,
            "extract_type": "directory",
            "url": "https://huggingface.co/datasets/liuhaotian/LLaVA-Pretrain/resolve/main/images.zip",
            "do_rename": False,
        },
    ],
    # LLaVa v1.5 finetune (instruct) split
    "llava-v1.5-instruct": [
        {
            "name": "llava_v1_5_mix665k.json",
            "extract": False,
            "url": "https://huggingface.co/datasets/liuhaotian/LLaVA-Instruct-150K/resolve/main/llava_v1_5_mix665k.json",
            "do_rename": True,
        },
        {
            "name": "coco/train2017",
            "extract": True,
            "extract_type": "directory",
            "url": "http://images.cocodataset.org/zips/train2017.zip",
            "do_rename": True,
        },
        {
            "name": "gqa/images",
            "extract": True,
            "extract_type": "directory",
            "url": "https://downloads.cs.stanford.edu/nlp/data/gqa/images.zip",
            "do_rename": True,
        },
        {
            "name": "ocr_vqa/images",
            "extract": True,
            "extract_type": "directory",
            "url": "https://huggingface.co/datasets/qnguyen3/ocr_vqa/resolve/main/ocr_vqa.zip",
            "do_rename": True,
        },
        {
            "name": "textvqa/train_images",
            "extract": True,
            "extract_type": "directory",
            "url": "https://dl.fbaipublicfiles.com/textvqa/images/train_val_images.zip",
            "do_rename": True,
        },
        {
            "name": "vg/VG_100K",
            "extract": True,
            "extract_type": "directory",
            "url": "https://cs.stanford.edu/people/rak248/VG_100K_2/images.zip",
            "do_rename": True,
        },
        {
            "name": "vg/VG_100K_2",
            "extract": True,
            "extract_type": "directory",
            "url": "https://cs.stanford.edu/people/rak248/VG_100K_2/images2.zip",
            "do_rename": True,
        },
    ],
}


def _log(msg: str) -> None:
    print(f"[download] {msg}", file=sys.stderr, flush=True)


def convert_to_jpg(image_dir: Path) -> None:
    """OCR-VQA post-pass: convert every GIF/PNG in `image_dir` to JPG
    (download.py:109-124; GIFs take frame 0)."""
    from PIL import Image

    _log(f"converting images in {image_dir} to JPG")
    for image_fn in sorted(Path(image_dir).iterdir()):
        if image_fn.suffix in {".jpg", ".jpeg"}:
            continue
        jpg_fn = image_fn.parent / f"{image_fn.stem}.jpg"
        if jpg_fn.exists():
            continue
        if image_fn.suffix == ".gif":
            gif = Image.open(image_fn)
            gif.seek(0)
            gif.convert("RGB").save(jpg_fn)
        elif image_fn.suffix == ".png":
            Image.open(image_fn).convert("RGB").save(jpg_fn)
        else:
            raise ValueError(f"unexpected image format `{image_fn.suffix}`")


def _urllib_fetch(url: str, dest_path: Path, chunk_size_bytes: int = 1 << 20) -> None:
    import urllib.request

    with urllib.request.urlopen(url) as resp, open(dest_path, "wb") as f:
        while True:
            chunk = resp.read(chunk_size_bytes)
            if not chunk:
                break
            f.write(chunk)


def _atomic_fetch(fetch: Callable[[str, Path], None], url: str, dest_path: Path) -> None:
    """Download to a temp name and rename on success, so an interrupted fetch
    never leaves a truncated file that skip-if-exists would treat as complete
    (a known reference defect — download.py:131-133 writes in place — fixed
    here per the fix-and-document convention)."""
    tmp_path = dest_path.with_name(dest_path.name + ".part")
    fetch(url, tmp_path)
    os.replace(tmp_path, dest_path)


def download_with_progress(
    url: str,
    download_dir: Path,
    fetch: Optional[Callable[[str, Path], None]] = None,
) -> Path:
    """Download `url` into `download_dir`, skipping existing files
    (download.py:128-152). `fetch(url, dest)` is injectable for tests."""
    dest_path = Path(download_dir) / Path(url).name
    if dest_path.exists():
        _log(f"{dest_path.name} exists, skipping")
        return dest_path
    _log(f"downloading {dest_path.name} from {url}")
    _atomic_fetch(fetch or _urllib_fetch, url, dest_path)
    return dest_path


def extract_with_progress(
    archive_path: Path, download_dir: Path, extract_type: str, cleanup: bool = False
) -> Path:
    """Extract a .zip archive; `extract_type` 'file' asserts a single member,
    'directory' extracts all (download.py:156-185). Returns the path of the
    FIRST extracted member (the reference's return contract)."""
    archive_path = Path(archive_path)
    assert archive_path.suffix == ".zip", "only `.zip` archives are supported"
    _log(f"extracting {archive_path.name} to {download_dir}")
    with ZipFile(archive_path) as zf:
        members = zf.infolist()
        extract_path = Path(zf.extract(members[0], download_dir))
        if extract_type == "file":
            assert len(members) == 1, (
                f"archive `{archive_path}` with extract type `{extract_type}` has > 1 member"
            )
        elif extract_type == "directory":
            for member in members[1:]:
                zf.extract(member, download_dir)
        else:
            raise ValueError(f"extract type `{extract_type}` is not defined")
    if cleanup:
        archive_path.unlink()
    return extract_path


def download_extract(
    dataset_id: str,
    root_dir: Path,
    fetch: Optional[Callable[[str, Path], None]] = None,
) -> Path:
    """Download all missing components of a registered dataset, extracting
    archives and applying renames (download.py:189-207). Returns the dataset's
    download dir."""
    download_dir = Path(root_dir) / "download" / dataset_id
    os.makedirs(download_dir, exist_ok=True)

    dl_tasks = [
        d for d in DATASET_REGISTRY[dataset_id] if not (download_dir / d["name"]).exists()
    ]
    for dl_task in dl_tasks:
        dl_path = download_with_progress(dl_task["url"], download_dir, fetch=fetch)
        if dl_task["extract"]:
            dl_path = extract_with_progress(dl_path, download_dir, dl_task["extract_type"])
            dl_path = dl_path.parent if dl_path.is_file() else dl_path
        if dl_task["do_rename"]:
            target = download_dir / dl_task["name"]
            os.makedirs(target.parent, exist_ok=True)
            shutil.move(str(dl_path), str(target))
    return download_dir

"""Pretraining-dataset download registry (LLaVA v1.5 / LVIS-4V / LRV).

Counterpart of bridgelang_tpu/preprocessing/download.py (the reference's
prismatic/preprocessing/download.py:32-207): URLs and extraction rules.
Fetching needs network egress; without it `download_extract` says what to
stage where instead of fetching.
"""

from __future__ import annotations

import shutil
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List


@dataclass(frozen=True)
class DatasetComponent:
    name: str                   # target subdirectory
    extract: bool               # archive needing extraction?
    extract_type: str = "directory"  # "directory" | "file-list"
    url: str = ""
    do_rename: bool = True


DATASET_REGISTRY: Dict[str, List[DatasetComponent]] = {
    "llava-laion-cc-sbu-558k": [
        DatasetComponent(
            "chat.json", False,
            url="https://huggingface.co/datasets/liuhaotian/LLaVA-Pretrain/resolve/main/blip_laion_cc_sbu_558k.json",
        ),
        DatasetComponent(
            "images", True,
            url="https://huggingface.co/datasets/liuhaotian/LLaVA-Pretrain/resolve/main/images.zip",
        ),
    ],
    "llava-v1.5-instruct": [
        DatasetComponent(
            "llava_v1_5_mix665k.json", False,
            url="https://huggingface.co/datasets/liuhaotian/LLaVA-Instruct-150K/resolve/main/llava_v1_5_mix665k.json",
        ),
        DatasetComponent("coco", True, url="http://images.cocodataset.org/zips/train2017.zip"),
        DatasetComponent("gqa", True, url="https://downloads.cs.stanford.edu/nlp/data/gqa/images.zip"),
        DatasetComponent("ocr_vqa", False, url="https://ocr-vqa.github.io/"),
        DatasetComponent("textvqa", True, url="https://dl.fbaipublicfiles.com/textvqa/images/train_val_images.zip"),
        DatasetComponent("vg", True, url="https://cs.stanford.edu/people/rak248/VG_100K_2/images.zip"),
    ],
}


def download_extract(dataset_id: str, root_dir: Path) -> None:
    root = Path(root_dir) / "download" / dataset_id
    root.mkdir(parents=True, exist_ok=True)
    for comp in DATASET_REGISTRY[dataset_id]:
        target = root / comp.name
        if target.exists():
            continue
        if not _has_network():
            raise RuntimeError(
                f"No network egress: stage {comp.url} manually at {target} "
                f"({'extract archive' if comp.extract else 'plain file'})"
            )
        _fetch(comp.url, target, comp.extract)


def _has_network() -> bool:
    import socket

    try:
        socket.create_connection(("8.8.8.8", 53), timeout=2).close()
        return True
    except OSError:
        return False


def _fetch(url: str, target: Path, extract: bool) -> None:
    import urllib.request

    tmp = target.with_suffix(".part")
    urllib.request.urlretrieve(url, tmp)  # noqa: S310
    if extract:
        shutil.unpack_archive(str(tmp), str(target))
        tmp.unlink()
    else:
        tmp.rename(target)


def convert_gif_png_to_jpg(image_dir: Path) -> None:
    """OCR-VQA ships GIF/PNG files that must be JPG (the reference's
    preprocessing quirk): every *.gif, then every *.png, of `image_dir` is
    written beside itself as p.with_suffix(".jpg"), the original kept, so a
    PNG's JPEG replaces a GIF's of the same stem. The JAX package runs
    Image.open(p).convert("RGB").save(p.with_suffix(".jpg"), "JPEG"); here
    native/image.py reads the file by its content as PIL does
    (open_rgb_and_comment) and writes Pillow's JPEG bytes (encode_jpeg),
    the image's comment (a GIF comment extension, a JPEG COM marker) carried
    to a COM marker as PIL carries it."""
    from bridgelang_tpu_torch.native.image import encode_jpeg, open_rgb_and_comment

    for p in list(Path(image_dir).glob("*.gif")) + list(Path(image_dir).glob("*.png")):
        rgb, comment = open_rgb_and_comment(p)
        p.with_suffix(".jpg").write_bytes(encode_jpeg(rgb, comment))

"""Download and preprocess the VLM pretraining datasets.

    python -m bridgelang_tpu_torch.preprocess --dataset_id llava-v1.5-instruct --root_dir data

Counterpart of scripts/preprocess.py: fetch (or, without network egress,
name what to stage where) the LLaVA-family datasets of
`preprocessing.download.DATASET_REGISTRY` under `<root_dir>/download/<id>/`,
and build the merged instruct-tuning mixtures (LVIS-Instruct-4V, LRV-Instruct)
that the `llava-lvis4v*` / `llava-lrv*` dataset configs name. Where
`<root>/download/<id>/ocr_vqa/images` exists, its GIF and PNG images are
written beside themselves as JPEG, byte for byte as the JAX package's PIL
conversion writes them (`preprocessing.download.convert_gif_png_to_jpg`).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

from bridgelang_tpu_torch.conf import parse_cli
from bridgelang_tpu_torch.preprocessing.download import DATASET_REGISTRY, convert_gif_png_to_jpg, download_extract


@dataclass
class PreprocessConfig:
    dataset_id: str = "llava-v15"
    root_dir: str = "data"
    build_mixtures: bool = True


def build_lvis4v_lrv_mixtures(root: Path) -> None:
    """Merge the base 665k chat JSON with LVIS-4V (220k) and LRV (343k) into
    the 888k / 1008k / 1231k mixture files the dataset registry names
    (counterpart of the reference's scripts/additional-datasets/
    {lvis_instruct_4v,lrv_instruct}.py); JSON only."""
    base_dir = root / "download" / "llava-v1.5-instruct"
    base_file = base_dir / "llava_v1_5_mix665k.json"
    if not base_file.exists():
        print(f"[skip] {base_file} missing")
        return
    with open(base_file) as f:
        base = json.load(f)

    def load_extra(name, image_prefix):
        p = base_dir / name
        if not p.exists():
            return None
        with open(p) as f:
            extra = json.load(f)
        for ex in extra:
            if "image" in ex and not ex["image"].startswith(image_prefix):
                ex["image"] = f"{image_prefix}/{ex['image']}"
        return extra

    lvis = load_extra("lvis_instruct4v_220k.json", "coco/train2017")
    lrv = load_extra("lrv_instruct_343k.json", "vg/VG_100K")
    if lvis:
        with open(base_dir / "llava_v1_5_lvis4v_mix888k.json", "w") as f:
            json.dump(base + lvis, f)
    if lrv:
        with open(base_dir / "llava_v1_5_lrv_mix1008k.json", "w") as f:
            json.dump(base + lrv, f)
    if lvis and lrv:
        with open(base_dir / "llava_v1_5_lvis4v_lrv_mix1231k.json", "w") as f:
            json.dump(base + lvis + lrv, f)


def main(cfg: PreprocessConfig) -> None:
    root = Path(cfg.root_dir)
    if cfg.dataset_id not in DATASET_REGISTRY:
        raise SystemExit(f"Unknown dataset {cfg.dataset_id!r}; known: {sorted(DATASET_REGISTRY)}")
    download_extract(cfg.dataset_id, root)
    ocr_dir = root / "download" / cfg.dataset_id / "ocr_vqa" / "images"
    if ocr_dir.exists():
        convert_gif_png_to_jpg(ocr_dir)
    if cfg.build_mixtures:
        build_lvis4v_lrv_mixtures(root)


if __name__ == "__main__":
    main(parse_cli(PreprocessConfig))

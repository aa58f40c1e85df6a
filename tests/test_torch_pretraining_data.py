"""The port's VLM pretraining data (bridgelang_tpu_torch/preprocessing/ and
the `preprocess` entry point) against the JAX package's, on the CPU.

Everything here is compared for equality (tolerance 0): the same chat JSON
and image directory go through both packages.
* AlignDataset / FinetuneDataset items: input ids, labels, `multimodal`,
  and frames bit-equal to the JAX `_load_image` (PIL's
  Image.open(p).convert("RGB").resize((s, s))) over JPEGs of several
  layouts and sizes and PNGs (RGBA, palette, gray); with the byte-fallback
  tokenizer (which takes `add_bos`) and the tests' stub tokenizer (which
  does not: the JAX package's probe picks the other branch).
* The collator's batches, truncation included; SplitModalityBatcher's index
  lists for several seeds, epochs, batch sizes and process strides;
  `get_dataset_and_collator` for every stage.
* The download registry; `download_extract` without network raising the
  same message (the network probe is patched out: no test opens a socket);
  the `preprocess` entry point's mixture files equal to scripts/preprocess.py's
  on a local directory; the OCR-VQA GIF/PNG -> JPEG conversion
  (tests/data/images/ocr), alone and through both entry points, writing the
  same bytes as the JAX package's (PIL's).
"""

import dataclasses
import importlib.util
import io
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from bridgelang_tpu.conf import DatasetConfig as JDatasetConfig
from bridgelang_tpu.models.llm.tokenizer import ByteFallbackTokenizer as JTokenizer
from bridgelang_tpu.preprocessing import datasets as jds
from bridgelang_tpu.preprocessing import download as jdl
from bridgelang_tpu.preprocessing import materialize as jmat
from bridgelang_tpu_torch import preprocess as tprep
from bridgelang_tpu_torch.conf import DatasetConfig
from bridgelang_tpu_torch.models.llm.tokenizer import ByteFallbackTokenizer
from bridgelang_tpu_torch.preprocessing import datasets as tds
from bridgelang_tpu_torch.preprocessing import download as tdl
from bridgelang_tpu_torch.preprocessing import materialize as tmat
from tests.helpers import StubTokenizer

OCR_FIXTURES = Path(__file__).resolve().parent / "data" / "images" / "ocr"

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "data" / "images"
CAPTIONS = ["A colorful pattern.", "a photo of a red block on a wooden table next to a cup",
            "<image>\nTwo   spaced\twords", "é中 unicode ✓ caption", "x"]


def _load_script(name):
    mod_name = f"blx_torch_test_script_{name}"
    spec = importlib.util.spec_from_file_location(mod_name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod  # dataclasses resolves annotations via sys.modules
    spec.loader.exec_module(mod)
    return mod


def _save(arr_or_img, path, fmt, **kw):
    img = arr_or_img if isinstance(arr_or_img, Image.Image) else Image.fromarray(arr_or_img)
    img.save(path, fmt, **kw)


@pytest.fixture(scope="module")
def llava(tmp_path_factory):
    """A LLaVA-layout directory: 10 images (JPEG layouts and sizes, PNG modes,
    two committed fixtures), an align chat.json in the 558k shape and a
    finetune JSON in the mix665k shape with multi-turn and text-only chats."""
    root = tmp_path_factory.mktemp("llava")
    img_dir = root / "images"
    (img_dir / "sub").mkdir(parents=True)
    rng = np.random.default_rng(0)
    names = []
    for i, (hw, fmt, kw) in enumerate([((48, 64), "JPEG", dict(quality=90)),
                                       ((37, 29), "JPEG", dict(quality=75, subsampling=0)),
                                       ((64, 48), "JPEG", dict(quality=85, progressive=True)),
                                       ((300, 17), "JPEG", dict(quality=95, subsampling=1)),
                                       ((16, 16), "PNG", {}),
                                       ((40, 50), "PNG", dict(mode="RGBA")),
                                       ((33, 33), "PNG", dict(mode="P")),
                                       ((21, 22), "JPEG", dict(mode="L"))]):
        arr = rng.integers(0, 256, (*hw, 4), dtype=np.uint8)
        mode = kw.pop("mode", "RGB")
        img = Image.fromarray(arr, "RGBA")
        img = img.quantize(64) if mode == "P" else img.convert(mode)
        name = f"sub/img{i}.{'jpg' if fmt == 'JPEG' else 'png'}"
        _save(img, img_dir / name, fmt, **kw)
        names.append(name)
    for fixture in ("coco_00_640x480.jpg", "palette_trns_61x83.png"):
        (img_dir / fixture).write_bytes((FIXTURES / fixture).read_bytes())
        names.append(fixture)
    align = [{"id": f"{i:09d}", "image": name, "conversations": [
        {"from": "human", "value": "<image>\nRender a clear and concise summary of the photo."},
        {"from": "gpt", "value": CAPTIONS[i % len(CAPTIONS)] + " " * (i % 2)}]} for i, name in enumerate(names)]
    finetune = []
    for i, name in enumerate(names):
        turns = [{"from": "human", "value": "<image>\nWhat is in the image?"},
                 {"from": "gpt", "value": CAPTIONS[i % len(CAPTIONS)]}]
        turns += [{"from": "human", "value": "And the colour?"}, {"from": "gpt", "value": "Mostly noise."}] * (i % 3)
        finetune.append({"id": str(i), "image": name, "conversations": turns})
    for i in range(5):
        finetune.append({"id": f"text{i}", "conversations": [
            {"from": "human", "value": "Say hi." * (i + 1)}, {"from": "gpt", "value": "hi there " * (40 * i + 1)}]})
    (root / "chat.json").write_text(json.dumps(align))
    (root / "mix.json").write_text(json.dumps(finetune))
    return root


def _assert_item_equal(t, j, label):
    assert set(t) == set(j), label
    assert t["multimodal"] is j["multimodal"], label
    for key in ("input_ids", "labels"):
        assert t[key].dtype == np.asarray(j[key]).dtype, (label, key)
        np.testing.assert_array_equal(t[key], j[key], err_msg=f"{label} {key}")
    if j["frames"] is None:
        assert t["frames"] is None, label
    else:
        assert t["frames"].dtype == j["frames"].dtype == np.uint8 and t["frames"].shape == j["frames"].shape
        np.testing.assert_array_equal(t["frames"], j["frames"], err_msg=f"{label} frames")


TOKENIZERS = {"byte": (ByteFallbackTokenizer, JTokenizer), "stub": (StubTokenizer, StubTokenizer)}


@pytest.mark.parametrize("tok", sorted(TOKENIZERS))
@pytest.mark.parametrize("size", [224, 32])
def test_align_items_match_jax(llava, tok, size):
    t_tok, j_tok = TOKENIZERS[tok]
    t = tds.AlignDataset(llava / "chat.json", llava / "images", t_tok(), image_size=size)
    j = jds.AlignDataset(llava / "chat.json", llava / "images", j_tok(), image_size=size)
    assert len(t) == len(j) == 10 and t.dataset_type == j.dataset_type == "align"
    assert t.get_modality_lengths() == j.get_modality_lengths()
    for i in range(len(t)):
        item = t[i]
        _assert_item_equal(item, j[i], f"align {i}")
        assert item["labels"][0] == -100 and item["input_ids"][-1] == tds.EOS_TOKEN_ID


@pytest.mark.parametrize("tok", sorted(TOKENIZERS))
@pytest.mark.parametrize("family", ["llama2-pure", "vicuna"])
def test_finetune_items_match_jax(llava, tok, family):
    t_tok, j_tok = TOKENIZERS[tok]
    t = tds.FinetuneDataset(llava / "mix.json", llava / "images", t_tok(), llm_family=family)
    j = jds.FinetuneDataset(llava / "mix.json", llava / "images", j_tok(), llm_family=family)
    assert len(t) == len(j) == 15 and t.dataset_type == j.dataset_type == "finetune"
    assert t.get_modality_lengths() == j.get_modality_lengths()
    for i in range(len(t)):
        item = t[i]
        _assert_item_equal(item, j[i], f"finetune {i}")
        assert item["input_ids"][0] == 1 and (item["input_ids"][1:] != 1).all()  # one BOS, stray ones dropped
    assert sum(1 for i in range(len(t)) if not t[i]["multimodal"]) == 5


@pytest.mark.parametrize("max_length", [2048, 64, 9])
def test_collator_matches_jax(llava, max_length):
    t = tds.FinetuneDataset(llava / "mix.json", llava / "images", ByteFallbackTokenizer())
    j = jds.FinetuneDataset(llava / "mix.json", llava / "images", JTokenizer())
    order = [3, 12, 0, 14, 7, 10]
    tb = tds.PaddedCollatorForLanguageModeling(max_length, 32000)([t[i] for i in order])
    jb = jds.PaddedCollatorForLanguageModeling(max_length, 32000)([j[i] for i in order])
    assert set(tb) == set(jb)
    for key in tb:
        assert tb[key].dtype == jb[key].dtype and tb[key].shape == jb[key].shape, key
        np.testing.assert_array_equal(tb[key], jb[key], err_msg=key)
    assert tb["frames"].shape == (6, 224, 224, 3) and list(tb["multimodal_indices"]) == [0, 2, 4]


@pytest.mark.parametrize("seed,batch,procs", [(0, 2, 1), (7, 3, 1), (3, 1, 2), (11, 2, 3), (5, 4, 2)])
def test_split_modality_batcher_matches_jax(llava, seed, batch, procs):
    lengths = tds.FinetuneDataset(llava / "mix.json", llava / "images", StubTokenizer()).get_modality_lengths()
    lengths = lengths * 9  # 135 examples: several chunks of length-sorted batches at batch 1
    for epoch in range(3):
        for p in range(procs):
            t = tds.SplitModalityBatcher(lengths, batch, seed=seed, process_index=p, process_count=procs)
            j = jds.SplitModalityBatcher(lengths, batch, seed=seed, process_index=p, process_count=procs)
            assert t.batches(epoch) == j.batches(epoch), (epoch, p)
            for b in t.batches(epoch):
                assert len({lengths[i][0] for i in b}) == 1  # one modality per batch
    assert tds.SplitModalityBatcher([], 2).batches(0) == jds.SplitModalityBatcher([], 2).batches(0) == []


@pytest.mark.parametrize("stage", ["align", "finetune", "full-finetune", "last-layer-finetune", "vla-train"])
def test_get_dataset_and_collator_matches_jax(llava, stage):
    comps = dict(align_stage_components=("chat.json", "images"), finetune_stage_components=("mix.json", "images"),
                 dataset_root_dir=str(llava))
    tcfg = dataclasses.replace(DatasetConfig.get("llava-v15"), **comps)
    jcfg = dataclasses.replace(JDatasetConfig.get("llava-v15"), **comps)
    kw = dict(max_length=96, pad_token_id=32000, image_size=64)
    if stage == "vla-train":
        for mod, cfg, tok in ((tmat, tcfg, ByteFallbackTokenizer()), (jmat, jcfg, JTokenizer())):
            with pytest.raises(ValueError, match="Unknown stage"):
                mod.get_dataset_and_collator(stage, cfg, tok, "llama2-pure", **kw)
        return
    t_ds, t_coll = tmat.get_dataset_and_collator(stage, tcfg, ByteFallbackTokenizer(), "llama2-pure", **kw)
    j_ds, j_coll = jmat.get_dataset_and_collator(stage, jcfg, JTokenizer(), "llama2-pure", **kw)
    assert type(t_ds).__name__ == type(j_ds).__name__ and len(t_ds) == len(j_ds)
    assert (t_coll.max_length, t_coll.pad_token_id, t_coll.image_hw) == (96, 32000, (64, 64))
    tb, jb = t_coll([t_ds[i] for i in (1, 4)]), j_coll([j_ds[i] for i in (1, 4)])
    for key in tb:
        np.testing.assert_array_equal(tb[key], jb[key], err_msg=key)


def test_download_registry_and_no_network_message_match_jax(tmp_path, monkeypatch):
    assert {k: [dataclasses.asdict(c) for c in v] for k, v in tdl.DATASET_REGISTRY.items()} == \
        {k: [dataclasses.asdict(c) for c in v] for k, v in jdl.DATASET_REGISTRY.items()}
    monkeypatch.setattr(tdl, "_has_network", lambda: False)
    monkeypatch.setattr(jdl, "_has_network", lambda: False)
    monkeypatch.setattr(tdl, "_fetch", lambda *a: pytest.fail("fetch without network"))
    monkeypatch.setattr(jdl, "_fetch", lambda *a: pytest.fail("fetch without network"))
    for dataset_id in tdl.DATASET_REGISTRY:
        messages = []
        for mod in (tdl, jdl):
            with pytest.raises(RuntimeError, match="No network egress") as e:
                mod.download_extract(dataset_id, tmp_path)
            messages.append(str(e.value))
        assert messages[0] == messages[1]
        # staged components are skipped before any network probe
        for comp in tdl.DATASET_REGISTRY[dataset_id]:
            (tmp_path / "download" / dataset_id / comp.name).mkdir(parents=True, exist_ok=True)
        tdl.download_extract(dataset_id, tmp_path)
    # the OCR-VQA conversion: the same files with the same bytes as the JAX package's (PIL's)
    for mod, name in ((tdl, "port"), (jdl, "jax")):
        (tmp_path / name).mkdir()
        for src in list(OCR_FIXTURES.glob("*.gif")) + list(OCR_FIXTURES.glob("*.png")):
            shutil.copy(src, tmp_path / name / src.name)
        mod.convert_gif_png_to_jpg(tmp_path / name)
    got, want = ({p.name: p.read_bytes() for p in (tmp_path / name).iterdir()} for name in ("port", "jax"))
    assert got == want and any(n.endswith(".jpg") for n in got)


def _fake_instruct_root(root: Path):
    """Every component of llava-v1.5-instruct staged, with small JSONs."""
    base = root / "download" / "llava-v1.5-instruct"
    for comp in tdl.DATASET_REGISTRY["llava-v1.5-instruct"]:
        if comp.name.endswith(".json"):
            continue
        (base / comp.name).mkdir(parents=True, exist_ok=True)
    mix = [{"id": str(i), "image": f"coco/train2017/{i:012d}.jpg", "conversations": [
        {"from": "human", "value": "<image>\nq"}, {"from": "gpt", "value": f"a{i}"}]} for i in range(3)]
    mix.append({"id": "t", "conversations": [{"from": "human", "value": "q"}, {"from": "gpt", "value": "a"}]})
    (base / "llava_v1_5_mix665k.json").write_text(json.dumps(mix))
    lvis = [{"id": "l0", "image": "000000000001.jpg", "conversations": []},
            {"id": "l1", "image": "coco/train2017/000000000002.jpg", "conversations": []}]
    lrv = [{"id": "r0", "image": "2345.jpg", "conversations": []}, {"id": "r1", "conversations": []}]
    (base / "lvis_instruct4v_220k.json").write_text(json.dumps(lvis))
    (base / "lrv_instruct_343k.json").write_text(json.dumps(lrv))
    return base


MIXTURES = ("llava_v1_5_lvis4v_mix888k.json", "llava_v1_5_lrv_mix1008k.json", "llava_v1_5_lvis4v_lrv_mix1231k.json")


def test_preprocess_mixtures_match_jax_script(tmp_path, monkeypatch):
    monkeypatch.setattr(tdl, "_has_network", lambda: pytest.fail("network probe"))
    monkeypatch.setattr(jdl, "_has_network", lambda: pytest.fail("network probe"))
    jscript = _load_script("preprocess")
    out = {}
    for name, mod in (("torch", tprep), ("jax", jscript)):
        root = tmp_path / name
        base = _fake_instruct_root(root)
        mod.main(mod.PreprocessConfig(dataset_id="llava-v1.5-instruct", root_dir=str(root)))
        out[name] = {m: json.loads((base / m).read_text()) for m in MIXTURES}
    assert out["torch"] == out["jax"]
    assert len(out["torch"][MIXTURES[2]]) == 8
    assert out["torch"][MIXTURES[0]][4]["image"] == "coco/train2017/000000000001.jpg"

    with pytest.raises(SystemExit, match="Unknown dataset"):
        tprep.main(tprep.PreprocessConfig(dataset_id="nope", root_dir=str(tmp_path / "x")))
    # with OCR-VQA's images staged, both entry points convert them to the same JPEG bytes
    images = {}
    for name, mod in (("torch", tprep), ("jax", jscript)):
        ocr = tmp_path / name / "download" / "llava-v1.5-instruct" / "ocr_vqa" / "images"
        ocr.mkdir(parents=True)
        for src in ("pillow_comment_24x18.gif", "pair.gif", "pair.png", "rgba8.png"):
            shutil.copy(OCR_FIXTURES / src, ocr / src)
        mod.main(mod.PreprocessConfig(dataset_id="llava-v1.5-instruct", root_dir=str(tmp_path / name)))
        images[name] = {p.name: p.read_bytes() for p in ocr.iterdir()}
    assert images["torch"] == images["jax"]
    assert sorted(n for n in images["torch"] if n.endswith(".jpg")) == ["pair.jpg", "pillow_comment_24x18.jpg",
                                                                          "rgba8.jpg"]


def test_preprocess_cli_parses_as_jax():
    from bridgelang_tpu.conf import config_to_dict as j_to_dict
    from bridgelang_tpu.conf import parse_cli as j_parse
    from bridgelang_tpu_torch.conf import config_to_dict, parse_cli

    argv = ["--dataset_id", "llava-laion-cc-sbu-558k", "--root_dir", "/data", "--build_mixtures", "false"]
    jcfg = j_parse(_load_script("preprocess").PreprocessConfig, argv)
    assert config_to_dict(parse_cli(tprep.PreprocessConfig, argv)) == j_to_dict(jcfg)


def test_images_from_bytes_and_paths_agree(llava):
    from bridgelang_tpu_torch.native.image import load_image

    path = llava / "images" / "coco_00_640x480.jpg"
    with Image.open(io.BytesIO(path.read_bytes())) as img:
        want = np.asarray(img.convert("RGB").resize((224, 224)))
    np.testing.assert_array_equal(load_image(path, 224), want)
    np.testing.assert_array_equal(load_image(path.read_bytes(), 224), want)

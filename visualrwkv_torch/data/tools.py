"""Dataset preparation tools (reference scripts/other/*): invalid-image
finder/fixer, json merge+shuffle, Cauldron->LLaVA conversion, multi-image /
multi-round reformatting, video-mme conversion, image checks. The port's
copy of ``visualrwkv_tpu/data/tools.py`` (framework-free host code)."""

from __future__ import annotations

import json
import logging
import random
from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional, Sequence

log = logging.getLogger(__name__)


def find_invalid_images(data_file: str, image_folder: str) -> List[Dict]:
    """Records whose image files are missing or unreadable
    (reference scripts/other/1_find_invalid_image.py)."""
    from PIL import Image

    records = json.load(open(data_file))
    bad = []
    for rec in records:
        if "image" not in rec:
            continue
        names = rec["image"] if isinstance(rec["image"], list) else [rec["image"]]
        for name in names:
            path = Path(image_folder) / name
            try:
                with Image.open(path) as im:
                    im.convert("RGB")
            except Exception as e:
                bad.append({"id": rec.get("id"), "image": name, "error": str(e)})
    return bad


def fix_invalid_images(data_file: str, image_folder: str, out_file: str) -> int:
    """Drop records with unreadable images (2_fix_invalid_image.py analog)."""
    bad = {b["id"] for b in find_invalid_images(data_file, image_folder)}
    records = json.load(open(data_file))
    kept = [r for r in records if r.get("id") not in bad]
    json.dump(kept, open(out_file, "w"))
    return len(records) - len(kept)


def merge_and_shuffle(json_files: Sequence[str], out_file: str, seed: int = 222) -> int:
    """Merge LLaVA-format jsons and shuffle deterministically
    (merge/shuffle tools; seed 222 matches the reference's epoch shuffles)."""
    records: List[Dict] = []
    for f in json_files:
        records.extend(json.load(open(f)))
    rng = random.Random(seed)
    rng.shuffle(records)
    json.dump(records, open(out_file, "w"))
    return len(records)


def cauldron_to_llava(cauldron_records: Sequence[Dict], image_prefix: str = "") -> List[Dict]:
    """Cauldron {images, texts:[{user, assistant}]} -> LLaVA conversations
    (Cauldron converter analog)."""
    out = []
    for i, rec in enumerate(cauldron_records):
        convs = []
        for j, turn in enumerate(rec.get("texts", [])):
            user = turn.get("user", "")
            if j == 0 and "<image>" not in user:
                user = "<image>\n" + user
            convs.append({"from": "human", "value": user})
            convs.append({"from": "gpt", "value": turn.get("assistant", "")})
        out.append(
            {
                "id": rec.get("id", f"cauldron_{i}"),
                "image": rec.get("image", rec.get("images")),
                "conversations": convs,
            }
        )
    return out


def split_multiround_to_single(records: Sequence[Dict]) -> List[Dict]:
    """Explode multi-round conversations into single-round records
    (multi-round reformatter analog); the image stays on the first round."""
    out = []
    for rec in records:
        convs = rec["conversations"]
        for i in range(0, len(convs) - 1, 2):
            sub = [dict(convs[i]), dict(convs[i + 1])]
            if i > 0:
                sub[0]["value"] = sub[0]["value"].replace("<image>", "").strip()
            new = {**rec, "conversations": sub, "id": f"{rec.get('id')}_r{i // 2}"}
            if i > 0:
                new.pop("image", None)
            out.append(new)
    return out


def videomme_to_questions(videomme_json: str, num_frames: int = 8) -> List[Dict]:
    """Video-MME records -> our eval question format with N frame tokens."""
    data = json.load(open(videomme_json))
    out = []
    for rec in data:
        for q in rec.get("questions", [rec] if "question" in rec else []):
            opts = "\n".join(q.get("options", []))
            text = ("<image>\n" * num_frames) + q["question"] + (
                f"\n{opts}" if opts else ""
            ) + "\nAnswer with the option's letter from the given choices directly."
            out.append(
                {
                    "question_id": q.get("question_id", q.get("id")),
                    "video": rec.get("video_id", rec.get("videoID", "")),
                    "text": text,
                    "answer": q.get("answer", ""),
                }
            )
    return out


def check_duplicates(data_file: str, key: str = "id") -> Dict[str, int]:
    """Duplicate-id report (check_dir_dup.py analog)."""
    records = json.load(open(data_file))
    counts = Counter(str(r.get(key)) for r in records)
    return {k: v for k, v in counts.items() if v > 1}


def correct_conversation_format(records: Sequence[Dict]) -> List[Dict]:
    """Validate/repair LLaVA conversations against their image lists
    (scripts/other/correct_conv_format.py): pair turns (dropping a trailing
    unpaired one), force from=human/gpt alternation, strip <image> tags out
    of gpt turns, and prepend missing <image> tokens so the conversation's
    tag count matches len(record["image"]). Records whose count still
    mismatches are dropped; no-image records pass through untouched."""
    out = []
    for rec in records:
        if "image" not in rec or not isinstance(rec.get("conversations"), list):
            out.append(rec)
            continue
        rec = dict(rec)
        images = rec["image"] if isinstance(rec["image"], list) else [rec["image"]]
        rec["image"] = images
        convs = rec["conversations"]
        if len(convs) % 2:
            convs = convs[:-1]
        fixed, n_tags = [], 0
        for i in range(0, len(convs), 2):
            human, gpt = dict(convs[i]), dict(convs[i + 1])
            if not ("value" in human and "value" in gpt):
                continue
            human["from"], gpt["from"] = "human", "gpt"
            gpt["value"] = gpt["value"].replace("<image>", "").strip()
            n_tags += human["value"].count("<image>")
            fixed.extend((human, gpt))
        if fixed and n_tags < len(images):
            prefix = "\n".join(["<image>"] * (len(images) - n_tags))
            fixed[0]["value"] = prefix + "\n" + fixed[0]["value"]
            n_tags = len(images)
        if fixed and n_tags == len(images):
            rec["conversations"] = fixed
            out.append(rec)
        else:
            log.warning("dropping %s: %d <image> tags vs %d images",
                        rec.get("id"), n_tags, len(images))
    return out


def image_set_distribution(records: Sequence[Dict], key: str = "image") -> Counter:
    """Distribution of records over image-set prefixes (the directory before
    the first '/'; scripts/other/extract_data.py analyze_data)."""
    return Counter(
        str(rec[key]).split("/")[0] for rec in records if key in rec
    )


def extract_by_image_set(
    records: Sequence[Dict], keep: Sequence[str], key: str = "image"
) -> List[Dict]:
    """Keep records whose image-set prefix is in ``keep``
    (scripts/other/extract_data.py extract_data)."""
    keep_set = set(keep)
    return [
        rec for rec in records
        if key in rec and str(rec[key]).split("/")[0] in keep_set
    ]


def to_image_dir_format(records: Sequence[Dict]) -> List[Dict]:
    """Single-image LLaVA records -> the image_dir layout used by the v7
    multi-image pipeline (scripts/other/to_multiimage_format.py): the top-level
    image path splits into {image_dir}/{rest}, and the per-conversation
    ``image`` list on the first human turn carries the rest."""
    out = []
    for rec in records:
        if "image" not in rec:
            out.append(rec)
            continue
        parts = str(rec["image"]).split("/")
        convs = [dict(c) for c in rec["conversations"]]
        convs[0]["image"] = ["/".join(parts[1:])]
        out.append({"id": rec.get("id"), "image_dir": parts[0],
                    "conversations": convs})
    return out


def clean_missing_responses(records: Sequence[Dict]) -> List[Dict]:
    """Drop conversation pairs whose gpt turn is missing/empty, and records
    left with no pairs (scripts/other/reformat_data.py clean_missing_data)."""
    out = []
    for rec in records:
        convs = rec.get("conversations", [])
        kept = []
        for i in range(0, len(convs) - 1, 2):
            if convs[i + 1].get("from") == "gpt" and convs[i + 1].get("value"):
                kept.extend((convs[i], convs[i + 1]))
        if kept:
            out.append({**rec, "conversations": kept})
    return out


_SINGLE_WORD_SUFFIX = "Answer the question using a single word or phrase."


def split_long_conversations(
    records: Sequence[Dict], max_rounds: int = 20
) -> List[Dict]:
    """Split conversations longer than ``max_rounds`` pairs into multiple
    records (scripts/other/reformat_data.py): every split's first human turn
    regains an ``<image>`` tag, and the original first turn's
    single-word-answer instruction is re-appended to later splits."""
    out = []
    for rec in records:
        convs = rec.get("conversations", [])
        pairs = [convs[i : i + 2] for i in range(0, len(convs) - 1, 2)]
        if len(pairs) <= max_rounds:
            out.append(rec)
            continue
        carry_suffix = convs and _SINGLE_WORD_SUFFIX in convs[0].get("value", "")
        has_image = "image" in rec
        for start in range(0, len(pairs), max_rounds):
            chunk = [dict(t) for pair in pairs[start : start + max_rounds] for t in pair]
            if has_image and "<image>" not in chunk[0]["value"]:
                chunk[0]["value"] = "<image>\n" + chunk[0]["value"]
            if start and carry_suffix and _SINGLE_WORD_SUFFIX not in chunk[0]["value"]:
                chunk[0]["value"] += "\n" + _SINGLE_WORD_SUFFIX
            out.append({**rec, "conversations": chunk})
    return out


def merge_to_multi_round(
    records: Sequence[Dict], max_rounds: int = 10
) -> List[Dict]:
    """Group single-round records that share an image into one multi-round
    conversation (scripts/other/to_multi-round.py): exact-duplicate
    conversations are deduped, later rounds lose their ``<image>\\n`` prefix,
    and conversations longer than ``max_rounds`` are re-split."""
    by_image: Dict[str, List[Dict]] = {}
    passthrough = []
    for rec in records:
        if "image" not in rec:  # text-only records pass through unmerged
            passthrough.append(rec)
            continue
        # str() key: normalized records may carry list-valued images
        by_image.setdefault(str(rec["image"]), []).append(rec)
    merged = []
    for _, recs in by_image.items():
        image = recs[0]["image"]
        seen, convs = set(), []
        for rec in recs:
            key = json.dumps(rec["conversations"], sort_keys=True)
            if key in seen:
                continue
            seen.add(key)
            convs.extend(dict(t) for t in rec["conversations"])
        for i in range(0, len(convs) - 1, 2):
            convs[i]["from"], convs[i + 1]["from"] = "human", "gpt"
        for turn in convs[2:]:
            turn["value"] = turn["value"].replace("<image>\n", "")
        merged.append({"id": recs[0].get("id"), "image": image,
                       "conversations": convs})
    return split_long_conversations(merged, max_rounds=max_rounds) + passthrough


def check_image_folder(
    data_file: str,
    image_folder: str,
    try_open: bool = False,
    do_resize: bool = False,
    max_pixels: int = 1024 * 1024,
) -> Dict:
    """Cross-check an image_dir-format json against the image folder
    (scripts/other/check_image.py): reports json images missing on disk and
    disk images unused by the json (per-image-set ratios), optionally
    open-verifies each image and downsizes decompression-bomb-sized ones to
    a 1024 longer side, and returns the records whose images all resolve."""
    root = Path(image_folder)
    on_disk = {p for p in root.glob("**/*") if p.is_file()}
    records = json.load(open(data_file))

    def rec_paths(rec):
        for conv in rec.get("conversations", []):
            for img in conv.get("image", []):
                yield root / rec["image_dir"] / img

    in_json = [p for rec in records if "image_dir" in rec for p in rec_paths(rec)]
    missing = sorted(str(p) for p in set(in_json) - on_disk)
    unused = sorted(str(p) for p in on_disk - set(in_json))
    unused_by_set = Counter(Path(p).relative_to(root).parts[0] for p in unused)

    missing_set = set(missing)
    kept = []
    for rec in records:
        if "image_dir" not in rec:
            kept.append(rec)
            continue
        ok = True
        for p in rec_paths(rec):
            if str(p) in missing_set:
                ok = False
                break
            if try_open:
                try:
                    from PIL import Image

                    with Image.open(p) as im:
                        if do_resize and im.size[0] * im.size[1] > max_pixels:
                            ratio = max(im.size) / 1024
                            im = im.resize((int(im.size[0] / ratio),
                                            int(im.size[1] / ratio)))
                            im.save(p)
                except Exception as e:  # noqa: BLE001 - any decode error invalidates
                    log.warning("unreadable image %s: %s", p, e)
                    ok = False
                    break
        if ok:
            kept.append(rec)
    return {"missing": missing, "unused_by_set": dict(unused_by_set),
            "valid_records": kept}


def dataset_stats(json_files: Sequence[str]) -> List[Dict]:
    """Per-file image usage stats (scripts/other/check_dir_dup.py): total
    image refs, unique images, top-3 most repeated."""
    stats = []
    for f in json_files:
        images = [r["image"] for r in json.load(open(f)) if "image" in r]
        counter = Counter(map(str, images))
        stats.append({
            "name": Path(f).name, "total": len(images), "unique": len(counter),
            "top3": [f"{k}:{v}" for k, v in counter.most_common(3)],
        })
    return stats


def hfds_to_llava_jsonl(
    dataset_path: str,
    output_dir: str,
    instruction_fn,
    response_fn,
    id_fn=None,
) -> int:
    """Export an on-disk HF dataset of images to LLaVA jsonl + a jpg tree
    (scripts/other/extract_data... to_llava_jsonl.py), with caller-supplied
    instruction/response functions instead of hard-coded per-dataset prompts."""
    import datasets

    in_path, out_root = Path(dataset_path), Path(output_dir)
    ds = datasets.load_from_disk(str(in_path))
    if "train" in getattr(ds, "keys", lambda: ())():
        ds = ds["train"]
    name = in_path.stem
    img_dir = out_root / name
    img_dir.mkdir(parents=True, exist_ok=True)
    n = 0
    with open(out_root / f"{name}.jsonl", "w") as f:
        for i, sample in enumerate(ds):
            sid = id_fn(sample, i) if id_fn else f"{name}_{i}"
            img_path = img_dir / f"{sid}.jpg"
            sample["image"].convert("RGB").save(img_path)
            rec = {
                "id": sid,
                "image": str(img_path.relative_to(out_root)),
                "conversations": [
                    {"from": "human",
                     "value": "<image>\n" + instruction_fn(sample)},
                    {"from": "gpt", "value": response_fn(sample).strip()},
                ],
            }
            f.write(json.dumps(rec, ensure_ascii=False) + "\n")
            n += 1
    return n


def zip_subdirs(base_dir: str, output_dir: str, workers: int = 4) -> List[str]:
    """Store-only (uncompressed) zip of each child directory, in parallel
    (scripts/other/zip_dir.py: zip -q -0 -r per subfolder, 4-process pool).
    Uses the stdlib so it works without a system zip binary."""
    import zipfile
    from concurrent.futures import ThreadPoolExecutor

    base, out_root = Path(base_dir), Path(output_dir)
    out_root.mkdir(parents=True, exist_ok=True)

    def one(folder: Path) -> str:
        out = out_root / f"{folder.name}.zip"
        with zipfile.ZipFile(out, "w", zipfile.ZIP_STORED) as zf:
            for f in sorted(folder.rglob("*")):
                if f.is_file():
                    zf.write(f, f.relative_to(base))
        return str(out)

    folders = [d for d in base.iterdir() if d.is_dir()]
    with ThreadPoolExecutor(max_workers=workers) as ex:
        return list(ex.map(one, folders))


def _cli(argv=None):
    """python -m visualrwkv_torch.data.tools <cmd> ... — one entry point for
    the dataset-prep pipeline (the reference's scripts/other/ suite)."""
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    for name in ("find-invalid", "fix-invalid"):
        s = sub.add_parser(name)
        s.add_argument("data_file"), s.add_argument("image_folder")
        if name == "fix-invalid":
            s.add_argument("out_file")
    s = sub.add_parser("merge-shuffle")
    s.add_argument("out_file"), s.add_argument("json_files", nargs="+")
    s.add_argument("--seed", type=int, default=222)
    s = sub.add_parser("correct-format")
    s.add_argument("data_file"), s.add_argument("out_file")
    s = sub.add_parser("extract")
    s.add_argument("data_file"), s.add_argument("keep", help="comma-sep image sets")
    s.add_argument("--key", default="image")
    s = sub.add_parser("to-image-dir")
    s.add_argument("out_file"), s.add_argument("json_files", nargs="+")
    s = sub.add_parser("reformat")
    s.add_argument("data_file"), s.add_argument("--max_rounds", type=int, default=20)
    s.add_argument("--shuffle", action="store_true")
    s = sub.add_parser("to-multi-round")
    s.add_argument("data_file"), s.add_argument("--max_rounds", type=int, default=10)
    s = sub.add_parser("check-images")
    s.add_argument("data_file"), s.add_argument("image_folder")
    s.add_argument("--try_open", action="store_true")
    s.add_argument("--do_resize", action="store_true")
    s = sub.add_parser("stats")
    s.add_argument("json_files", nargs="+")
    s = sub.add_parser("dup-report")
    s.add_argument("data_file"), s.add_argument("--key", default="id")
    s = sub.add_parser("zip")
    s.add_argument("base_dir"), s.add_argument("output_dir")
    s.add_argument("--workers", type=int, default=4)
    args = p.parse_args(argv)

    def dump(obj, path):
        json.dump(obj, open(path, "w"), indent=2, ensure_ascii=False)
        print(f"wrote {path} ({len(obj)} records)")

    if args.cmd == "find-invalid":
        print(json.dumps(find_invalid_images(args.data_file, args.image_folder), indent=2))
    elif args.cmd == "fix-invalid":
        n = fix_invalid_images(args.data_file, args.image_folder, args.out_file)
        print(f"dropped {n} records -> {args.out_file}")
    elif args.cmd == "merge-shuffle":
        n = merge_and_shuffle(args.json_files, args.out_file, seed=args.seed)
        print(f"wrote {args.out_file} ({n} records)")
    elif args.cmd == "correct-format":
        dump(correct_conversation_format(json.load(open(args.data_file))), args.out_file)
    elif args.cmd == "extract":
        records = json.load(open(args.data_file))
        print("distribution:", dict(image_set_distribution(records, args.key)))
        kept = extract_by_image_set(records, args.keep.split(","), args.key)
        out = args.data_file.replace(".json", f"_{len(kept) // 1000}k.json")
        dump(kept, out)
    elif args.cmd == "to-image-dir":
        records = []
        for f in args.json_files:
            records.extend(json.load(open(f)))
        dump(to_image_dir_format(records), args.out_file)
    elif args.cmd == "reformat":
        records = clean_missing_responses(json.load(open(args.data_file)))
        records = split_long_conversations(records, max_rounds=args.max_rounds)
        if args.shuffle:
            random.Random(22).shuffle(records)
        dump(records, args.data_file.replace(".json", f"_{args.max_rounds}rounds.json"))
    elif args.cmd == "to-multi-round":
        records = merge_to_multi_round(json.load(open(args.data_file)),
                                       max_rounds=args.max_rounds)
        dump(records, args.data_file.replace(".json", "_multi_round.json"))
    elif args.cmd == "check-images":
        report = check_image_folder(args.data_file, args.image_folder,
                                    try_open=args.try_open, do_resize=args.do_resize)
        print(f"missing: {len(report['missing'])}  unused: {report['unused_by_set']}")
        dump(report["valid_records"], args.data_file.replace(".json", "_valid.json"))
    elif args.cmd == "stats":
        print(json.dumps(dataset_stats(args.json_files), indent=2))
    elif args.cmd == "dup-report":
        print(json.dumps(check_duplicates(args.data_file, key=args.key), indent=2))
    elif args.cmd == "zip":
        for f in zip_subdirs(args.base_dir, args.output_dir, workers=args.workers):
            print(f"zipped {f}")


if __name__ == "__main__":
    _cli()

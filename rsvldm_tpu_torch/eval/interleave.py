"""Interleave-benchmark result aggregation (rsvldm_tpu/eval/interleave.py):
read result.jsonl, group by dataset, score open-ended sets with Rouge-L
and multi-choice sets with normalized-answer accuracy, then average per
task category, as LLaVA's evaluate_interleave.py does. Rouge is
text_metrics.rouge_l."""

from __future__ import annotations

import json
import os
from typing import Dict, List

from .text_metrics import evaluate_multichoice, normalize_answer, rouge_l

# evaluate_interleave.py:11-20 task-category membership
CATEGORIES = {
    "spot_the_diff": ["Spot-the-Diff", "Birds-to-Words", "CLEVR-Change"],
    "image_edit_instruct": ["IEdit", "HQ-Edit", "MagicBrush"],
    "visual_story_telling": ["AESOP", "FlintstonesSV", "PororoSV", "VIST"],
    "visual_cloze": ["COMICS_Dialogue", "RecipeQA_VisualCloze"],
    "text_rich_vqa": ["WebQA", "TQA", "OCR-VQA", "DocVQA"],
    "multi_image_vqa": ["MIT-States_StateCoherence",
                        "MIT-States_PropertyCoherence", "VISION",
                        "RecipeQA_ImageCoherence"],
    "puzzle": ["RAVEN"],
    "nlrv2": ["NLVR2_Mantis"],
    "qbench": ["QBench"],
}


def evaluate_rouge(preds: List[dict]) -> tuple[dict, list]:
    """Eval.evaluate_rouge (:74-97): normalized texts, empty-gt samples
    skipped, empty predictions score 0, predictions capped at 512 chars."""
    scores, eval_list = [], []
    for res in preds:
        gt = normalize_answer(res["gt_response"])
        pred = normalize_answer(res["pred_response"])
        if gt == "":
            continue
        s = 0.0 if pred == "" else rouge_l(pred[:512], gt)
        scores.append(s)
        eval_list.append({"id": str(res["sample_id"]),
                          "score": str(round(s, 3))})
    mean = sum(scores) / len(scores) if scores else 0.0
    return {"Rouge-L f": mean}, eval_list


def evaluate_results(preds_all: List[dict]) -> tuple[Dict, Dict, Dict]:
    """Grouped scoring + category averages. Returns (per-dataset results,
    per-dataset detail lists, per-category averages)."""
    by_ds: Dict[str, List[dict]] = {}
    for p in preds_all:
        by_ds.setdefault(p["dataset"], []).append(p)

    results, details = {}, {}
    for ds, preds in by_ds.items():
        qt = preds[0]["question_type"]
        if qt == "open-ended":
            res, lst = evaluate_rouge(preds)
        elif qt == "multi-choice" or ds == "nlrv2":
            # the reference's image-choice variant normalizes gt too —
            # functionally identical to evaluate_multichoice (judging
            # normalizes both sides)
            res, lst = evaluate_multichoice(preds)
        else:
            raise ValueError(f"dataset {ds}: unsupported question_type "
                             f"{qt!r}")
        results[ds] = res
        details[ds] = lst

    cats = {}
    for cat, members in CATEGORIES.items():
        vals = [list(results[ds].values())[0]
                for ds in results if ds in members]
        if vals:
            cats[cat] = sum(vals) / len(vals)
    return results, details, cats


def evaluate_result_dir(result_dir: str) -> Dict:
    """The script surface: read <dir>/result.jsonl, write
    eval_dataset.json / eval_dataset_details.json, return the category
    averages."""
    path = os.path.join(result_dir, "result.jsonl")
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    with open(path) as f:
        preds_all = [json.loads(ln) for ln in f if ln.strip()]
    results, details, cats = evaluate_results(preds_all)
    with open(os.path.join(result_dir, "eval_dataset.json"), "w") as f:
        json.dump(results, f, indent=4)
    with open(os.path.join(result_dir, "eval_dataset_details.json"),
              "w") as f:
        json.dump(details, f, indent=4)
    with open(os.path.join(result_dir, "eval_cat.json"), "w") as f:
        json.dump(cats, f, indent=4)
    return cats

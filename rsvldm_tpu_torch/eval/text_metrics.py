"""Caption and answer metrics (rsvldm_tpu/eval/text_metrics.py, a copy:
the port imports nothing of the JAX package). Rouge-L and TF-IDF cosine of
generated against reference text, and the multi-choice answer judging of
LLaVA's evaluate_interleave.py; pure Python, no rouge or sklearn."""

from __future__ import annotations

import math
import re
from collections import Counter


def _tokens(s: str) -> list[str]:
    return re.findall(r"[a-z0-9]+", s.lower())


def _lcs(a: list[str], b: list[str]) -> int:
    m, n = len(a), len(b)
    dp = [0] * (n + 1)
    for i in range(1, m + 1):
        prev = 0
        for j in range(1, n + 1):
            cur = dp[j]
            dp[j] = prev + 1 if a[i - 1] == b[j - 1] else max(dp[j], dp[j - 1])
            prev = cur
    return dp[n]


def rouge_l(candidate: str, reference: str, beta: float = 1.2) -> float:
    """ROUGE-L F-measure."""
    c, r = _tokens(candidate), _tokens(reference)
    if not c or not r:
        return 0.0
    lcs = _lcs(c, r)
    p = lcs / len(c)
    rec = lcs / len(r)
    if p == 0 or rec == 0:
        return 0.0
    return (1 + beta**2) * p * rec / (rec + beta**2 * p)


def tfidf_cosine(a: str, b: str, corpus: list[str] | None = None) -> float:
    """TF-IDF cosine similarity; idf from `corpus` (defaults to the pair)."""
    docs = [_tokens(d) for d in (corpus or [a, b])]
    n_docs = len(docs)
    df = Counter()
    for d in docs:
        df.update(set(d))
    idf = {t: math.log((1 + n_docs) / (1 + c)) + 1 for t, c in df.items()}

    def vec(s):
        tf = Counter(_tokens(s))
        return {t: f * idf.get(t, math.log(1 + n_docs) + 1)
                for t, f in tf.items()}

    va, vb = vec(a), vec(b)
    dot = sum(va[t] * vb.get(t, 0.0) for t in va)
    na = math.sqrt(sum(v * v for v in va.values()))
    nb = math.sqrt(sum(v * v for v in vb.values()))
    if na == 0 or nb == 0:
        return 0.0
    return dot / (na * nb)


def evaluate_captions(pairs: list[tuple[str, str]]) -> dict:
    """Aggregate Rouge-L / TF-IDF over (candidate, reference) pairs."""
    if not pairs:
        return {"rouge_l": 0.0, "tfidf_cosine": 0.0, "n": 0}
    corpus = [p[0] for p in pairs] + [p[1] for p in pairs]
    rl = sum(rouge_l(c, r) for c, r in pairs) / len(pairs)
    tc = sum(tfidf_cosine(c, r, corpus) for c, r in pairs) / len(pairs)
    return {"rouge_l": rl, "tfidf_cosine": tc, "n": len(pairs)}


# ---- multi-choice judging (evaluate_interleave.py's Eval) ----------------

_PUNCT = [";", "/", "[", "]", '"', "{", "}", "(", ")", "=", "+", "\\",
          "_", "-", ">", "<", "@", "`", ",", "?", "!"]
_PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
_COMMA_STRIP = re.compile(r"(\d)(\,)(\d)")


def normalize_answer(answer: str) -> str:
    """The reference's Eval.process answer normalization
    (evaluate_interleave.py:50-72), bug-for-bug: the space-adjacency test
    runs against the ORIGINAL (stripped) input each iteration — not the
    progressively mutated string — and the period strip passes re.UNICODE
    (=32) as sub's COUNT argument, so only the first 32 non-decimal
    periods are removed. Both quirks matter for exact-match judging."""
    src = answer.replace("\n", " ").replace("\t", " ").strip()
    out = src
    for p in _PUNCT:
        if (p + " " in src or " " + p in src
                or _COMMA_STRIP.search(src) is not None):
            out = out.replace(p, "")
        else:
            out = out.replace(p, " ")
    out = _PERIOD_STRIP.sub("", out, 32)   # re.UNICODE-as-count quirk
    for ch in ("'", '"', ")", "("):
        out = out.strip(ch)
    return out.strip().lower()


def judge_multi_choice(gt: str, pred: str) -> int:
    """1 iff the normalized prediction matches the normalized ground
    truth; a 'X: ...' prefix whose X is a single letter a-h is read as the
    chosen option (evaluate_interleave.py:100-115)."""
    gt, pred = normalize_answer(gt), normalize_answer(pred)
    if ":" in pred:
        for part in (p.strip() for p in pred.split(":")):
            if len(part) == 1 and part in "abcdefgh":
                pred = part
    return int(pred == gt)


def evaluate_multichoice(samples: list[dict]) -> tuple[dict, list[dict]]:
    """samples: [{"sample_id", "gt_response", "pred_response"}] ->
    ({"Accuracy": ...}, per-sample score list) — the reference's
    evaluate_multichoice/evaluate_multi_choice_image (identical logic)."""
    correct = 0
    eval_list = []
    for s in samples:
        score = judge_multi_choice(s["gt_response"], s["pred_response"])
        eval_list.append({"id": str(s["sample_id"]), "score": str(score)})
        correct += score
    return {"Accuracy": correct / len(samples) if samples else 0.0}, eval_list

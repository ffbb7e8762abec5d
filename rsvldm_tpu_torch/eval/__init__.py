from .runner import split_list, get_chunk, ChunkedEvalRunner
from .text_metrics import (rouge_l, tfidf_cosine, evaluate_captions,
                           normalize_answer, judge_multi_choice,
                           evaluate_multichoice)

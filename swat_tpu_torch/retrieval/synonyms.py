"""Synonym filtering via zero-shot text classification (counterpart of
``swat_tpu/retrieval/synonyms.py``).

The compute half of the reference's synonym mining (reference
retrieval/query_synonyms/clip_text_filtering.py:29-76): every candidate
synonym is embedded as ``a photo of a {name}`` and classified against the
per-class true-name prompts; a synonym survives only when its argmax lands
on its own class.  The LLM query that *produces* the candidates is
``query_synonyms``; this filter consumes its JSON output format
({class_id: {'query_name': str, 'synonyms': {name: count}}}).

All prompts (class names + every synonym) are tokenized and encoded by the
text tower in padded batches on its device; the classification is one
[S, C] product on the host.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np

from swat_tpu_torch.data.features import batched_encode


def _prompt(name: str) -> str:
    # reference clip_text_filtering.py:31: 'a photo of a {name}'
    return f"a photo of a {name}"


def filter_synonyms(encode_fn: Callable, tokenizer, names: Dict[str, dict],
                    context_length: int = 77, batch_size: int = 1024,
                    log=None) -> Dict[str, dict]:
    """Adds a ``synonyms_filtered`` dict to every class entry.

    encode_fn: [N, context] int32 tokens -> [N, D] normalized features
    (``data.features.make_text_encoder``).  Classifier rows are the
    *normalized* class embeddings; the query embedding is classified by
    argmax (scale- and normalization-invariant, matching reference
    :69-73)."""
    keys = sorted(names, key=lambda k: int(k) if str(k).isdigit() else k)
    class_prompts = [_prompt(names[k]["query_name"]) for k in keys]
    syn_lists: List[List[str]] = [list(names[k]["synonyms"]) for k in keys]
    flat_syns = [s for lst in syn_lists for s in lst]

    all_texts = class_prompts + [_prompt(s) for s in flat_syns]
    tokens = tokenizer(all_texts, context_length)
    feats = batched_encode(encode_fn, tokens, batch_size)

    c = len(keys)
    classifier = feats[:c]                      # [C, D] normalized
    syn_feats = feats[c:]                       # [S, D]
    if len(flat_syns):
        pred = np.argmax(syn_feats @ classifier.T, axis=-1)
    else:
        pred = np.empty(0, np.int64)

    ofs = 0
    for ci, k in enumerate(keys):
        kept = {}
        for s in syn_lists[ci]:
            if pred[ofs] == ci:
                kept[s] = 0
            elif log is not None:
                log(f"{k} - {names[k]['query_name']}: unmatch {s} - "
                    f"{int(pred[ofs])}")
            ofs += 1
        names[k]["synonyms_filtered"] = kept
    return names

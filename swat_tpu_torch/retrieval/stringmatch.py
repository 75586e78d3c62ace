# Copied from swat_tpu/retrieval/stringmatch.py; the port keeps its own copy, permanently (it imports nothing of swat_tpu).
"""Caption string matching — the SQLite-FTS5 replacement.

The reference matches class-name synonyms against LAION-400M captions with
FTS5 ``MATCH 'tok + tok'`` queries over 32 shard tables of a 135 GB SQLite
db (reference retrieval/laion_parser.py:129-182,205-255).  Here the same
matching semantics run against an in-memory inverted index:

* caption normalization identical to the FTS ingest path (quotes stripped,
  '-'/'_' -> space; laion_parser.py:72) plus FTS5's case-insensitive
  tokenization;
* query normalization identical to ``clean_text`` + ``parse_multi_words``
  (:257-258, :95-102): PHRASE-of-tokens.  FTS5's ``+`` is the phrase
  concatenation operator — ``MATCH 'tok + tok'`` requires the tokens
  ADJACENT IN ORDER, exactly like the quoted ``MATCH '"tok + tok"'``
  branch (verified against stdlib sqlite3 FTS5; the reference's in-code
  comment claiming '+' means all-of-the-tokens, laion_parser.py:102,
  describes FTS5 incorrectly — the executed semantics are phrase, and
  those are what retrieved pools were built with);
* per-class synonym loop with cross-synonym caption dedup and frequency
  counting (:129-182);
* ``find_most_common_name`` with the RELAXED/STRICT subset rules
  (:261-311).

The index itself has two engines: this pure-python/numpy one (reference
semantics, used in tests) and the C++ shared library under ``indexer/``
(same tokenization, ~10-50x faster build+query for corpus-scale runs) —
`swat_tpu_torch.retrieval.indexer` picks the C++ engine when the .so is built.
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np

_TOKEN_RE = re.compile(r"[0-9a-z]+")


def clean_text(text: str) -> str:
    """reference laion_parser.py:257-258 — must match exactly or retrieved
    pools drift (SURVEY.md §7 'Hard parts')."""
    return (text.strip().replace("'", "").replace('"', "")
            .replace("-", " ").replace("_", " ").replace("  ", " ").lower())


def normalize_caption(text: str) -> str:
    """FTS ingest normalization (laion_parser.py:72)."""
    if not text:
        return "N.A."
    return (text.replace('"', "").replace("'", "")
            .replace("-", " ").replace("_", " "))


# unicode61(remove_diacritics=1) tables, EXTRACTED from sqlite's executed
# behavior per codepoint (scripts/gen_unicode61_table.py via fts5vocab):
# token chars are alphanumerics of ANY script; standalone combining marks
# are dropped mid-token; precomposed chars fold per sqlite's internal
# Latin table (ü->u, é->e, ḡ->g) while ø/æ/ß/ł/ё/ά keep their identity;
# case folds to lowercase in every script.  r4 shipped an NFD
# approximation that separated on ø/æ/ß/non-Latin — the r5 differential
# oracle runs non-ASCII corpora, so both engines now reproduce the table.
from swat_tpu_torch.retrieval import _unicode61 as _U61

_ID_LO = [a for a, _ in _U61.IDENTITY_RANGES]
_ID_HI = [b for _, b in _U61.IDENTITY_RANGES]
_TR_LO = [a for a, _ in _U61.TRANSPARENT_RANGES]
_TR_HI = [b for _, b in _U61.TRANSPARENT_RANGES]


def _in_ranges(cp: int, lo, hi) -> bool:
    import bisect

    i = bisect.bisect_right(lo, cp) - 1
    return i >= 0 and cp <= hi[i]


def _u61_class(cp: int):
    """None = separator, '' = transparent (dropped mid-token),
    str = token character's folded form."""
    f = _U61.FOLDS.get(cp)
    if f is not None:
        return f
    if _in_ranges(cp, _ID_LO, _ID_HI):
        return chr(cp)
    if _in_ranges(cp, _TR_LO, _TR_HI):
        return ""
    return None


def tokenize(text: str) -> List[str]:
    """FTS5 unicode61(remove_diacritics=1) tokens — exact, per the
    extracted tables (the ASCII fast path is the same classification:
    [0-9a-z] identity, [A-Z] fold, rest separator)."""
    if text.isascii():
        return _TOKEN_RE.findall(text.lower())
    out: List[str] = []
    cur = ""
    for ch in text:
        c = _u61_class(ord(ch))
        if c is None:
            if cur:
                out.append(cur)
                cur = ""
        else:
            cur += c
    if cur:
        out.append(cur)
    return out


def is_phrase_query(raw_name: str) -> bool:
    """Every multi-word name is phrase-matched: the reference's unquoted
    ``MATCH 'tok + tok'`` (laion_parser.py:159-167) and its quoted
    parens/'.'-'/' branch (:84,:159) are BOTH FTS5 phrase queries — '+'
    is FTS5's phrase concatenation operator, so the two branches differ
    only in special-character escaping, not semantics (verified against
    stdlib sqlite3 FTS5; tests/test_retrieval.py fts5-oracle test)."""
    return True


class CaptionIndex:
    """Inverted index over captions with AND / phrase queries."""

    def __init__(self, captions: Sequence[str]):
        self.captions = [normalize_caption(c) for c in captions]
        self._tokens: List[List[str]] = [tokenize(c) for c in self.captions]
        postings: Dict[str, List[int]] = defaultdict(list)
        for i, toks in enumerate(self._tokens):
            for t in set(toks):
                postings[t].append(i)
        self._postings = {t: np.asarray(ids, np.int64)
                          for t, ids in postings.items()}

    def __len__(self):
        return len(self.captions)

    def query(self, name: str, phrase: bool = False) -> np.ndarray:
        """Caption ids containing ALL tokens of ``name`` (phrase=True
        additionally requires the tokens to be adjacent in order)."""
        toks = tokenize(clean_text(name).replace("(", "").replace(")", ""))
        if not toks:
            return np.empty(0, np.int64)
        lists = []
        for t in toks:
            if t not in self._postings:
                return np.empty(0, np.int64)
            lists.append(self._postings[t])
        result = lists[0]
        for lst in lists[1:]:
            result = np.intersect1d(result, lst, assume_unique=True)
        if phrase and len(toks) > 1:
            keep = [i for i in result
                    if _contains_phrase(self._tokens[i], toks)]
            result = np.asarray(keep, np.int64)
        return result


def _contains_phrase(hay: List[str], needle: List[str]) -> bool:
    n = len(needle)
    for i in range(len(hay) - n + 1):
        if hay[i: i + n] == needle:
            return True
    return False


def match_class_synonyms(index, metrics: dict,
                         prefix: Optional[str] = None
                         ) -> Tuple[dict, List[Tuple[str, int]]]:
    """Per-class matching loop (reference __get_text_worker__,
    laion_parser.py:129-182).

    metrics: one class's dict with 'alternates' {name: count} and optional
    'changed_name'.  Returns (updated metrics, [(synonym, caption_id)])
    with captions deduped across synonyms; synonym counts updated in place.
    ``index`` needs .query(name, phrase) -> ids.
    """
    sorted_alts = sorted(metrics["alternates"].items(), key=lambda x: x[1])
    label_stack = [name for name, _ in sorted_alts]
    if "changed_name" in metrics:
        label_stack.append(metrics["changed_name"])

    searched: Set[str] = set()
    caption_set: Set[int] = set()
    total_matches: List[Tuple[str, int]] = []
    while label_stack:
        og_name = label_stack.pop()
        name = clean_text(og_name)
        if name in searched:
            continue
        searched.add(name)
        if prefix is not None:
            name = f"{prefix} {name}"
        ids = index.query(name, phrase=is_phrase_query(name))
        metrics["alternates"][og_name] = int(len(ids))
        for cid in ids:
            cid = int(cid)
            if cid not in caption_set:
                caption_set.add(cid)
                total_matches.append((og_name, cid))
    return metrics, total_matches


def find_most_common_name(metrics: dict,
                          matching_strategy: str = "RELAXED") -> str:
    """reference laion_parser.py:261-311: pick the synonym with the highest
    caption frequency, except (RELAXED) a strict subset of the official
    name's tokens never wins (too generic) unless it is a permutation."""
    official_name = metrics.get("changed_name", metrics["name"])
    official_name_og = "".join(official_name)

    alternates = dict(sorted(metrics["alternates"].items(),
                             key=lambda x: x[1], reverse=True))
    most_common_name = official_name_og

    if official_name in alternates:
        freq = alternates[official_name]
    elif clean_text(official_name) in alternates:
        freq = alternates[clean_text(official_name)]
    else:
        freq = 0

    official = re.sub(r"[^\w\s]", "", clean_text(official_name))
    official_split = set(official.split())

    for alt_og, alt_freq in alternates.items():
        alt = re.sub(r"[^\w\s]", "", clean_text(alt_og))
        alt_split = set(alt.split())
        if freq < alt_freq:
            if matching_strategy == "STRICT":
                most_common_name = alt_og
            elif matching_strategy == "RELAXED" and \
                    alt_split == official_split:
                most_common_name = alt_og
            elif matching_strategy == "RELAXED" and \
                    not alt_split.issubset(official_split):
                most_common_name = alt_og
            freq = alt_freq
    return most_common_name


def match_all_classes(index, all_metrics: Dict[str, dict],
                      prefix: Optional[str] = None,
                      num_threads: int = 8):
    """Whole-dataset matching (reference get_text_parallel,
    laion_parser.py:205-255): thread pool over classes, then
    most-common-name selection and per-class frequency stats."""
    import concurrent.futures as cf

    retrieved: Dict[str, List[Tuple[str, int]]] = {}
    class_frequency: Dict[str, int] = {}

    def work(item):
        key, metrics = item
        m, matches = match_class_synonyms(index, dict(metrics), prefix)
        return key, m, matches

    with cf.ThreadPoolExecutor(num_threads) as pool:
        for key, m, matches in pool.map(work, sorted(
                all_metrics.items(), key=lambda kv: int(kv[0]))):
            all_metrics[key] = m
            retrieved[key] = matches
            class_frequency[key] = len(matches)
            all_metrics[key]["most_common_name"] = find_most_common_name(m)
    return retrieved, all_metrics, class_frequency

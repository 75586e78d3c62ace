# Copied from swat_tpu/retrieval/query_synonyms.py; the port keeps its own copy, permanently (it imports nothing of swat_tpu).
"""Class-name synonym mining via an LLM — the step that PRODUCES the
candidate synonyms the CLIP filter (retrieval/synonyms.py) consumes.

Mirrors reference retrieval/query_synonyms/query_synonyms.py:16-127 as a
pluggable-backend pipeline so the whole REAL-Prompt metrics chain can be
reproduced from scratch:

  * per-dataset user prompts (``rename``, reference :16-75) and expert
    system messages (``get_description``, reference :84-112) — these
    strings are the behavioral contract (they determine what the LLM
    returns and therefore which captions get retrieved);
  * numbered-list response parsing + bracket stripping + ``clean_text``
    normalization + set-dedup (reference :163-166,
    remove_duplicate.py:8-16);
  * the official (and for semi-aves: scientific + common) names merged
    back in after filtering (format_synonyms.add_names:14-44);
  * output = the metrics-JSON shape the downstream filter/stringmatch
    steps consume.

The LLM itself is injected as ``backend(messages) -> str``:
``recorded_backend`` replays a committed JSON fixture (tests / offline
reproduction), ``openai_backend`` calls the OpenAI chat API when the
package and key are available (reference model: gpt-3.5-turbo, :117).
"""

from __future__ import annotations

import json
import re
from typing import Callable, Dict, List, Optional, Sequence

Backend = Callable[[List[dict]], str]

_GENERIC = ("What are some common ways of referring to a {label} ? "
            "Give me a numbered list only. Don't give any other text. "
            "Give me English names only.")

# reference rename(), query_synonyms.py:16-75 — one phrasing per dataset
PROMPTS: Dict[str, str] = {
    "dtd": ("What are some common ways of referring to a texture i.e. "
            "{label} ? Give me a numbered list only. Don't give any other "
            "text. Give me English names only."),
    "fgvc-aircraft": ("What are some common ways of referring to an "
                      "aircraft i.e. {label} ? Give me a numbered list "
                      "only. Don't give any other text. Give me English "
                      "names only."),
    "flowers102": ("What are some common ways of referring to a flower "
                   "i.e. {label} ? Give me a numbered list only. Don't "
                   "give any other text. Give me English names only."),
    "oxford_pets": ("What are some common ways of referring to a pet "
                    "i.e. {label} ? Give me a numbered list only. Don't "
                    "give any other text. Give me English names only."),
    "sun397": ("What are some common ways of referring to a scene i.e. "
               "{label} ? Give me a numbered list only. Don't give any "
               "other text. Give me English names only."),
    "food101": ("What are some common ways of referring to a food i.e. "
                "{label} ? Give me a numbered list only. Don't give any "
                "other text. Give me English names only."),
    "stanford_cars": ("What are some common ways of referring to a car "
                      "i.e. {label} ? Give me a numbered list only. "
                      "Don't give any other text. Give me English names "
                      "only."),
    "caltech-101": ("What are some common ways of referring to a {label} "
                    ", which is defined as {definition} ? Give me a "
                    "numbered list only. Don't give any other text. Give "
                    "me English names only."),
    "semi-aves": ("What are some common ways of referring to a {label} , "
                  "a type of a bird ? Give me a numbered list only. "
                  "Don't give any other text. Give me English names "
                  "only."),
}

# reference get_description(), query_synonyms.py:84-112
SYSTEM_MESSAGES: Dict[str, str] = {
    "semi-aves": ("You are a helpful and honest assistant. You are an "
                  "expert in bird species recognition."),
    "fgvc-aircraft": ("You are a helpful and honest assistant. You are "
                      "an expert in aircraft model recognition."),
    "flowers102": ("You are a helpful and honest assistant. You are an "
                   "expert in flower species recognition."),
    "eurosat": ("You are a helpful and honest assistant. You are an "
                "expert in satellite recognition."),
    "dtd": ("You are a helpful and honest assistant. You are an expert "
            "in textual data recognition."),
}
_DEFAULT_SYSTEM = "You are a helpful and honest assistant."


def build_messages(dataset: str, label: str,
                   definition: Optional[str] = None) -> List[dict]:
    prompt = PROMPTS.get(dataset, _GENERIC).format(
        label=label, definition=definition)
    system = SYSTEM_MESSAGES.get(dataset, _DEFAULT_SYSTEM)
    return [{"role": "system", "content": system},
            {"role": "user", "content": prompt}]


def clean_brackets(text: str) -> str:
    """reference query_synonyms.py:163-164."""
    return re.sub(r"\([^)]*\)|\[.*?\]", "", text)


def clean_text(text: str) -> str:
    """reference query_synonyms.py:166."""
    return (text.strip().replace("'", "").replace('"', "")
            .replace("-", " ").replace("_", " ").lower())


def parse_numbered_list(response: str) -> List[str]:
    """'1. Kite\n2. Black Kite' -> ['Kite', 'Black Kite'] — strips
    numbering, brackets, and empty rows."""
    names = []
    for line in response.splitlines():
        line = re.sub(r"^\s*\d+[.)]\s*", "", line)
        line = clean_brackets(line).strip()
        if line:
            names.append(line)
    return names


def mine_synonyms(dataset: str, class_names: Sequence,
                  backend: Backend,
                  definitions: Optional[Sequence[str]] = None,
                  log=None) -> Dict[str, dict]:
    """Query the backend per class and assemble the metrics-JSON dict.

    class_names: per class either ``name`` or ``(sname, cname)``
    (semi-aves passes scientific + common name pairs, reference
    format_synonyms.add_names:22-33).  Returns
    {idx: {'query_name', 'name', 'synonyms': {clean_name: 0}}} — the
    shape retrieval/synonyms.filter_synonyms consumes.
    """
    out: Dict[str, dict] = {}
    for idx, entry in enumerate(class_names):
        if isinstance(entry, (tuple, list)):
            # semi-aves: (scientific, common); the LLM is asked about the
            # scientific name ('a type of a bird', reference :66-68)
            sname, cname = entry
            query_name = sname
        else:
            sname, cname = None, None
            query_name = entry
        definition = definitions[idx] if definitions else None
        if dataset == "caltech-101" and definition is None:
            # the template interpolates the definition (reference :59-62);
            # None would be formatted into the prompt verbatim
            raise ValueError(
                "caltech-101 mining requires per-class definitions "
                "(reference GPT3_caltech-101.tsv)")
        response = backend(build_messages(dataset, query_name, definition))
        names = set(clean_text(n) for n in parse_numbered_list(response))
        # official names always included (format_synonyms.add_names)
        names.add(clean_text(query_name))
        if sname is not None:    # both official names merged in
            names.add(clean_text(sname))   # (add_names, :27-33)
        if cname is not None:
            names.add(clean_text(cname))
        out[str(idx)] = {
            "query_name": query_name,
            "name": query_name,
            "synonyms": {n: 0 for n in sorted(names) if n},
        }
        if cname is not None:
            out[str(idx)]["common_name"] = cname
        if log:
            log(f"[{idx}] {query_name}: {len(names)} candidate names")
    return out


def recorded_backend(fixture_path: str) -> Backend:
    """Replay committed responses keyed by the user-prompt label — makes
    the mining step reproducible offline and testable without an API."""
    with open(fixture_path) as f:
        recorded = json.load(f)

    def backend(messages: List[dict]) -> str:
        user = messages[-1]["content"]
        # longest label first: '707-320' must not be served '707''s
        # recorded response just because the shorter name is a substring
        for label in sorted(recorded, key=len, reverse=True):
            if label in user:
                return recorded[label]
        raise KeyError(f"no recorded response matches prompt: {user!r}")

    return backend


def openai_backend(model: str = "gpt-3.5-turbo") -> Backend:
    """Live OpenAI chat backend (reference query_synonyms.py:115-127).
    Gated: raises a clear error when the package/key are unavailable."""
    try:
        from openai import OpenAI
    except ImportError as e:  # pragma: no cover - package not in image
        raise RuntimeError(
            "openai package not installed; use recorded_backend() or "
            "inject a custom backend") from e
    client = OpenAI()

    def backend(messages: List[dict]) -> str:  # pragma: no cover - network
        resp = client.chat.completions.create(model=model,
                                              messages=messages)
        return resp.choices[0].message.content

    return backend

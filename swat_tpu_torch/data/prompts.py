# Copied from swat_tpu/data/prompts.py without encode_prompts, which the port keeps in swat_tpu_torch/data/features.py; the port keeps its own copy, permanently (it imports nothing of swat_tpu).
"""Prompt subsystem: per-dataset templates, prompt construction, encoding.

Mirrors the behavior of the reference prompt layer (utils/prompt.py):
class-name metadata comes from ``{dataset}_metrics-LAION400M.json`` files
(class_id -> {name, most_common_name, alternates, ...}); prompts are
``template.format(name)`` over the dataset's template list; the zero-shot
classifier weight for a class is the re-normalized mean of its normalized
prompt embeddings (utils/features.py:57-59).

The template lists are the standard OpenAI-CLIP prompt sets for each
benchmark (public prompt data, also hard-coded by the reference at
utils/prompt.py:153-389) — they are *accuracy-defining constants*, so they
must match verbatim.

Name types (reference --prompt_name, utils/parser.py:27-29):
``most_common_name`` (REAL-Prompt), ``name`` (original class name),
``most_common_name_REAL``, ``alternates`` (all synonyms), and the
semi-aves-specific s-/c-/t-/f-name variants.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Mapping

import numpy as np

_IMAGENET_TEMPLATES = [
    "a bad photo of a {}.", "a photo of many {}.", "a sculpture of a {}.",
    "a photo of the hard to see {}.", "a low resolution photo of the {}.",
    "a rendering of a {}.", "graffiti of a {}.", "a bad photo of the {}.",
    "a cropped photo of the {}.", "a tattoo of a {}.", "the embroidered {}.",
    "a photo of a hard to see {}.", "a bright photo of a {}.",
    "a photo of a clean {}.", "a photo of a dirty {}.",
    "a dark photo of the {}.", "a drawing of a {}.", "a photo of my {}.",
    "the plastic {}.", "a photo of the cool {}.", "a close-up photo of a {}.",
    "a black and white photo of the {}.", "a painting of the {}.",
    "a painting of a {}.", "a pixelated photo of the {}.",
    "a sculpture of the {}.", "a bright photo of the {}.",
    "a cropped photo of a {}.", "a plastic {}.", "a photo of the dirty {}.",
    "a jpeg corrupted photo of a {}.", "a blurry photo of the {}.",
    "a photo of the {}.", "a good photo of the {}.", "a rendering of the {}.",
    "a {} in a video game.", "a photo of one {}.", "a doodle of a {}.",
    "a close-up photo of the {}.", "a photo of a {}.", "the origami {}.",
    "the {} in a video game.", "a sketch of a {}.", "a doodle of the {}.",
    "a origami {}.", "a low resolution photo of a {}.", "the toy {}.",
    "a rendition of the {}.", "a photo of the clean {}.",
    "a photo of a large {}.", "a rendition of a {}.", "a photo of a nice {}.",
    "a photo of a weird {}.", "a blurry photo of a {}.", "a cartoon {}.",
    "art of a {}.", "a sketch of the {}.", "a embroidered {}.",
    "a pixelated photo of a {}.", "itap of the {}.",
    "a jpeg corrupted photo of the {}.", "a good photo of a {}.",
    "a plushie {}.", "a photo of the nice {}.", "a photo of the small {}.",
    "a photo of the weird {}.", "the cartoon {}.", "art of the {}.",
    "a drawing of the {}.", "a photo of the large {}.",
    "a black and white photo of a {}.", "the plushie {}.",
    "a dark photo of a {}.", "itap of a {}.", "graffiti of the {}.",
    "a toy {}.", "itap of my {}.", "a photo of a cool {}.",
    "a photo of a small {}.", "a tattoo of the {}.",
]

_CALTECH101_TEMPLATES = [
    "a photo of a {}.", "a painting of a {}.", "a plastic {}.",
    "a sculpture of a {}.", "a sketch of a {}.", "a tattoo of a {}.",
    "a toy {}.", "a rendition of a {}.", "a embroidered {}.",
    "a cartoon {}.", "a {} in a video game.", "a plushie {}.",
    "a origami {}.", "art of a {}.", "graffiti of a {}.", "a drawing of a {}.",
    "a doodle of a {}.", "a photo of the {}.", "a painting of the {}.",
    "the plastic {}.", "a sculpture of the {}.", "a sketch of the {}.",
    "a tattoo of the {}.", "the toy {}.", "a rendition of the {}.",
    "the embroidered {}.", "the cartoon {}.", "the {} in a video game.",
    "the plushie {}.", "the origami {}.", "art of the {}.",
    "graffiti of the {}.", "a drawing of the {}.", "a doodle of the {}.",
]

_DTD_TEMPLATES = [
    "a photo of a {} texture.", "a photo of a {} pattern.",
    "a photo of a {} thing.", "a photo of a {} object.",
    "a photo of the {} texture.", "a photo of the {} pattern.",
    "a photo of the {} thing.", "a photo of the {} object.",
]

_EUROSAT_TEMPLATES = [
    "a centered satellite photo of {}.",
    "a centered satellite photo of a {}.",
    "a centered satellite photo of the {}.",
]

_AIRCRAFT_TEMPLATES = [
    "a photo of a {}, a type of aircraft.",
    "a photo of the {}, a type of aircraft.",
]

_FLOWERS_TEMPLATES = ["a photo of a {}, a type of flower."]
_FOOD_TEMPLATES = ["a photo of {}, a type of food."]
_PETS_TEMPLATES = ["a photo of a {}, a type of pet."]
_SUN397_TEMPLATES = ["a photo of a {}.", "a photo of the {}."]

_CARS_TEMPLATES = [
    "a photo of a {}.", "a photo of the {}.", "a photo of my {}.",
    "i love my {}!", "a photo of my dirty {}.", "a photo of my clean {}.",
    "a photo of my new {}.", "a photo of my old {}.",
]

_AVES_BIRD = ["a photo of a {}, a type of bird."]
_SEMI_AVES_TEMPLATES = {
    "s-name": _AVES_BIRD,
    "c-name": _AVES_BIRD,
    "t-name": ["a photo of a {}, a type of bird, commonally known as {}."],
    "f-name": _AVES_BIRD,
    "most_common_name": _AVES_BIRD,
    "alternates": _AVES_BIRD,
    "most_common_name_REAL": _AVES_BIRD,
    "name": _AVES_BIRD,
    "c-name-80prompts": _IMAGENET_TEMPLATES,
}

TEMPLATES: Dict[str, object] = {
    "imagenet": _IMAGENET_TEMPLATES,
    "imagenet_1k": _IMAGENET_TEMPLATES,
    "imagenet_1k_mined": _IMAGENET_TEMPLATES,
    "imagenet_v2": _IMAGENET_TEMPLATES,
    "flowers102": _FLOWERS_TEMPLATES,
    "food101": _FOOD_TEMPLATES,
    "stanford_cars": _CARS_TEMPLATES,
    "fgvc-aircraft": _AIRCRAFT_TEMPLATES,
    "oxford_pets": _PETS_TEMPLATES,
    "dtd": _DTD_TEMPLATES,
    "dtd_selected": _DTD_TEMPLATES,
    "semi-aves": _SEMI_AVES_TEMPLATES,
    "caltech101": _CALTECH101_TEMPLATES,
    "eurosat": _EUROSAT_TEMPLATES,
    "sun397": _SUN397_TEMPLATES,
}


def load_class_metrics(path: str) -> Dict[str, dict]:
    """Load a ``{dataset}_metrics-LAION400M.json`` file (class_id keyed)."""
    with open(path) as f:
        metrics = json.load(f)
    return dict(sorted(metrics.items(), key=lambda kv: int(kv[0])))


def get_templates(dataset: str, name_type: str) -> List[str]:
    # custom datasets fall back to the generic CLIP template (the
    # reference's prompt dicts are hard-coded per benchmark,
    # utils/prompt.py; users must edit source to add one)
    tpl = TEMPLATES.get(dataset, ["a photo of a {}."])
    if isinstance(tpl, dict):  # semi-aves has per-name-type templates
        return tpl[name_type]
    return tpl


def make_prompts(metrics: Mapping[str, dict], dataset: str,
                 name_type: str = "most_common_name"
                 ) -> Dict[str, List[str]]:
    """class_id -> list of prompt strings (reference prompt_maker,
    utils/prompt.py:83-105)."""
    templates = get_templates(dataset, name_type)
    # semi-aves name types read dedicated metrics fields (reference
    # prompt_maker_aves, utils/prompt.py:108-141); t-name formats BOTH the
    # species and common name into its two-placeholder template
    field_of = {"s-name": "species", "c-name": "common_name",
                "c-name-80prompts": "common_name",
                "f-name": "most_freq_synonym"}
    prompts: Dict[str, List[str]] = {}
    for class_id in sorted(metrics, key=int):
        entry = metrics[class_id]
        if name_type == "t-name":
            s_name = entry.get("species", entry.get(name_type))
            c_name = entry.get("common_name", s_name)
            prompts[class_id] = [t.format(s_name, c_name)
                                 for t in templates]
            continue
        if name_type in field_of:
            label = entry.get(field_of[name_type], entry.get(name_type))
        else:
            label = entry[name_type]
        if name_type == "alternates":
            # label is a synonym->count mapping (possibly serialized as str)
            if isinstance(label, str):
                import ast

                label = ast.literal_eval(label)
            corpus = [t.format(name) for name in label for t in templates]
        else:
            corpus = [t.format(label) for t in templates]
        prompts[class_id] = corpus
    return prompts


def make_attribute_prompts(metrics: Mapping[str, dict], dataset: str,
                           attributes: Mapping[str, dict],
                           name_type: str = "most_common_name"
                           ) -> Dict[str, List[str]]:
    """Attribute-augmented prompts (reference 'c-name_attribute',
    utils/prompt.py:134-141): base prompts plus
    ``template(name) + ' {name} {attr}'`` per visual attribute, with the
    reference's 'Has'->'has' normalization.  ``attributes``:
    class_id -> {'corpus': [attr strings]} (visual-attrs json)."""
    templates = get_templates(dataset, name_type)
    prompts: Dict[str, List[str]] = {}
    for class_id in sorted(metrics, key=int):
        name = metrics[class_id][name_type]
        corpus = [t.format(name) for t in templates]
        attrs = attributes.get(str(class_id), {}).get("corpus", [])
        corpus += [t.format(name) + f" {name} {attr}".replace("Has", "has")
                   for t in templates for attr in attrs]
        prompts[class_id] = corpus
    return prompts


def tokenize_prompts(prompts: Mapping[str, List[str]], tokenizer,
                     context_length: int = 77) -> Dict[str, np.ndarray]:
    """class_id -> [n_prompts, context] int32 token array."""
    return {cid: tokenizer(corpus, context_length)
            for cid, corpus in prompts.items()}


def class_embedding_matrix(prompt_tensors: Mapping[str, dict]) -> np.ndarray:
    """[num_classes, D] matrix of per-class mean embeddings — the zero-shot
    classifier weights (reference prompt_sampler(sample_by='mean'),
    utils/features.py:12-23)."""
    return np.stack([prompt_tensors[c]["mean"]
                     for c in sorted(prompt_tensors, key=int)], axis=0)


def save_prompt_tensors(path: str, prompt_tensors: Mapping[str, dict]):
    flat = {}
    for cid, d in prompt_tensors.items():
        flat[f"{cid}/all"] = d["all"]
        flat[f"{cid}/mean"] = d["mean"]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flat)


def load_prompt_tensors(path: str) -> Dict[str, dict]:
    data = np.load(path)
    out: Dict[str, dict] = {}
    for key in data.files:
        cid, kind = key.rsplit("/", 1)
        out.setdefault(cid, {})[kind] = data[key]
    return out

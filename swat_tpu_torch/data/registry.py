# Copied from swat_tpu/data/registry.py; the port keeps its own copy, permanently (it imports nothing of swat_tpu).
"""Dataset registry.

Class counts mirror the reference's NUM_CLASSES_DICT
(reference utils/datasets/dataset_utils.py:13-24); the nine benchmark
datasets are the SWAT paper's evaluation suite (BASELINE.md).
"""

NUM_CLASSES_DICT = {
    "semi-aves": 200,
    "flowers102": 102,
    "fgvc-aircraft": 100,
    "eurosat": 10,
    "dtd": 47,
    "food101": 101,
    "stanford_cars": 196,
    "oxford_pets": 37,
    "imagenet": 1000,
    "semi-inat-2021": 810,
}

# the 9 benchmark datasets (BASELINE.md table)
DATASETS = [
    "semi-aves", "flowers102", "fgvc-aircraft", "eurosat", "dtd",
    "oxford_pets", "food101", "stanford_cars", "imagenet",
]

# Copied from swat_tpu/core/config.py, plus the port's device field; the port keeps its own copy, permanently (it imports nothing of swat_tpu).
"""Run configuration.

Flag-compatible with the reference CLI (utils/parser.py:7-218) but held in
an immutable dataclass; stage transitions produce *derived* configs instead
of mutating args mid-run (the reference mutates ``args`` between stages,
main.py:421-425,481-486 — SURVEY.md §5 flags this as a footgun).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple, Union

from swat_tpu_torch.data.registry import NUM_CLASSES_DICT

SplitSpec = Tuple[List[str], List[str]]

# unregistered-dataset class counts, keyed (name, dataset_dir) — see
# RunConfig.num_classes
_INFERRED_NUM_CLASSES: dict = {}


@dataclasses.dataclass(frozen=True)
class RunConfig:
    # logging
    log_mode: str = "both"
    folder: str = "output"
    prefix: Optional[str] = None

    # model
    model_cfg: str = "vitb32_openclip_laion400m"
    model_path: Optional[str] = None          # warm-start checkpoint
    checkpoint_path: Optional[str] = None     # pretrained OpenCLIP weights
    bpe_path: Optional[str] = None

    # prompts
    prompt_name: str = "most_common_name"
    use_attribute: bool = False
    database: str = "LAION400M"

    # dataset / data sources
    dataset: str = "semi-aves"
    data_source: str = "fewshot"
    shots: int = 16
    retrieval_split: str = "T2T500+T2I0.25.txt"
    unlabeled_split: str = "u_train_in_oracle.txt"
    seed: int = 1
    training_seed: int = 1
    dataset_path: str = "data"
    retrieved_path: str = "data/retrieved"
    test_imagenet_ood: bool = False

    # method
    method: str = "finetune"
    cls_init: str = "REAL-Prompt"
    fewshot_ratio: float = 0.5
    no_wsft: bool = False
    no_tau: bool = False
    mix_prob: float = 0.5
    mixup_alpha: float = 1.0
    cutmix_beta: float = 1.0
    cmo_alpha: float = 1.0
    skip_stage1: bool = False
    skip_stage2: bool = False
    stage1_model_path: Optional[str] = None
    # attentive_threshold is accepted for flag parity; the dispatched
    # attentivemix variant (train_attentivemix2, utils/training.py:2685)
    # reads it but never uses it — only the dormant mask variant does.
    # attentive_name picks the per-class localization text for the
    # heatmap bank (general/'bird' | c-name | s-name, :2717-2731).
    attentive_threshold: float = 0.85
    attentive_name: str = "c-name"

    # fixmatch
    mu: int = 1
    threshold: float = 0.95
    lambda_u: float = 1.0

    # training control
    # (start_validation is accepted for flag parity; it is a no-op in the
    # reference too — every trainer's gate is commented out,
    # utils/training.py:350,624,757)
    check_zeroshot: bool = False
    zeroshot_only: bool = False
    early_stop: bool = False
    epochs: int = 0
    stop_epochs: int = 200
    recal_prompt: bool = False
    recal_fea: bool = False
    pre_extracted: bool = False
    locked_text: bool = False
    freeze_visual: bool = False
    tau_norm: bool = True

    # optimization
    num_workers: int = 16
    start_validation: int = 0
    lr_classifier: float = 1e-4
    lr_backbone: float = 1e-6
    lr_projector: Optional[float] = None
    wd: float = 1e-2
    bsz: int = 32
    # internal: the pre-halving bsz as requested (set by derived(); -1 =
    # not yet derived).  Not a CLI flag.
    requested_bsz: int = -1
    optim: str = "AdamW"
    temperature: float = 0.07
    alpha: float = 0.5                        # WiSE-FT mixing

    # loss
    loss_name: str = "CE"
    dataset_wd: float = 1.0
    fewshot_weight: float = 1.0
    focal_alpha: float = 1.0
    focal_gamma: float = 2.0

    # save
    save_ckpt: bool = False
    save_freq: int = 10
    utrain: Optional[str] = None
    # resume stage-1 training from the latest periodic ckpt in the run's
    # ckpt dir (restores optimizer state — the reference saves but never
    # restores it, SURVEY.md §5)
    resume: bool = False

    # TPU-native additions (no reference equivalent)
    mesh_data: int = -1                       # data-parallel axis size
    mesh_model: int = 1                       # tensor-parallel axis size
    aug_mode: str = "canvas"                  # 'canvas' (device) | 'host'
    use_pallas: bool = False
    remat: Union[bool, str] = False  # False | True("full") | "dots" | "dots_all" | "first<K>"
    accum: int = 1   # microbatches per step (grad accumulation; ViT only)
    compute_dtype: str = "float32"            # reference parity default
    # resident-dataset scan execution: whole epoch / whole eval as one
    # device program (swat_tpu.train.scan_loop)
    resident: str = "auto"                    # 'auto' | 'on' | 'off'
    resident_budget_bytes: int = 6_000_000_000
    # torch.profiler trace output dir (a Chrome trace per rank, viewable in
    # Perfetto or TensorBoard)
    trace_dir: Optional[str] = None
    # port only: the torch device the run uses ('cuda' | 'cpu'); 'cuda'
    # without a GPU raises at start-up instead of falling back to the CPU
    device: str = "cuda"

    # ------------------------------------------------------------------
    # derived (reference utils/parser.py:154-216)

    def derived(self) -> "RunConfig":
        cfg = self
        if cfg.method == "zeroshot":
            cfg = dataclasses.replace(cfg, check_zeroshot=True,
                                      zeroshot_only=True, skip_stage2=True)
        if cfg.zeroshot_only and not cfg.check_zeroshot:
            # --zeroshot_only without --check_zeroshot would print an
            # undefined zero-shot acc (the reference NameErrors there)
            cfg = dataclasses.replace(cfg, check_zeroshot=True)
        # cls_init -> prompt_name coupling (:160-165)
        if cfg.cls_init in ("REAL-Prompt", "REAL-Linear", "random"):
            cfg = dataclasses.replace(cfg, prompt_name="most_common_name")
        elif cfg.cls_init == "text":
            cfg = dataclasses.replace(cfg, prompt_name="name")
        # freeze / pre-extract rules (:167-179)
        if cfg.method in ("probing", "CMLP", "REAL-Linear"):
            cfg = dataclasses.replace(cfg, freeze_visual=True)
        else:
            cfg = dataclasses.replace(cfg, freeze_visual=False,
                                      pre_extracted=False)
        if not cfg.freeze_visual and cfg.pre_extracted:
            raise ValueError("visual encoder not frozen, pre-extracted "
                             "features are not compatible.")
        # batch halving (:181-182) — keyed off the REQUESTED bsz so
        # derived() is idempotent: the CLI derives once and SwatPipeline
        # derives again, which used to quarter the CMLP/finetune-mixed
        # batch (found by the executed-reference CMLP differential,
        # tests/test_reference_oracle_methods.py: ref iter/epoch 1,
        # ours 3).  A bsz that matches what the previous derivation
        # produced is left alone; any other bsz (fresh config, or a
        # dataclasses.replace(bsz=...) / replace(method=...) after
        # deriving) is treated as a new request and re-halved from it.
        halved = cfg.method in ("CMLP", "finetune-mixed")
        if cfg.requested_bsz >= 0 and cfg.bsz == (
                cfg.requested_bsz // 2 if halved else cfg.requested_bsz):
            return cfg
        cfg = dataclasses.replace(
            cfg, requested_bsz=cfg.bsz,
            bsz=cfg.bsz // 2 if halved else cfg.bsz)
        return cfg

    # split specs (reference utils/parser.py:185-207)
    @property
    def dataset_dir(self) -> str:
        return os.path.join(self.dataset_path, self.dataset)

    @property
    def retrieved_dir(self) -> str:
        return os.path.join(self.retrieved_path, self.dataset)

    @property
    def fewshot_file(self) -> str:
        return f"fewshot{self.shots}_seed{self.seed}.txt"

    @property
    def fewshot_data(self) -> SplitSpec:
        return ([self.fewshot_file], [self.dataset_dir])

    @property
    def retrieval_data(self) -> SplitSpec:
        return ([self.retrieval_split], [self.retrieved_dir])

    @property
    def val_split(self) -> SplitSpec:
        # dataset-cls validates on the dedicated mixed split with an empty
        # root (reference utils/parser.py:203: paths are cwd-relative)
        if self.data_source == "dataset-cls":
            return (["dataset_val.txt"], [""])
        return ([self.fewshot_file], [self.dataset_dir])

    @property
    def test_split(self) -> SplitSpec:
        if self.data_source == "dataset-cls":
            return (["dataset_test.txt"], [""])  # parser.py:204
        return (["test.txt"], [self.dataset_dir])

    @property
    def unlabeled_data(self) -> SplitSpec:
        return ([self.unlabeled_split], [self.dataset_dir])

    @property
    def train_split(self) -> SplitSpec:
        src = self.data_source
        if src == "fewshot":
            return self.fewshot_data
        if src == "retrieved":
            return self.retrieval_data
        if src == "fewshot+retrieved":
            return ([self.fewshot_file, self.retrieval_split],
                    [self.dataset_dir, self.retrieved_dir])
        if src == "dataset-cls":
            return (["dataset_train.txt"], [""])
        raise NotImplementedError(f"data_source {src}")

    @property
    def num_classes(self) -> int:
        if self.method == "dataset-cls":
            return 2
        if self.dataset not in NUM_CLASSES_DICT:
            # Custom dataset: the reference requires editing its hard-coded
            # NUM_CLASSES_DICT (utils/datasets/dataset_utils.py:13-24); here
            # an unregistered dataset infers its class count from the
            # metrics JSON (required for prompt building anyway) or, absent
            # that, from split-file labels.  Cached per (name, dataset_dir)
            # so a second RunConfig reusing the NAME with a different
            # dataset_path cannot inherit the first inference.
            key = (self.dataset, self.dataset_dir)
            if key not in _INFERRED_NUM_CLASSES:
                _INFERRED_NUM_CLASSES[key] = self._infer_num_classes()
            return _INFERRED_NUM_CLASSES[key]
        return NUM_CLASSES_DICT[self.dataset]

    def _infer_num_classes(self) -> int:
        if os.path.exists(self.metrics_file):
            import json
            with open(self.metrics_file) as f:
                return len(json.load(f))
        # union labels over EVERY available split file: rare classes can
        # be absent from test.txt (e.g. retrieved-only classes), and a
        # max()-over-one-file inference would silently build a too-small
        # classifier head
        labels: set = set()
        found = []
        for d in {self.dataset_dir, self.retrieved_dir}:
            if not os.path.isdir(d):
                continue
            for fn in os.listdir(d):
                if not fn.endswith(".txt"):
                    continue
                path = os.path.join(d, fn)
                try:
                    with open(path) as f:
                        labels.update(int(ln.split()[1]) for ln in f
                                      if ln.strip())
                    found.append(fn)
                except (ValueError, IndexError, OSError):
                    continue   # not a split file
        if labels:
            n = max(labels) + 1
            print(f"Inferred num_classes={n} for unregistered dataset "
                  f"{self.dataset!r} from splits {sorted(found)}")
            return n
        raise KeyError(
            f"dataset {self.dataset!r} is not registered and neither "
            f"{self.metrics_file} nor any split .txt under "
            f"{self.dataset_dir} exists to infer its class count")

    @property
    def dataset_root(self) -> str:
        # split files live next to the dataset (reference keeps them under
        # data/{dataset}, utils/parser.py:213)
        return self.dataset_dir

    @property
    def case_name(self) -> str:
        pre = f"{self.prefix}_" if self.prefix else ""
        return (f"{pre}{self.dataset}_{self.method}_{self.data_source}_"
                f"{self.cls_init}_{self.shots}shots_seed{self.seed}_"
                f"{self.epochs}eps")

    @property
    def output_dir(self) -> str:
        return os.path.join(f"{self.folder}/output_{self.dataset}",
                            self.case_name)

    @property
    def metrics_file(self) -> str:
        return os.path.join(self.dataset_dir,
                            f"{self.dataset}_metrics-{self.database.upper()}.json")

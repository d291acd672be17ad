"""Configuration for models and training.

A copy of ``meme_challenge_tpu/core/config.py``: every field keeps its name
and default, so ``configs/*.json``, the CLI flags and the checkpoints'
config records read unchanged. The port accepts these fields and reads none
of them: ``scan_unroll``; ``dispatch_unroll``, ``compute_dtype``,
``preload_features``, ``num_workers``, ``conf_th``, ``min_bb``, ``num_bb``,
``fc_dim`` and ``dropout`` of ``TrainConfig``. ``steps_per_dispatch`` only
groups uploads (``train/steps.upload_steps``), and ``remat`` /
``remat_policy`` checkpoint each encoder layer where autograd records it
(``torch.utils.checkpoint``; no effect in inference). ``mesh_shape`` /
``mesh_axes`` lay the folds, data and model over the process group
(``parallel/``).

TPU-first redesign of the reference's three-tier config system
(argparse in train_template.py:424-506, JSON model configs via
model/model.py:97-102, YACS YAML for the detector): here a pair of frozen
dataclasses covers model + training, JSON-round-trippable, hashable enough to
be closed over by jit.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class UniterConfig:
    """UNITER encoder hyper-parameters.

    Parity: reference model/model.py:24-114 (UniterConfig) and
    config/uniter-{base,large}.json. Same field names as the JSON files so
    ``from_json_file`` reads them unmodified.
    """

    vocab_size: int = 28996
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    # --- TPU-native additions (not in the reference JSON) ---
    img_dim: int = 2048            # region feature dim (utils/const.py IMG_DIM)
    pos_dim: int = 7               # 7-d bbox encoding
    layer_norm_eps: float = 1e-12  # apex FusedLayerNorm eps in every block
    dtype: str = "float32"         # the encoder's compute dtype
                                   # ("bfloat16": --compute_bf16)
    remat: bool = False            # recompute each encoder layer in the
                                   # backward (torch.utils.checkpoint)
    scan_unroll: int = 0           # accepted; no effect in the port
    remat_policy: str = "full"     # "full" recomputes the whole layer;
                                   # "dots" keeps the matrix products'
                                   # outputs and recomputes the rest
    use_pallas_attention: bool = False  # fused Pallas attention kernel (ops/attention.py)
    pallas_blocked: bool = False   # pair-blocked grid variant of the kernel
                                   # (up to 24 (b,h) pairs per step instead
                                   # of one sample — see ops/attention.py
                                   # _largest_block; per-block dropout
                                   # streams)
    attention_score_dtype: str = "float32"  # storage dtype of the S^2
                                   # scores and probabilities on the plain
                                   # (unfused) attention path: "bfloat16"
                                   # stores them in bf16, softmax math in
                                   # fp32 (the fused kernels ignore it)
    dropout_bits_dtype: str = "uint32"  # word width of the encoder's
                                   # threshold dropout draws (the hidden
                                   # states', and the plain path's attention
                                   # probabilities'): "uint8" quantizes the
                                   # keep threshold to 1/256 (rate 0.1 ->
                                   # 26/256; the inverse scale uses the
                                   # effective rate)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def from_json_file(cls, json_file: str) -> "UniterConfig":
        with open(json_file, "r", encoding="utf-8") as f:
            raw = json.load(f)
        return cls.from_dict(raw)

    @classmethod
    def from_dict(cls, raw: dict) -> "UniterConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in known})

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json_string(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True) + "\n"

    def replace(self, **kw) -> "UniterConfig":
        return dataclasses.replace(self, **kw)


UNITER_BASE = UniterConfig()
UNITER_LARGE = UniterConfig(
    hidden_size=1024, num_hidden_layers=24, num_attention_heads=16,
    intermediate_size=4096,
)


@dataclass(frozen=True)
class TrainConfig:
    """Training hyper-parameters.

    Parity: the argparse surface of reference train_template.py:424-506 plus
    the UNITER-specific flags of train_uniter.py:92-116. Defaults follow the
    reference defaults; the README reproduction recipe (README.md:58-62) is
    ``TrainConfig(lr=3e-5, warmup_steps=500, batch_size=16,
    gradient_accumulation=2, confounder_repeat=3, pos_wt=1.8, num_folds=-1,
    crossval_dev_size=200, crossval_use_dev=True, seed=43, max_epoch=30,
    patience=5)``.
    """

    # Paths
    data_path: str = "./dataset"
    feature_path: str = "./dataset/img_feats"
    model_path: str = "./model_checkpoints"
    vis_path: str = ""   # scalar-log dir ("" = off; reference default
                         # ./vis_checkpoints — pass it to enable TB logs)
    model_save_name: str = "best_model"
    config: str = ""                    # JSON model-config path (optional)
    pretrained_model_file: Optional[str] = None
    no_model_checkpoints: bool = False
    remove_checkpoints: bool = False
    debug: bool = False

    # Optimization
    optimizer: str = "adam"             # adam / adamax / adamw / sgd
    loss_func: str = "bce_logits"       # bce / bce_logits / ce
    optimize_for: str = "aucroc"        # loss / F1 / aucroc / accuracy
    scheduler: str = "warmup_cosine"    # step / multi_step / warmup / warmup_cosine
    lr: float = 1e-4
    beta1: float = 0.9
    beta2: float = 0.999
    adam_mu_dtype: str = "bfloat16"     # Adam first-moment storage
                                        # (moment math in fp32, optim.py);
                                        # "float32" for fp32 moments
    adam_nu_dtype: str = "bfloat16"     # Adam second-moment storage, the
                                        # same; bf16 halves the moments'
                                        # memory
    weight_decay: float = 1e-3
    max_grad_norm: float = 5.0
    gradient_accumulation: int = 1
    warmup_steps: int = 50
    lr_decay_step: int = 3
    lr_decay_factor: float = 0.8
    pos_wt: float = 1.0
    batch_size: int = 8
    max_epoch: int = 20
    patience: int = 5
    early_stop_thresh: float = 1e-3
    seed: int = 42
    log_every: int = 2000
    num_workers: int = 0

    # Data / sampling
    device_resident_data: bool = False  # upload whole datasets to the
                                        # device once and gather each
                                        # micro-batch there from indices
                                        # (steps.gather_micro); equal to
                                        # host batches
    steps_per_dispatch: int = 0         # optimizer steps that share one
                                        # upload (steps.upload_steps); the
                                        # steps run one by one, equal to
                                        # single steps. 0 = auto: 8 with
                                        # index batches, 1 with host batches
                                        # (steps.steps_per_upload)
    dispatch_unroll: int = 1            # accepted; no effect in the port
    fuse_accum: bool = False            # one forward and backward over the
                                        # flattened [accum·B] batch instead
                                        # of one a micro-batch
                                        # (steps.accumulate); the loss stays
                                        # the mean of the per-micro masked
                                        # means, the dropout draws differ;
                                        # accum× the activation memory
    confounder_repeat: int = 1
    object_conf_thresh: float = 0.0
    num_folds: int = 0                  # 0 = default split, -1 = all folds
    crossval_dev_size: int = 300
    crossval_use_dev: bool = False

    # UNITER preprocessing (train_uniter.py:98-116)
    max_txt_len: int = 60
    conf_th: float = 0.2
    max_bb: int = 100
    min_bb: int = 10
    num_bb: int = 36
    fc_dim: int = 64
    dropout: float = 0.2

    # --- TPU-native additions ---
    mesh_shape: Tuple[int, ...] = ()    # () = single chip; e.g. (4, 2) fold x data
    mesh_axes: Tuple[str, ...] = ("fold", "data")
    compute_dtype: str = "float32"      # accepted; no effect in the port
                                        # (UniterConfig.dtype is read)
    preload_features: bool = True       # accepted; no effect in the port

    @property
    def n_classes(self) -> int:
        # reference train_template.py:513: 2 for CE, 1 for BCE heads
        return 2 if self.loss_func == "ce" else 1

    @classmethod
    def from_json_file(cls, json_file: str) -> "TrainConfig":
        with open(json_file, "r", encoding="utf-8") as f:
            raw = json.load(f)
        return cls.from_dict(raw)

    @classmethod
    def from_dict(cls, raw: dict) -> "TrainConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in raw.items() if k in known}
        for tup_key in ("mesh_shape", "mesh_axes"):
            if tup_key in kw and isinstance(kw[tup_key], list):
                kw[tup_key] = tuple(kw[tup_key])
        return cls(**kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)

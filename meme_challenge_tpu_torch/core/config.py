"""Configuration for models and training.

A copy of ``meme_challenge_tpu/core/config.py``: every field keeps its name
and default, so ``configs/*.json`` and the CLI flags read unchanged. Fields
that only steer the JAX compiler (``scan_unroll``, ``mesh_*``,
``dispatch_unroll``, ...) are accepted and have no effect in the port;
``steps_per_dispatch`` groups steps into a plain loop, and ``remat`` /
``remat_policy`` checkpoint each encoder layer where autograd records it
(``torch.utils.checkpoint``; no effect in inference).

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
    dtype: str = "float32"         # compute dtype under jit ("bfloat16" for speed)
    remat: bool = False            # jax.checkpoint each encoder layer
    scan_unroll: int = 0           # lax.scan unroll over layers; 0 = auto
                                   # (full unroll on TPU — XLA fuses across
                                   # layers, +30% step throughput measured —
                                   # rolled elsewhere for compile speed)
    remat_policy: str = "full"     # "full" | "dots" (save matmul outputs,
                                   # recompute elementwise — cheap remat)
    use_pallas_attention: bool = False  # fused Pallas attention kernel (ops/attention.py)
    pallas_blocked: bool = False   # pair-blocked grid variant of the kernel
                                   # (up to 24 (b,h) pairs per step instead
                                   # of one sample — see ops/attention.py
                                   # _largest_block; per-block dropout
                                   # streams)
    attention_score_dtype: str = "float32"  # storage dtype of the S^2 score/
                                   # prob tensors on the XLA attention path.
                                   # "bfloat16" halves the dominant HBM
                                   # traffic of the step (softmax math stays
                                   # fp32 inside the fusion; custom VJP keeps
                                   # the saved residual bf16 too)
    dropout_bits_dtype: str = "uint32"  # PRNG word width for dropout masks.
                                   # "uint8" quarters mask-tensor traffic;
                                   # the keep-threshold quantizes to 1/256
                                   # (rate 0.1 -> 26/256; the inverse scale
                                   # uses the exact effective rate)

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
    adam_mu_dtype: str = "bfloat16"     # Adam first-moment storage: bf16
                                        # halves the largest optimizer-state
                                        # HBM stream (+2% step, measured);
                                        # "float32" for bitwise fp32 moments
    adam_nu_dtype: str = "bfloat16"     # Adam second-moment storage (moment
                                        # math stays fp32, optim.py). bf16
                                        # measured NEUTRAL in r2b but +2.5%
                                        # after the QKV pre-concat (981.7 →
                                        # 1006.6 memes/s same-window, r3) —
                                        # also halves nu state memory.
                                        # "float32" for bitwise fp32 moments
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
    device_resident_data: bool = False  # preload whole datasets to HBM and
                                        # gather micro-batches on device
                                        # (index-bytes per step instead of
                                        # feature-megabytes; pointwise-equal
                                        # to host batches — test_train)
    steps_per_dispatch: int = 0         # optimizer steps per jitted dispatch
                                        # (lax.scan chunk). 0 = auto: 8 with
                                        # device-resident index batches
                                        # (chunk upload is KBs), 1 for host
                                        # batches (a chunk would stack K×
                                        # accum feature-MBs). Pointwise-
                                        # equal to unchunked — test_train
    dispatch_unroll: int = 1            # unroll of the chunk's scan over
                                        # optimizer steps: >1 lets XLA
                                        # overlap step k's optimizer tail
                                        # with step k+1's first forward
                                        # (same ops/order — numerics equal)
    fuse_accum: bool = False            # compute the accumulated gradient
                                        # as ONE fused fwd/bwd over the
                                        # flattened [accum·B] batch instead
                                        # of a scan of micro backwards.
                                        # Loss stays the mean of per-micro
                                        # masked means (exact accumulation
                                        # semantics); only the dropout
                                        # stream differs. +30% on
                                        # UNITER-base b16×a2 (BASELINE r4);
                                        # costs accum× activation memory
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
    compute_dtype: str = "float32"      # "bfloat16" for MXU speed
    preload_features: bool = True       # dense host arrays instead of per-item np.load

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

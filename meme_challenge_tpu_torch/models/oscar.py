"""Oscar model variant in PyTorch: BERT with image region features appended.

Counterpart of ``meme_challenge_tpu/models/oscar.py`` (reference
model/oscar.py: BertImgModel :145-273, ImageBertForSequenceClassification
:284-328, in its meme configuration config/oscar-base.json): text
embeddings, then a linear projection of the 2054-d region features (2048
visual + 6 geometry) in fp32, the optional image LayerNorm with its own eps,
dropout, appended after the text; one BERT encoder over the joint sequence
with the additive −10000 key mask; pooler → dropout → linear or MLP
classifier.

The encoder is the port's ``StackedEncoder``: with ``use_pallas_attention``
every layer runs the fused-attention kernels (``pallas_blocked``: the
pair-blocked seed mode), exactly as ``MemeUniter`` does.

Parameters keep the reference's key layout under ``bert.`` (``embeddings.*``,
``img_embedding``, ``LayerNorm`` for the image LayerNorm, ``encoder.layer.*``,
``pooler.dense``) and ``classifier`` (a Linear, or ``classifier.0`` /
``classifier.2`` of the MLP), so a reference checkpoint loads with
``models.convert.oscar_state_from_torch``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from meme_challenge_tpu_torch.core.config import UniterConfig
from meme_challenge_tpu_torch.core.constants import IMG_DIM_OSCAR
from meme_challenge_tpu_torch.models.uniter import (
    NEG_INF,
    LayerNorm,
    Pooler,
    StackedEncoder,
    TextEmbeddings,
    bernoulli_dropout,
    compute_dtype,
    init_weights,
)


class OscarModel(nn.Module):
    """BertImgModel: text ⊕ projected image features → encoder → pooler."""

    def __init__(self, config: UniterConfig,
                 img_feature_dim: int = IMG_DIM_OSCAR,
                 use_img_layernorm: bool = False,
                 img_layer_norm_eps: Optional[float] = None):
        super().__init__()
        self.config = config
        self.img_feature_dim = img_feature_dim
        H = config.hidden_size
        self.embeddings = TextEmbeddings(config)
        self.img_embedding = nn.Linear(img_feature_dim, H)
        # the reference gives the image LayerNorm its own eps
        # (config.img_layer_norm_eps, oscar.py:177); None → layer_norm_eps
        self.LayerNorm = (LayerNorm(H, img_layer_norm_eps
                                    if img_layer_norm_eps is not None
                                    else config.layer_norm_eps)
                          if use_img_layernorm else None)
        self.encoder = StackedEncoder(config)
        self.pooler = Pooler(config)

    def forward(self, input_ids: torch.Tensor, txt_mask: torch.Tensor,
                img_feat: Optional[torch.Tensor] = None,
                img_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        cfg = self.config
        gen = None if deterministic else generator
        position_ids = torch.arange(
            input_ids.shape[1], device=input_ids.device).expand_as(input_ids)
        emb = self.embeddings(input_ids, position_ids, token_type_ids, gen)
        joint_mask = txt_mask
        if img_feat is not None:
            img_emb = self.img_embedding(img_feat.float())
            if self.LayerNorm is not None:
                img_emb = self.LayerNorm(img_emb, torch.float32)
            img_emb = bernoulli_dropout(img_emb, cfg.hidden_dropout_prob, gen)
            emb = torch.cat([emb.float(), img_emb], dim=1)
            joint_mask = torch.cat([txt_mask, img_mask], dim=1)
        bias = ((1.0 - joint_mask.float()) * NEG_INF)[:, None, None, :]
        seq = self.encoder(emb.to(compute_dtype(cfg)), bias,
                           deterministic=deterministic, generator=gen)
        return seq, self.pooler(seq)


class ImageBertForSequenceClassification(nn.Module):
    """Oscar classifier head (reference oscar.py:284-328)."""

    def __init__(self, config: UniterConfig, num_labels: int = 2,
                 classifier: str = "linear", cls_hidden_scale: int = 2,
                 img_feature_dim: int = IMG_DIM_OSCAR,
                 use_img_layernorm: bool = False,
                 img_layer_norm_eps: Optional[float] = None):
        super().__init__()
        if classifier not in ("linear", "mlp"):
            raise ValueError("classifier must be linear or mlp, got %r"
                             % classifier)
        self.config = config
        self.img_feature_dim = img_feature_dim
        H = config.hidden_size
        self.bert = OscarModel(config, img_feature_dim, use_img_layernorm,
                               img_layer_norm_eps)
        if classifier == "mlp":
            self.classifier = nn.Sequential(
                nn.Linear(H, H * cls_hidden_scale), nn.ReLU(),
                nn.Linear(H * cls_hidden_scale, num_labels))
        else:
            self.classifier = nn.Linear(H, num_labels)

    def forward(self, batch: Dict[str, torch.Tensor],
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        img_feat = batch.get("img_feat")
        if (img_feat is not None and "img_pos_feat" in batch
                and img_feat.shape[-1] == self.img_feature_dim - 6):
            # the raw (2048-d features, 7-d geometry) pair of the
            # device-resident gather (steps.gather_micro): the 2054-d
            # features are assembled here; host batches arrive assembled
            # by train_oscar.OscarBatchLoader
            img_feat = oscar_batch_features(img_feat, batch["img_pos_feat"])
        _, pooled = self.bert(
            batch["input_ids"], batch["txt_mask"], img_feat=img_feat,
            img_mask=batch.get("img_mask"),
            token_type_ids=batch.get("token_type_ids"),
            deterministic=deterministic, generator=generator)
        x = bernoulli_dropout(pooled, self.config.hidden_dropout_prob,
                              None if deterministic else generator)
        return self.classifier(x)


def oscar_batch_features(img_feat: torch.Tensor, img_pos_feat: torch.Tensor
                         ) -> torch.Tensor:
    """2048-d visual features ⊕ 6-d geometry → 2054-d Oscar features (fp32).

    The feature files carry the 7-d encoding (x1, y1, x2, y2, w, h, w·h);
    Oscar's 2054 = 2048 + 6 drops the area term (config/oscar-base.json
    img_feature_dim)."""
    return torch.cat([img_feat.float(), img_pos_feat[..., :6].float()],
                     dim=-1)


def init_oscar_model(config: UniterConfig, num_labels: int, device,
                     generator: torch.Generator, classifier: str = "linear",
                     img_feature_dim: Optional[int] = None
                     ) -> ImageBertForSequenceClassification:
    """An ImageBertForSequenceClassification on ``device`` with JAX's
    initializers (normal(initializer_range) for every matrix and table,
    zeros for biases, ones for LayerNorm scales) drawn from ``generator``;
    ``img_feature_dim`` defaults to ``config.img_dim``."""
    with torch.device("meta"):
        model = ImageBertForSequenceClassification(
            config, num_labels=num_labels, classifier=classifier,
            img_feature_dim=(config.img_dim if img_feature_dim is None
                             else img_feature_dim))
    model = model.to_empty(device=torch.device(device))
    init_weights(model, generator, config.initializer_range)
    return model.eval()

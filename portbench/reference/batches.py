"""The reference's own inputs: a batch of memes built from the traffic's
token ids and the raw feature files, in the recipe's static layout, with no
code of the program."""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from portbench.traffic.memes import (
    CLS_ID,
    IMG_DIM,
    PAD_ID,
    SEP_ID,
    Corpus,
    load_region_features,
)


def build(corpus: Corpus, meme_ids: Sequence[int], max_txt_len: int,
          max_bb: int, device) -> Dict[str, torch.Tensor]:
    """``input_ids``, ``position_ids``, ``txt_mask`` ``[n, max_txt_len]``,
    ``img_feat`` ``[n, max_bb, 2048]`` (float32 of the stored values),
    ``img_pos_feat`` ``[n, max_bb, 7]``, ``img_mask`` ``[n, max_bb]`` and
    ``labels`` ``[n]`` of the memes ``meme_ids``, in that order."""
    where = corpus.index()
    n = len(meme_ids)
    ids = np.full((n, max_txt_len), PAD_ID, np.int64)
    txt_mask = np.zeros((n, max_txt_len), np.int64)
    feat = np.zeros((n, max_bb, IMG_DIM), np.float32)
    pos = np.zeros((n, max_bb, 7), np.float32)
    img_mask = np.zeros((n, max_bb), np.int64)
    labels = np.zeros(n, np.int64)
    for row, mid in enumerate(meme_ids):
        i = where[int(mid)]
        toks = [CLS_ID] + [int(t) for t in
                           corpus.words[i][:max_txt_len - 2]] + [SEP_ID]
        ids[row, :len(toks)] = toks
        txt_mask[row, :len(toks)] = 1
        f, p = load_region_features(corpus, int(mid))
        nbb = min(len(f), max_bb)
        feat[row, :nbb] = f[:nbb]
        pos[row, :nbb] = p[:nbb]
        img_mask[row, :nbb] = 1
        labels[row] = corpus.labels[i]
    position_ids = np.tile(np.arange(max_txt_len), (n, 1))
    out = {"input_ids": ids, "position_ids": position_ids,
           "txt_mask": txt_mask, "img_feat": feat, "img_pos_feat": pos,
           "img_mask": img_mask, "labels": labels}
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}

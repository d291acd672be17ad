"""The traffic generator: the same seed writes the same bytes, another seed
other bytes, and the program reads back the texts and regions it meant."""
import hashlib
import json
import os

import numpy as np
import pytest

from portbench.traffic import memes

MIX = {"memes": 60, "text_tokens": {"median": 20, "sigma": 0.5, "min": 4,
                                    "max": 60},
       "regions": {"min": 10, "max": 100}, "hateful_share": 0.35,
       "confounder_share": 0.2, "feature_dtype": "float16"}


def _digest(root):
    h = hashlib.sha256()
    for dirpath, dirs, files in os.walk(root):
        dirs.sort()
        for f in sorted(files):
            with open(os.path.join(dirpath, f), "rb") as fh:
                h.update(f.encode() + fh.read())
    return h.hexdigest()


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    out = {}
    for name, seed in (("a", 2 ** 31 + 5), ("b", 2 ** 31 + 5), ("c", 7)):
        root = str(tmp_path_factory.mktemp(name))
        out[name] = memes.generate(MIX, seed, root, vocab_size=500)
    return out


def test_same_seed_same_bytes(corpora):
    assert _digest(corpora["a"].root) == _digest(corpora["b"].root)
    assert _digest(corpora["a"].root) != _digest(corpora["c"].root)


def test_shape_of_the_split(corpora):
    c = corpora["a"]
    assert len(c.ids) == 60 and len(set(c.ids.tolist())) == 60
    assert c.n_confounders == 12
    lengths = np.array([len(w) + 2 for w in c.words])
    assert lengths.min() >= 4 and lengths.max() <= 60
    assert c.n_regions.min() >= 10 and c.n_regions.max() <= 100
    assert abs(c.labels.mean() - 0.35) < 0.2
    with open(c.split) as f:
        recs = [json.loads(line) for line in f]
    by_text = {}
    for r in recs:
        by_text.setdefault(r["text"], []).append(r["label"])
    pairs = [ls for ls in by_text.values() if len(ls) == 2]
    assert len(pairs) == 6 and all(sorted(ls) == [0, 1] for ls in pairs)


def test_program_reads_what_was_meant(corpora):
    from meme_challenge_tpu_torch.data.meme_dataset import MemeDataset
    from meme_challenge_tpu_torch.data.tokenizer import BertTokenizer

    c = corpora["a"]
    ds = MemeDataset(c.split, feature_dir=c.feature_dir,
                     tokenizer=BertTokenizer(c.vocab), max_txt_len=60,
                     max_bb=100, img_dim=memes.IMG_DIM)
    for i in range(len(c.ids)):
        want = [memes.CLS_ID] + c.words[i].tolist() + [memes.SEP_ID]
        assert ds.input_ids[i, :len(want)].tolist() == want
        assert ds.txt_mask[i].sum() == len(want)
        feats, pos = memes.load_region_features(c, int(c.ids[i]))
        n = c.n_regions[i]
        assert ds.num_bb[i] == n and (feats >= 0).all()
        np.testing.assert_array_equal(ds.img_feat[i, :n], feats)
        np.testing.assert_allclose(ds.img_pos_feat[i, :n], pos, rtol=1e-6)

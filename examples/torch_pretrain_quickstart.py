"""Pretraining quickstart of the PyTorch port: MLM + ITM(+IPOT) + MRFR + MRC
on synthetic data.

    python examples/torch_pretrain_quickstart.py /tmp/torch_pretrain_qs
    python examples/torch_pretrain_quickstart.py /tmp/torch_pretrain_qs --device cpu

On the CPU it takes well under a minute.

1. generates a synthetic meme corpus (train + dev merged, reference
   pretrain_meme_dataset.py semantics),
2. builds the four task streams behind a MetaLoader (task held fixed per
   gradient-accumulation group),
3. pretrains a tiny UNITER with the multi-task driver (ITM adds the IPOT
   optimal-transport alignment term), printing per-task losses,
4. hands the pretrained trunk to a MemeUniter classifier and checks that
   its logits are finite — the handoff the reference README describes
   (pretrain, then ``train_uniter --pretrained_model_file ...``).

Swap the tiny config for ``configs/uniter-base.json`` and the synthetic
corpus for real conceptual-caption-style features to reproduce a full run
(``python -m meme_challenge_tpu_torch.train.pretrain_uniter``).
"""
import argparse
import os
import random
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from meme_challenge_tpu_torch.core.config import TrainConfig, UniterConfig
from meme_challenge_tpu_torch.core.device import resolve_device
from meme_challenge_tpu_torch.core.seeding import set_seed, torch_generator
from meme_challenge_tpu_torch.data.pretrain import (
    ITMBatcher, MLMBatcher, MRCBatcher, MRFRBatcher, MetaLoader, TaskLoader,
    pretrain_corpus)
from meme_challenge_tpu_torch.data.tokenizer import BertTokenizer
from meme_challenge_tpu_torch.models.uniter import init_meme_uniter
from meme_challenge_tpu_torch.train.pretrain_driver import PretrainTrainer
from meme_challenge_tpu_torch.train.pretrain_init import init_pretrain_model
from meme_challenge_tpu_torch.train.steps import to_device
from meme_challenge_tpu_torch.utils.synthetic import make_synthetic_dataset


def main(out_dir: str, device: str = "cuda") -> dict:
    device = resolve_device(device)
    set_seed(43)
    random.seed(43)

    print("== 1. synthetic corpus")
    synth = make_synthetic_dataset(os.path.join(out_dir, "data"),
                                   n_train=32, n_dev=8, img_dim=32,
                                   label_signal=3.0)
    tok = BertTokenizer(synth["vocab"])
    ds = pretrain_corpus(synth["root"], synth["feature_dir"], tok,
                         max_txt_len=12, max_bb=10, img_dim=32)
    print(f"   corpus size: {len(ds)} (train+dev merged)")

    print("== 2. task streams (MetaLoader, task fixed per accum group)")
    B = 8
    loaders = {
        "mlm": TaskLoader("mlm", ds, B, MLMBatcher(ds, tok)),
        "itm": TaskLoader("itm", ds, B, ITMBatcher(ds), needs_indices=True),
        "mrfr": TaskLoader("mrfr", ds, B, MRFRBatcher(ds)),
        "mrc": TaskLoader("mrc", ds, B, MRCBatcher(ds), needs_indices=True),
    }
    meta = MetaLoader(loaders, accum_steps=2)

    print("== 3. multi-task pretraining (ITM + IPOT alignment)")
    ucfg = UniterConfig(vocab_size=tok.vocab_size, hidden_size=32,
                        num_hidden_layers=2, num_attention_heads=2,
                        intermediate_size=64, img_dim=32,
                        max_position_embeddings=32)
    model = init_pretrain_model(ucfg, img_label_dim=1601, device=device,
                                generator=torch_generator(0, device))
    example = next(iter(loaders["mlm"]))
    tcfg = TrainConfig(model_path=os.path.join(out_dir, "ck"),
                       model_save_name="pretrained.ckpt", lr=3e-3,
                       batch_size=B, gradient_accumulation=2, max_epoch=2,
                       warmup_steps=2, scheduler="warmup_cosine", seed=43)
    os.makedirs(tcfg.model_path, exist_ok=True)
    trainer = PretrainTrainer(tcfg, model, meta, steps_per_epoch=8,
                              ot_weight=0.1)
    losses = trainer.train()
    for task, loss in sorted(losses.items()):
        print(f"   {task:5s} final-epoch loss: {loss:.4f}")

    print("== 4. fine-tune handoff (pretrained trunk -> MemeUniter)")
    clf = init_meme_uniter(ucfg, 1, device, torch_generator(1, device))
    # the pretraining trunk and the classifier's are the same UniterModel
    clf.uniter_model.load_state_dict(trainer.model.uniter.state_dict())
    with torch.no_grad():
        logits = clf(to_device(example, device)).float()
    finite = bool(torch.isfinite(logits).all())
    print(f"   classifier logits from pretrained trunk: "
          f"shape={tuple(logits.shape)}, finite={finite}")
    print(f"== done; checkpoints in {tcfg.model_path}")
    return {"losses": losses, "logits": logits.cpu()}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("out_dir", nargs="?",
                        default="/tmp/torch_pretrain_quickstart")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    args = parser.parse_args()
    main(args.out_dir, args.device)

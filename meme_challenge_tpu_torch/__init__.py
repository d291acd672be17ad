"""meme_challenge_tpu_torch — the PyTorch and CUDA port of meme_challenge_tpu,
for one NVIDIA H100.

The JAX package stays beside it as the reference; this package imports
nothing of it, nor JAX. Subpackages mirror the JAX package's names:

- ``core``    config dataclasses, metrics, seeding, artifact IO, device choice.
- ``data``    WordPiece tokenizer, static-shape MemeDataset + BatchLoader,
              the crossval fold splits, the pretraining batchers, the
              Twitter hate-speech and object-text datasets.
- ``ops``     hand-written CUDA kernels for Hopper (fused attention forward
              and backward), each with its plain PyTorch version, and their
              build; the batched AUROC and fold mixing of the ensemble
              search (plain torch).
- ``models``  UNITER (``nn.Module``s in the reference's torch key layout),
              the text-only ``MODEL_DICT`` backbones, Oscar, and the
              checkpoint converters.
- ``train``   losses, schedules, the optimizer, train and eval steps,
              checkpoints, scalar logs, the trainer, the crossval driver and
              the CLIs: ``train_uniter``, ``pretrain_uniter``,
              ``train_pure_text``, ``train_hatespeech``,
              ``train_object_text``, ``train_oscar``.
- ``ensemble``  the ensemble weight search over per-fold CSVs.
- ``utils``   synthetic dataset fixtures.

It runs the reference's README recipe for UNITER-base (fold splits, a
fine-tune per fold, the ensemble search), serves a checkpoint, pretrains
UNITER, and trains the text-only baselines and Oscar; feature extraction
and multi-device runs follow the queue in ROADMAP.md.
"""

__version__ = "0.1.0"

"""meme_challenge_tpu_torch — the PyTorch and CUDA port of meme_challenge_tpu,
for one NVIDIA H100.

The JAX package stays beside it as the reference; this package imports
nothing of it, nor JAX. Subpackages mirror the JAX package's names:

- ``core``    config dataclasses, metrics, seeding, artifact IO, device choice.
- ``data``    WordPiece tokenizer, static-shape MemeDataset + BatchLoader,
              the crossval fold splits.
- ``ops``     hand-written CUDA kernels for Hopper (fused attention forward
              and backward), each with its plain PyTorch version, and their
              build; the batched AUROC and fold mixing of the ensemble
              search (plain torch).
- ``models``  UNITER (``nn.Module``s in the reference's torch key layout) and
              the checkpoint converters.
- ``train``   losses, schedules, the optimizer, train and eval steps,
              checkpoints, scalar logs, the trainer, the crossval driver and
              the ``train_uniter`` CLI.
- ``ensemble``  the ensemble weight search over per-fold CSVs.
- ``utils``   synthetic dataset fixtures.

It runs the reference's README recipe for UNITER-base (fold splits, a
fine-tune per fold, the ensemble search) and serves a checkpoint; the other
models follow the queue in ROADMAP.md.
"""

__version__ = "0.1.0"

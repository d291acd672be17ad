"""meme_challenge_tpu_torch — the PyTorch and CUDA port of meme_challenge_tpu,
for one NVIDIA H100.

The JAX package stays beside it as the reference; this package imports
nothing of it, nor JAX. Subpackages mirror the JAX package's names:

- ``core``    config dataclasses, metrics, seeding, artifact IO, device choice.
- ``data``    WordPiece tokenizer, static-shape MemeDataset + BatchLoader.
- ``ops``     hand-written CUDA kernels for Hopper (fused attention forward
              and backward), each with its plain PyTorch version, and their
              build.
- ``models``  UNITER (``nn.Module``s in the reference's torch key layout) and
              the checkpoint converters.
- ``train``   losses, schedules, the optimizer, train and eval steps,
              checkpoints, scalar logs, the trainer, the crossval driver and
              the ``train_uniter`` CLI.
- ``utils``   synthetic dataset fixtures.

It fine-tunes and serves UNITER-base on the default split
(``--num_folds 0``); the fold loop, the ensemble and the other models follow
the queue in ROADMAP.md.
"""

__version__ = "0.1.0"

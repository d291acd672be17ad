"""Fold-parallel crossval: all folds of the recipe train as one
fold-stacked model (``fold_parallel.py``, ``crossval_parallel.py``), on one
card or over a ``torch.distributed`` mesh of fold, data and model axes
(``mesh.py``; ``torchrun``, and the dry run ``dryrun.py``)."""

"""Fold-parallel crossval on one card: all folds of the recipe train as one
fold-stacked model (``fold_parallel.py``, ``crossval_parallel.py``)."""

"""Ensemble weight search over the per-fold prediction CSVs."""

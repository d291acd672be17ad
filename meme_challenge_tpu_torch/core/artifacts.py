"""Prediction CSV / metrics JSON artifact IO.

A copy of ``meme_challenge_tpu/core/artifacts.py``.

The ``id,proba,label[,gt]`` CSV schema is the contract between the trainer
exports (reference train_template.py:208-217) and the ensemble layer parser
(reference utils/ensemble.py:115-127). Formats match the reference exactly:
``"%i,%f,%i[,%i]"`` rows so downstream CSVs are bitwise-comparable.
"""
from __future__ import annotations

import csv
import json
import os
from typing import Dict, List, Optional

import numpy as np


def export_predictions(
    filepath: str,
    ids: np.ndarray,
    probs: np.ndarray,
    preds: np.ndarray,
    labels: Optional[np.ndarray] = None,
) -> None:
    """Write an ``id,proba,label[,gt]`` CSV (reference train_template.py:208-217)."""
    lines = ["id,proba,label%s" % (",gt" if labels is not None else "")]
    for i in range(len(ids)):
        row = "%i,%f,%i" % (int(ids[i]), float(probs[i]), int(preds[i]))
        if labels is not None:
            row += ",%i" % int(labels[i])
        lines.append(row)
    os.makedirs(os.path.dirname(os.path.abspath(filepath)), exist_ok=True)
    with open(filepath, "w") as f:
        f.write("\n".join(lines) + "\n")


def load_predictions(csv_file: str) -> Dict[str, np.ndarray]:
    """Parse a prediction CSV into column arrays (reference ensemble.py:115-127).

    'proba' becomes float64, every other column int64.
    """
    with open(csv_file, "r", newline="") as f:
        rows = list(csv.reader(f, delimiter=","))
    header = rows[0]
    out: Dict[str, np.ndarray] = {}
    for col_idx, col in enumerate(header):
        vals = [r[col_idx] for r in rows[1:] if r]
        if col == "proba":
            out[col] = np.array([float(v) for v in vals], dtype=np.float64)
        else:
            out[col] = np.array([int(v) for v in vals], dtype=np.int64)
    return out


def export_metrics_json(filepath: str, metric_dict: dict) -> None:
    """Per-run metrics JSON (reference train_template.py:343-354)."""
    os.makedirs(os.path.dirname(os.path.abspath(filepath)), exist_ok=True)
    with open(filepath, "w") as f:
        json.dump(metric_dict, f, indent=4)


def export_jsonl(filepath: str, dict_list: List[dict]) -> None:
    """jsonl writer matching reference utils/crossval.py:126-129."""
    s = "\n".join(json.dumps(d) for d in dict_list)
    with open(filepath, "w") as f:
        f.write(s)


def load_jsonl(filepath: str) -> List[dict]:
    with open(filepath, "r") as f:
        return [json.loads(line) for line in f if line.strip()]

"""The numbers of the robustness analysis (``analysis/robustness.py``,
reference analyze_robustness.py) with numpy and the standard library only:
the mean metric per model and condition over an output tree
``<outputs>/<condition>/<dataset>/<sequence>/<method>/<metric>.txt``.
The plots stay with ``analysis/robustness.py`` (matplotlib, pandas), which
reads the port's output tree unchanged."""

import glob
import os
import re

import numpy as np

MODEL_ORDER = ["E2VID", "FireNet", "E2VID+", "FireNet+", "SPADE-E2VID",
               "SSL-E2VID", "ET-Net", "HyperE2VID"]


def order_models(models):
    rank = {m: i for i, m in enumerate(reversed(MODEL_ORDER))}
    return sorted(models, key=lambda m: rank.get(m, 99999))


def extract_numeric_value(s):
    match = re.search(r"\d+", s)
    if not match:
        raise ValueError(f"Cannot extract numeric value from {s}")
    return int(match.group())


def _read_rows(path):
    """(indices, values) of a metric file's ``<index> <value>`` rows; the
    indices may have gaps (a row per scored window only)."""
    indices, values = [], []
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.split(" ")
            indices.append(int(parts[0]))
            values.append(float(parts[-1]))
    return indices, values


def read_scores(directory, pattern="*", metric="lpips", skip_models=(),
                datasets=None):
    """{model: {condition: mean score over all frames/sequences}} of the
    conditions matching ``pattern`` under ``directory``; ``datasets``, when
    given, keeps only those datasets' sequences."""
    scores = {}
    for cond_path in sorted(glob.glob(os.path.join(directory, pattern))):
        condition = os.path.basename(cond_path)
        for model_path in glob.glob(os.path.join(cond_path, "*", "*", "*")):
            if not os.path.isdir(model_path):
                continue
            if datasets is not None:
                ds = os.path.basename(os.path.dirname(
                    os.path.dirname(model_path)))
                if ds not in datasets:
                    continue
            model = os.path.basename(model_path)
            if model in skip_models:
                continue
            scores.setdefault(model, {}).setdefault(condition, [])
            metric_path = os.path.join(model_path, metric + ".txt")
            if os.path.exists(metric_path):
                scores[model][condition].extend(_read_rows(metric_path)[1])
    means = {}
    for model, conds in scores.items():
        means[model] = {c: float(np.mean(v)) for c, v in conds.items() if v}
    return means

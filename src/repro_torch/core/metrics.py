"""Segmentation evaluation metrics (paper §4.2.1).

Counterpart of ``repro.core.metrics`` (host-side numpy); inputs may be
numpy arrays or tensors on any device.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch


def _flat(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x).astype(np.int64).ravel()


@dataclass
class SegMetrics:
    precision: float
    recall: float
    accuracy: float
    porosity: float
    porosity_true: float

    def as_dict(self) -> Dict[str, float]:
        return {
            "precision": self.precision,
            "recall": self.recall,
            "accuracy": self.accuracy,
            "porosity": self.porosity,
            "porosity_true": self.porosity_true,
        }


def evaluate(pred, truth) -> SegMetrics:
    """precision = TP/(TP+FP), recall = TP/(TP+FN), accuracy =
    (TP+TN)/all, porosity = V_void / V_total, for {0,1} label maps (1 =
    solid).  MRF label ids are arbitrary, so the labelling (as given or
    flipped) with the higher accuracy is scored."""
    pred = _flat(pred)
    truth = _flat(truth)

    def _metrics(p):
        tp = int(np.sum((p == 1) & (truth == 1)))
        tn = int(np.sum((p == 0) & (truth == 0)))
        fp = int(np.sum((p == 1) & (truth == 0)))
        fn = int(np.sum((p == 0) & (truth == 1)))
        precision = tp / max(tp + fp, 1)
        recall = tp / max(tp + fn, 1)
        accuracy = (tp + tn) / max(tp + tn + fp + fn, 1)
        return precision, recall, accuracy

    m_direct = _metrics(pred)
    m_flip = _metrics(1 - pred)
    pred_final = pred if m_direct[2] >= m_flip[2] else 1 - pred
    precision, recall, accuracy = max(m_direct, m_flip, key=lambda m: m[2])
    return SegMetrics(
        precision=float(precision),
        recall=float(recall),
        accuracy=float(accuracy),
        porosity=float(np.mean(pred_final == 0)),
        porosity_true=float(np.mean(truth == 0)),
    )


def multiclass_accuracy(pred, truth, n_labels: int) -> float:
    """Pixel accuracy for K-ary segmentation under the best label matching:
    exact (all K! permutations of the confusion matrix) for K <= 8, greedy
    on the largest confusion entries above that."""
    pred = _flat(pred)
    truth = _flat(truth)
    conf = np.zeros((n_labels, n_labels), np.int64)
    np.add.at(conf, (pred, truth), 1)
    total = max(len(pred), 1)
    if n_labels <= 8:
        best = max(
            sum(int(conf[p, perm[p]]) for p in range(n_labels))
            for perm in itertools.permutations(range(n_labels))
        )
        return best / total
    mapping = {}
    for _ in range(n_labels):
        flat = int(np.argmax(conf))
        p, t = divmod(flat, n_labels)
        if conf[p, t] < 0:
            break
        mapping[p] = t
        conf[p, :] = -1
        conf[:, t] = -1
    matched = np.array([mapping.get(p, -1) for p in range(n_labels)])
    return float(np.mean(matched[pred] == truth))

"""Eval metrics: AverageMeter, top-k accuracy and cross-entropy (the port's
copy of ``diffvit_tpu/utils/metrics.py``)."""
from __future__ import annotations

import numpy as np


class AverageMeter:
    """Computes and stores the average and current value."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


def accuracy(output, target, topk=(1,)):
    """precision@k in percent, as the reference's report computes it."""
    output = np.asarray(output)
    target = np.asarray(target)
    maxk = max(topk)
    pred = np.argsort(-output, axis=1)[:, :maxk]
    correct = pred == target[:, None]
    return [100.0 * correct[:, :k].any(axis=1).mean() for k in topk]


def cross_entropy(logits, labels):
    logits = np.asarray(logits, np.float64)
    logits = logits - logits.max(axis=1, keepdims=True)
    logp = logits - np.log(np.exp(logits).sum(axis=1, keepdims=True))
    return float(-logp[np.arange(len(labels)), labels].mean())

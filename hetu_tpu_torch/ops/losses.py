"""Loss ops (subset of ``hetu_tpu/ops/losses.py``).  Per-example losses
come back unreduced, shape (N,); the model applies the reduction."""
import torch

from .base import def_op


def _softmax_ce(c, logits, labels):
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.sum(labels * logp, dim=-1)


softmaxcrossentropy_op = def_op("SoftmaxCrossEntropy", _softmax_ce)


def _softmax_ce_sparse(c, logits, labels, ignored_index=-1):
    """Cross-entropy against integer labels; a label equal to
    ``ignored_index`` costs 0.  Labels are gathered at max(label, 0), as
    the JAX lowering does, so an ignored -1 never indexes out of range."""
    logp = torch.log_softmax(logits, dim=-1)
    lbl = labels.to(torch.int64)
    picked = torch.gather(logp, -1, lbl.clamp(min=0)[..., None])[..., 0]
    return torch.where(lbl == ignored_index, torch.zeros_like(picked),
                       -picked)


softmaxcrossentropy_sparse_op = def_op("SoftmaxCrossEntropySparse",
                                       _softmax_ce_sparse)


binarycrossentropy_op = def_op(
    "BinaryCrossEntropy",
    lambda c, pred, labels, eps=1e-12:
        -(labels * torch.log(pred + eps)
          + (1 - labels) * torch.log(1 - pred + eps)))

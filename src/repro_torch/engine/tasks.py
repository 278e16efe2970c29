"""Federated tasks, ported from ``repro.engine.tasks`` (``classification``
and ``lm``).

A ``Task`` owns everything workload-specific that the round protocol
needs: the per-example partition labels, the client histograms used for
clustering, the model initialisation and the ``(apply_fn, loss_fn,
metric_fn)`` triple with the contract
``loss_fn(apply_fn(params, x), y, weights)``.  ``params`` is the flat
(P,) vector or an (m, P) cohort; the losses and metrics reduce the last
batch axis (and for the LM task the sequence axis after it), keeping any
leading client axis.  A task may add held-out metrics through
``build_eval_extra`` (the LM task's perplexity).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data.partition import label_histograms
from repro_torch.engine.registry import TASK_REGISTRY, register_task
from repro_torch.models.mlp import MLPLayout, accuracy, cross_entropy_loss, mlp_apply
from repro_torch.models.transformer import (
    TransformerLayout,
    check_supported,
    chunked_logits_sum,
    forward,
    output_head,
    token_nll,
)

__all__ = ["Task", "ClassificationTask", "LMTask", "build_task"]


class Task:
    """Workload contract consumed by ``Engine``.  Subclasses register
    with ``@register_task("name")`` and take ``(cfg, **task_kwargs)``."""

    name = "base"

    def __init__(self, cfg: Any):
        self.cfg = cfg

    def partition_labels(self, train) -> np.ndarray:
        """(N,) integer labels the partitioner splits on."""
        raise NotImplementedError

    def partition_classes(self, n_classes: int) -> int:
        """Cardinality of the partition-label space (HD calibration)."""
        return n_classes

    def client_features(self, train, client_idx, n_classes: int) -> np.ndarray:
        """(K, D) row-normalized histograms used for client clustering."""
        raise NotImplementedError

    def init_params(self, draws, train, n_classes: int):
        raise NotImplementedError

    def layout(self, train, n_classes: int):
        """Where each parameter sits in the flat (P,) vector
        (``MLPLayout`` or ``TransformerLayout``)."""
        raise NotImplementedError

    def build_fns(self, train, n_classes: int) -> tuple[Callable, Callable, Callable]:
        """``(apply_fn, loss_fn, metric_fn)``."""
        raise NotImplementedError

    def build_eval_extra(self, test, n_classes: int) -> Callable | None:
        """``compute(params, test_x, test_y) -> dict`` of extra held-out
        metrics, or None when the task has none."""
        return None


@register_task("classification")
class ClassificationTask(Task):
    """The paper's workload: MLP over class-conditional image features,
    clients clustered by label histograms."""

    name = "classification"

    def _sizes(self, train, n_classes: int) -> tuple[int, ...]:
        return (train.x.shape[1], *self.cfg.hidden, n_classes)

    def partition_labels(self, train) -> np.ndarray:
        return np.asarray(train.y)

    def client_features(self, train, client_idx, n_classes: int) -> np.ndarray:
        return label_histograms(np.asarray(train.y), client_idx, n_classes)

    def init_params(self, draws, train, n_classes: int):
        return draws.init_params(self._sizes(train, n_classes))

    def layout(self, train, n_classes: int) -> MLPLayout:
        return MLPLayout(self._sizes(train, n_classes))

    def build_fns(self, train, n_classes: int):
        layout = self.layout(train, n_classes)

        def apply_fn(params, x):
            return mlp_apply(layout.views(params), x)

        return apply_fn, cross_entropy_loss, accuracy


@register_task("lm")
class LMTask(Task):
    """Federated language modelling: each client holds token sequences;
    the partition splits on a derived per-sequence topic label, and the
    server clusters clients by token histograms.

    task_kwargs, as in the reference: ``model`` (registered config name;
    default ``"xlstm-125m"``),
    ``reduced`` (default True), ``overrides`` (``ModelConfig`` fields
    applied after reduction; ``dtype`` defaults to float32) and
    ``hist_bins`` (default 64; tokens fold mod ``hist_bins``)."""

    name = "lm"

    def __init__(self, cfg: Any, model: str = "xlstm-125m", reduced: bool = True,
                 overrides: dict | None = None, hist_bins: int = 64):
        super().__init__(cfg)
        mc = get_config(model, reduced=bool(reduced))
        ov = {"dtype": "float32"}
        ov.update(overrides or {})
        mc = dataclasses.replace(mc, **ov)
        if mc.input_mode != "tokens":
            raise ValueError(
                f"task='lm' supports input_mode='tokens' only; model "
                f"{mc.name!r} has input_mode={mc.input_mode!r}"
            )
        if mc.mtp:
            raise ValueError(
                f"task='lm' does not wire the MTP aux loss into the "
                f"federated round; disable it for model {mc.name!r} via "
                f"task_kwargs={{'overrides': {{'mtp': False}}}}"
            )
        check_supported(mc)
        self.model_cfg = mc
        self.hist_bins = int(hist_bins)

    # -- data -> partition ----------------------------------------------
    def _fold(self, tokens: np.ndarray) -> np.ndarray:
        return np.asarray(tokens) % self.hist_bins

    def partition_labels(self, train) -> np.ndarray:
        """Dominant (folded) token of each sequence, a cheap topic proxy."""
        x = self._fold(train.x)
        labs = [np.bincount(row, minlength=self.hist_bins).argmax() for row in x]
        return np.asarray(labs, dtype=np.int64)

    def partition_classes(self, n_classes: int) -> int:
        return self.hist_bins

    def client_features(self, train, client_idx, n_classes: int) -> np.ndarray:
        x = self._fold(train.x)
        h = np.stack([
            np.bincount(x[ix].ravel(), minlength=self.hist_bins) for ix in client_idx
        ]).astype(np.float64)
        return h / np.maximum(h.sum(1, keepdims=True), 1e-12)

    # -- model ------------------------------------------------------------
    def init_params(self, draws, train, n_classes: int):
        hi = int(np.asarray(train.x).max())
        if hi >= self.model_cfg.vocab:
            raise ValueError(
                f"token id {hi} out of range for model vocab "
                f"{self.model_cfg.vocab} — regenerate the stream with "
                f"vocab <= model vocab or override the model config"
            )
        return draws.init_params(self.model_cfg)

    def layout(self, train, n_classes: int) -> TransformerLayout:
        return TransformerLayout(self.model_cfg)

    def _chunk_sum(self, ctx, labels, per_chunk):
        """Sum ``per_chunk(logits_f32, yc)`` over sequence chunks of
        ``loss_chunk`` (``chunked_logits_sum``, which ``loss_fn`` shares),
        so the logits never exist for the whole sequence at once.  Returns
        (sum, S)."""
        h, head = ctx[:2]
        tot = chunked_logits_sum(h, head, self.model_cfg.loss_chunk,
                                 lambda lg, lo, hi: per_chunk(lg, labels[..., lo:hi]))
        return tot, h.shape[-2]

    def build_fns(self, train, n_classes: int):
        mc = self.model_cfg
        layout = TransformerLayout(mc)

        def lm_apply(params, x):
            """Hidden states after the final norm and the output head (the
            "logits context"; logits are never (B, S, V) at once), plus the
            MoE router's aux loss (0 for dense models)."""
            tree = layout.views(params)
            h, aux = forward(tree, mc, x, with_aux=True)
            return h, output_head(tree, mc), aux

        def lm_loss(ctx, labels, weights=None):
            """Mean next-token CE over the batch and sequence axes of labels
            (..., B, S); ``weights`` are optional per-sequence weights.  An
            MoE model adds ``router_aux_weight`` x its aux loss, as
            ``loss_fn`` does."""
            w = (torch.ones(labels.shape[:-1], dtype=torch.float32, device=labels.device)
                 if weights is None else weights.to(torch.float32))
            tot, s = self._chunk_sum(
                ctx, labels, lambda lg, yc: (token_nll(lg, yc) * w[..., None]).sum((-2, -1)))
            loss = tot / torch.clamp(w.sum(-1) * s, min=1e-9)
            if mc.moe:
                loss = loss + mc.moe.router_aux_weight * ctx[2]
            return loss

        def lm_metric(ctx, labels):
            """Next-token accuracy (the ``test_acc`` slot)."""
            tot, s = self._chunk_sum(
                ctx, labels,
                lambda lg, yc: (lg.argmax(-1) == yc.to(torch.int64)).to(torch.float32).sum((-2, -1)))
            return tot / (labels.shape[-2] * s)

        return lm_apply, lm_loss, lm_metric

    def build_eval_extra(self, test, n_classes: int):
        """Held-out perplexity, total and per topic (the task's derived
        per-sequence partition labels of the test set)."""
        mc = self.model_cfg
        layout = TransformerLayout(mc)
        topics = np.asarray(self.partition_labels(test))
        topic_ids = np.unique(topics)

        def compute(params, test_x, test_y) -> dict:
            with torch.no_grad():
                tree = layout.views(params)
                ctx = (forward(tree, mc, test_x), output_head(tree, mc))
                tot, s = self._chunk_sum(ctx, test_y, lambda lg, yc: token_nll(lg, yc).sum(-1))
                nll = (tot / s).cpu().numpy()
            out = {"ppl": float(np.exp(nll.mean()))}
            out["ppl_per_cluster"] = {
                str(int(t)): float(np.exp(nll[topics == t].mean())) for t in topic_ids
            }
            return out

        return compute


def build_task(cfg) -> Task:
    return TASK_REGISTRY[cfg.task](cfg, **cfg.task_kwargs)

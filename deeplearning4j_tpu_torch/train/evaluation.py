"""Evaluation suite (the port of ``train/evaluation.py``): ``Evaluation``,
``RegressionEvaluation``, ``ROC``, ``ROCMultiClass``, ``ROCBinary``,
``EvaluationCalibration`` and ``EvaluationBinary``.

Accumulation is host-side numpy, as in the JAX package, and gives the same
counts, metrics and ``stats()`` strings.  Each ``eval`` takes numpy arrays
or tensors on any device: a tensor moves to the host once per call (bf16
widens to f32, numpy has no bf16).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch


def _host(a) -> np.ndarray:
    """`a` as a numpy array: a tensor is copied to the host (bf16 as f32)."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        if a.dtype == torch.bfloat16:
            a = a.float()
        return a.cpu().numpy()
    return np.asarray(a)


class Evaluation:
    """Multi-class classification eval (reference `Evaluation`): confusion
    matrix, accuracy, per-class and macro precision/recall/F1, top-N."""

    def __init__(self, num_classes: Optional[int] = None, top_n: int = 1):
        self.num_classes = num_classes
        self.top_n = top_n
        self.confusion: Optional[np.ndarray] = None
        self.top_n_correct = 0
        self.total = 0

    def _ensure(self, n: int):
        if self.confusion is None:
            self.num_classes = self.num_classes or n
            self.confusion = np.zeros((self.num_classes, self.num_classes), np.int64)

    def eval(self, labels: np.ndarray, predictions: np.ndarray,
             mask: Optional[np.ndarray] = None):
        labels = _host(labels)
        predictions = _host(predictions)
        if labels.ndim == 3:  # [batch, time, classes] -> flatten time
            labels = labels.reshape(-1, labels.shape[-1])
            predictions = predictions.reshape(-1, predictions.shape[-1])
            if mask is not None:
                keep = _host(mask).reshape(-1) > 0
                labels, predictions = labels[keep], predictions[keep]
        self._ensure(labels.shape[-1] if labels.ndim > 1 else int(labels.max()) + 1)
        true_idx = labels.argmax(-1) if labels.ndim > 1 else labels.astype(np.int64)
        pred_idx = predictions.argmax(-1)
        np.add.at(self.confusion, (true_idx, pred_idx), 1)
        self.total += len(true_idx)
        if self.top_n > 1:
            topn = np.argsort(-predictions, axis=-1)[:, :self.top_n]
            self.top_n_correct += int((topn == true_idx[:, None]).any(-1).sum())
        else:
            self.top_n_correct += int((pred_idx == true_idx).sum())

    # ---- metrics ----
    def accuracy(self) -> float:
        if self.total == 0:
            return 0.0
        return float(np.trace(self.confusion)) / self.total

    def top_n_accuracy(self) -> float:
        return self.top_n_correct / max(self.total, 1)

    def _tp(self):
        return np.diag(self.confusion).astype(np.float64)

    def precision(self, cls: Optional[int] = None) -> float:
        col = self.confusion.sum(0).astype(np.float64)
        p = np.divide(self._tp(), col, out=np.zeros_like(col), where=col > 0)
        return float(p[cls]) if cls is not None else float(p[col > 0].mean()) if (col > 0).any() else 0.0

    def recall(self, cls: Optional[int] = None) -> float:
        row = self.confusion.sum(1).astype(np.float64)
        r = np.divide(self._tp(), row, out=np.zeros_like(row), where=row > 0)
        return float(r[cls]) if cls is not None else float(r[row > 0].mean()) if (row > 0).any() else 0.0

    def f1(self, cls: Optional[int] = None) -> float:
        if cls is not None:
            p, r = self.precision(cls), self.recall(cls)
            return 2 * p * r / (p + r) if (p + r) > 0 else 0.0
        col = self.confusion.sum(0).astype(np.float64)
        row = self.confusion.sum(1).astype(np.float64)
        tp = self._tp()
        p = np.divide(tp, col, out=np.zeros_like(col), where=col > 0)
        r = np.divide(tp, row, out=np.zeros_like(row), where=row > 0)
        denom = p + r
        f = np.divide(2 * p * r, denom, out=np.zeros_like(denom), where=denom > 0)
        present = row > 0
        return float(f[present].mean()) if present.any() else 0.0

    def stats(self) -> str:
        lines = [
            "========================Evaluation Metrics========================",
            f" # of classes:    {self.num_classes}",
            f" Accuracy:        {self.accuracy():.4f}",
            f" Precision:       {self.precision():.4f}",
            f" Recall:          {self.recall():.4f}",
            f" F1 Score:        {self.f1():.4f}",
        ]
        if self.top_n > 1:
            lines.append(f" Top-{self.top_n} Accuracy: {self.top_n_accuracy():.4f}")
        lines.append("=================Confusion Matrix=================")
        lines.append(str(self.confusion))
        return "\n".join(lines)


class RegressionEvaluation:
    """Reference `RegressionEvaluation`: per-column MSE/MAE/RMSE/R²/
    correlation."""

    def __init__(self, num_columns: Optional[int] = None):
        self.n = 0
        self.sum_err2 = None
        self.sum_abs = None
        self.sum_label = None
        self.sum_label2 = None
        self.sum_pred = None
        self.sum_pred2 = None
        self.sum_lp = None

    def eval(self, labels: np.ndarray, predictions: np.ndarray,
             mask: Optional[np.ndarray] = None):
        labels = _host(labels).astype(np.float64).reshape(len(labels), -1)
        preds = _host(predictions).astype(np.float64).reshape(len(predictions), -1)
        if self.sum_err2 is None:
            c = labels.shape[1]
            z = lambda: np.zeros(c)
            self.sum_err2, self.sum_abs = z(), z()
            self.sum_label, self.sum_label2 = z(), z()
            self.sum_pred, self.sum_pred2, self.sum_lp = z(), z(), z()
        err = preds - labels
        self.sum_err2 += (err ** 2).sum(0)
        self.sum_abs += np.abs(err).sum(0)
        self.sum_label += labels.sum(0)
        self.sum_label2 += (labels ** 2).sum(0)
        self.sum_pred += preds.sum(0)
        self.sum_pred2 += (preds ** 2).sum(0)
        self.sum_lp += (labels * preds).sum(0)
        self.n += len(labels)

    def mean_squared_error(self, col: int = 0) -> float:
        return float(self.sum_err2[col] / self.n)

    def mean_absolute_error(self, col: int = 0) -> float:
        return float(self.sum_abs[col] / self.n)

    def root_mean_squared_error(self, col: int = 0) -> float:
        return float(np.sqrt(self.sum_err2[col] / self.n))

    def r_squared(self, col: int = 0) -> float:
        ss_tot = self.sum_label2[col] - self.sum_label[col] ** 2 / self.n
        return float(1.0 - self.sum_err2[col] / ss_tot) if ss_tot > 0 else 0.0

    def pearson_correlation(self, col: int = 0) -> float:
        n = self.n
        cov = self.sum_lp[col] - self.sum_label[col] * self.sum_pred[col] / n
        vl = self.sum_label2[col] - self.sum_label[col] ** 2 / n
        vp = self.sum_pred2[col] - self.sum_pred[col] ** 2 / n
        denom = np.sqrt(vl * vp)
        return float(cov / denom) if denom > 0 else 0.0

    def stats(self) -> str:
        cols = len(self.sum_err2)
        lines = ["Column    MSE            MAE            RMSE           R^2            Corr"]
        for c in range(cols):
            lines.append(
                f"col_{c}   {self.mean_squared_error(c):<14.6f} "
                f"{self.mean_absolute_error(c):<14.6f} "
                f"{self.root_mean_squared_error(c):<14.6f} "
                f"{self.r_squared(c):<14.6f} {self.pearson_correlation(c):.6f}")
        return "\n".join(lines)


class ROC:
    """Binary ROC/AUC + precision-recall AUC (reference `ROC`).  Exact
    (threshold-free) computation over accumulated scores."""

    def __init__(self):
        self.scores: List[np.ndarray] = []
        self.labels: List[np.ndarray] = []

    def eval(self, labels: np.ndarray, predictions: np.ndarray):
        labels = _host(labels)
        preds = _host(predictions)
        if labels.ndim > 1 and labels.shape[-1] == 2:
            labels = labels[..., 1]
            preds = preds[..., 1]
        self.labels.append(labels.reshape(-1))
        self.scores.append(preds.reshape(-1))

    def calculate_auc(self) -> float:
        y = np.concatenate(self.labels)
        s = np.concatenate(self.scores)
        order = np.argsort(-s, kind="stable")
        y = y[order]
        tps = np.cumsum(y)
        fps = np.cumsum(1 - y)
        P, N = tps[-1], fps[-1]
        if P == 0 or N == 0:
            return 0.0
        tpr = np.concatenate([[0], tps / P])
        fpr = np.concatenate([[0], fps / N])
        return float(np.trapezoid(tpr, fpr))

    def calculate_auprc(self) -> float:
        y = np.concatenate(self.labels)
        s = np.concatenate(self.scores)
        order = np.argsort(-s, kind="stable")
        y = y[order]
        tps = np.cumsum(y)
        P = tps[-1]
        if P == 0:
            return 0.0
        precision = tps / np.arange(1, len(y) + 1)
        recall = tps / P
        return float(np.trapezoid(precision, recall))


class ROCMultiClass:
    """One-vs-all ROC per class (reference `ROCMultiClass`)."""

    def __init__(self):
        self.rocs: Dict[int, ROC] = {}

    def eval(self, labels: np.ndarray, predictions: np.ndarray):
        labels = _host(labels)
        preds = _host(predictions)
        for c in range(labels.shape[-1]):
            self.rocs.setdefault(c, ROC()).eval(labels[..., c], preds[..., c])

    def calculate_auc(self, cls: int) -> float:
        return self.rocs[cls].calculate_auc()

    def calculate_average_auc(self) -> float:
        return float(np.mean([r.calculate_auc() for r in self.rocs.values()]))


class ROCBinary:
    """Per-output-column ROC for multi-label binary outputs (reference
    `org.nd4j.evaluation.classification.ROCBinary`): labels/predictions
    [N, K] with independent sigmoid columns."""

    def __init__(self):
        self._rocs: List[ROC] = []

    def eval(self, labels: np.ndarray, predictions: np.ndarray):
        labels = _host(labels)
        predictions = _host(predictions)
        if labels.ndim == 1:           # N samples of one output, not (1, N)
            labels = labels[:, None]
            predictions = predictions[:, None]
        while len(self._rocs) < labels.shape[1]:
            self._rocs.append(ROC())
        for k in range(labels.shape[1]):
            self._rocs[k].eval(labels[:, k], predictions[:, k])

    def num_labels(self) -> int:
        return len(self._rocs)

    def calculate_auc(self, output: int) -> float:
        return self._rocs[output].calculate_auc()

    def calculate_auprc(self, output: int) -> float:
        return self._rocs[output].calculate_auprc()

    def calculate_average_auc(self) -> float:
        return float(np.mean([r.calculate_auc() for r in self._rocs]))

    def stats(self) -> str:
        lines = ["ROCBinary:"]
        for k, r in enumerate(self._rocs):
            lines.append(f"  output {k}: AUC={r.calculate_auc():.4f} "
                         f"AUPRC={r.calculate_auprc():.4f}")
        return "\n".join(lines)


class EvaluationCalibration:
    """Reliability/calibration diagnostics (reference
    `org.nd4j.evaluation.classification.EvaluationCalibration`):
    reliability diagram per class, residual-probability histogram, and
    probability histograms, from binned predicted probabilities."""

    def __init__(self, reliability_bins: int = 10,
                 histogram_bins: int = 10):
        self.n_bins = reliability_bins
        self.hist_bins = histogram_bins
        self._counts: Optional[np.ndarray] = None   # [C, bins]
        self._pos: Optional[np.ndarray] = None      # [C, bins] label==1
        self._prob_sum: Optional[np.ndarray] = None
        self._residuals: Optional[np.ndarray] = None
        self._prob_hist: Optional[np.ndarray] = None

    def _ensure(self, c: int):
        if self._counts is None:
            self._counts = np.zeros((c, self.n_bins))
            self._pos = np.zeros((c, self.n_bins))
            self._prob_sum = np.zeros((c, self.n_bins))
            self._residuals = np.zeros(self.hist_bins)
            self._prob_hist = np.zeros((c, self.hist_bins))

    def eval(self, labels: np.ndarray, predictions: np.ndarray):
        labels = _host(labels)
        predictions = _host(predictions)
        if labels.ndim == 1:           # single binary output (as ROCBinary)
            labels = labels[:, None]
            predictions = predictions[:, None]
        c = labels.shape[1]
        self._ensure(c)
        bins = np.clip((predictions * self.n_bins).astype(int), 0,
                       self.n_bins - 1)
        for k in range(c):
            np.add.at(self._counts[k], bins[:, k], 1)
            np.add.at(self._pos[k], bins[:, k], labels[:, k])
            np.add.at(self._prob_sum[k], bins[:, k], predictions[:, k])
            hb = np.clip((predictions[:, k] * self.hist_bins).astype(int),
                         0, self.hist_bins - 1)
            np.add.at(self._prob_hist[k], hb, 1)
        # residual = |label - p| over ALL entries (reference residual plot)
        res = np.abs(labels - predictions).ravel()
        rb = np.clip((res * self.hist_bins).astype(int), 0,
                     self.hist_bins - 1)
        np.add.at(self._residuals, rb, 1)

    def reliability_diagram(self, cls: int):
        """Returns (mean_predicted_prob, observed_frequency) per bin
        (NaN where a bin is empty)."""
        with np.errstate(invalid="ignore", divide="ignore"):
            mean_p = self._prob_sum[cls] / self._counts[cls]
            obs = self._pos[cls] / self._counts[cls]
        return mean_p, obs

    def expected_calibration_error(self, cls: int) -> float:
        n = self._counts[cls].sum()
        mean_p, obs = self.reliability_diagram(cls)
        valid = self._counts[cls] > 0
        return float(np.sum(self._counts[cls][valid] / n
                            * np.abs(mean_p[valid] - obs[valid])))

    def get_residual_plot_all_classes(self) -> np.ndarray:
        return self._residuals.copy()

    def get_probability_histogram(self, cls: int) -> np.ndarray:
        return self._prob_hist[cls].copy()

    def stats(self) -> str:
        c = self._counts.shape[0]
        lines = ["EvaluationCalibration:"]
        for k in range(c):
            lines.append(
                f"  class {k}: ECE={self.expected_calibration_error(k):.4f}")
        return "\n".join(lines)


class EvaluationBinary:
    """Per-output binary classification metrics at a fixed threshold
    (reference `org.nd4j.evaluation.classification.EvaluationBinary`):
    independent sigmoid outputs, tp/fp/tn/fn accumulated per column."""

    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold
        self._tp: Optional[np.ndarray] = None
        self._fp: Optional[np.ndarray] = None
        self._tn: Optional[np.ndarray] = None
        self._fn: Optional[np.ndarray] = None

    def eval(self, labels: np.ndarray, predictions: np.ndarray):
        labels = _host(labels)
        predictions = _host(predictions)
        if labels.ndim == 1:
            labels = labels[:, None]
            predictions = predictions[:, None]
        pred = predictions >= self.threshold
        lab = labels >= 0.5
        if self._tp is None:
            k = labels.shape[1]
            self._tp = np.zeros(k)
            self._fp = np.zeros(k)
            self._tn = np.zeros(k)
            self._fn = np.zeros(k)
        elif labels.shape[1] != len(self._tp):
            raise ValueError(
                f"EvaluationBinary: batch has {labels.shape[1]} outputs, "
                f"accumulator has {len(self._tp)} (reference throws the "
                "same)")
        self._tp += np.sum(pred & lab, axis=0)
        self._fp += np.sum(pred & ~lab, axis=0)
        self._tn += np.sum(~pred & ~lab, axis=0)
        self._fn += np.sum(~pred & lab, axis=0)

    def num_labels(self) -> int:
        return 0 if self._tp is None else len(self._tp)

    def _counts(self, i):
        if self._tp is None:
            return 0.0, 0.0, 0.0, 0.0    # no data -> metrics return NaN
        return self._tp[i], self._fp[i], self._tn[i], self._fn[i]

    def accuracy(self, output: int) -> float:
        tp, fp, tn, fn = self._counts(output)
        total = tp + fp + tn + fn
        return float((tp + tn) / total) if total else float("nan")

    def precision(self, output: int) -> float:
        tp, fp, _, _ = self._counts(output)
        return float(tp / (tp + fp)) if tp + fp else float("nan")

    def recall(self, output: int) -> float:
        tp, _, _, fn = self._counts(output)
        return float(tp / (tp + fn)) if tp + fn else float("nan")

    def f1(self, output: int) -> float:
        tp, fp, _, fn = self._counts(output)
        denom = 2 * tp + fp + fn
        return float(2 * tp / denom) if denom else float("nan")

    def true_positives(self, output: int) -> int:
        return 0 if self._tp is None else int(self._tp[output])

    def false_positives(self, output: int) -> int:
        return 0 if self._fp is None else int(self._fp[output])

    def stats(self) -> str:
        lines = [f"EvaluationBinary (threshold={self.threshold}):"]
        for k in range(self.num_labels()):
            lines.append(
                f"  output {k}: acc={self.accuracy(k):.4f} "
                f"prec={self.precision(k):.4f} rec={self.recall(k):.4f} "
                f"f1={self.f1(k):.4f}")
        return "\n".join(lines)

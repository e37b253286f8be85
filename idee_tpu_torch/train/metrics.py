# ------------------------------------------------------------------
"""Evaluators (the port's numpy copy of the parts of
idee_tpu/train/metrics.py that evaluation uses).

Parity targets (metric definitions ARE the published numbers):
  evaluator (real world)     -- reference utils/utils_train.py:175-266
  evaluator_synthetic        -- reference utils/utils_train.py:269-347
  evaluator_anomaly_synthetic-- reference utils/utils_train.py:350-526
  anomaly_collector vote     -- reference utils/utils_train.py:529-554
"""
# ------------------------------------------------------------------

from typing import Dict

import numpy as np


def _f1(precision, accuracy):
    with np.errstate(divide="ignore", invalid="ignore"):
        return 2 * precision * accuracy / (accuracy + precision)


class EvaluatorSynthetic:
    """Extreme-event evaluator at Delta-t_0 (reference: :269-347)."""

    def __init__(self, logger=None, mode: str = "Training"):
        self.classes = [u" Δt0"]
        self.n_classes = 1
        self.mode = mode
        self.logger = logger
        self.reset()

    def reset(self):
        self.seen_all = 0
        self.correct = np.zeros(self.n_classes, np.int64)
        self.seen = np.zeros(self.n_classes, np.int64)
        self.iou_de = np.zeros(self.n_classes, np.int64)
        self.predicted = np.zeros(self.n_classes, np.int64)
        self.F1 = np.zeros(self.n_classes)
        self.iou = np.zeros(self.n_classes)
        self.precision = np.zeros(self.n_classes)
        self.accuracy = np.zeros(self.n_classes)

    def __call__(self, pred_c: np.ndarray, gt: np.ndarray):
        """pred_c/gt: [N, n_classes, H, W] in {0,1}."""
        self.seen_all += gt.size
        for label in range(self.n_classes):
            p = pred_c[:, label] == 1
            g = gt[:, label] == 1
            self.correct[label] += np.sum(p & g)
            self.seen[label] += np.sum(g)
            self.iou_de[label] += np.sum(p | g)
            self.predicted[label] += np.sum(p)

    def update_counts(self, counts: Dict[str, int]):
        """Accumulate device-side counters from steps.extreme_counts."""
        self.correct[0] += int(counts["correct"])
        self.seen[0] += int(counts["seen"])
        self.iou_de[0] += int(counts["iou_de"])
        self.predicted[0] += int(counts["predicted"])
        self.seen_all += int(counts["seen_all"])

    def get_results(self, mean_loss: float = np.nan,
                    best_loss: float = np.nan) -> str:
        with np.errstate(divide="ignore", invalid="ignore"):
            self.precision = self.correct / self.predicted.astype(float)
            self.accuracy = self.correct / (self.seen.astype(float) + 1e-6)
            self.F1 = _f1(self.precision, self.accuracy)
            self.iou = self.correct / self.iou_de.astype(float)

        msg = "-----------------   %s   -----------------\n" % self.mode
        for label in range(self.n_classes):
            msg += ("class %s weight: %.4f, precision: %.4f, accuracy: %.4f, "
                    "F1: %.4f IoU: %.4f \n") % (
                self.classes[label] + " " * (14 - len(self.classes[label])),
                self.seen[label] / max(self.seen_all / self.n_classes, 1e-9),
                self.precision[label], self.accuracy[label],
                self.F1[label], self.iou[label])
        msg += "\n%s mean accuracy : %.4f" % (self.mode, np.nanmean(self.accuracy))
        msg += "\n%s mean IoU      : %.4f" % (self.mode, np.nanmean(self.iou))
        msg += "\n%s mean F1       : %.4f" % (self.mode, np.nanmean(self.F1))
        msg += "\n%s mean loss     : %.4f" % (self.mode, mean_loss)
        msg += "\n%s best mean loss: %.4f\n" % (self.mode, best_loss)
        if self.logger is not None:
            self.logger.info(msg)
        return msg


class Evaluator:
    """Real-world per-class {normal, drought} evaluator over valid pixels
    (reference: utils/utils_train.py:175-266), fed the device counters of
    steps_real.drought_counts."""

    def __init__(self, logger=None, mode: str = "Training"):
        self.classes = ["normal", "drought"]
        self.n_classes = 2
        self.mode = mode
        self.logger = logger
        self.reset()

    def reset(self):
        n = self.n_classes
        self.correct_all = 0
        self.seen_all = 0
        self.seen_label_all = np.zeros(n, np.int64)
        self.correct_label_all = np.zeros(n, np.int64)
        self.iou_de_label_all = np.zeros(n, np.int64)
        self.predicted_label_all = np.zeros(n, np.int64)
        self.F1 = np.zeros(n)
        self.iou = np.zeros(n)

    def update_counts(self, counts: Dict[str, np.ndarray]):
        """Per-class counters of shape [n_classes] plus the two totals."""
        self.correct_label_all += np.asarray(counts["correct"], np.int64)
        self.seen_label_all += np.asarray(counts["seen"], np.int64)
        self.iou_de_label_all += np.asarray(counts["iou_de"], np.int64)
        self.predicted_label_all += np.asarray(counts["predicted"], np.int64)
        self.correct_all += int(counts["correct_all"])
        self.seen_all += int(counts["seen_all"])

    def get_results(self, mean_loss: float = np.nan,
                    best_loss: float = np.nan) -> str:
        with np.errstate(divide="ignore", invalid="ignore"):
            weights = self.seen_label_all / np.sum(self.seen_label_all)
            accuracy_all = self.correct_all / float(max(self.seen_all, 1))
            precision = (self.correct_label_all
                         / self.predicted_label_all.astype(float))
            accuracy = self.correct_label_all / (self.seen_label_all + 1e-6)
            self.F1 = _f1(precision, accuracy)
            self.iou = (self.correct_label_all
                        / self.iou_de_label_all.astype(float))

        msg = "-----------------   %s   -----------------\n" % self.mode
        for label in range(self.n_classes):
            msg += ("class %s weight: %.4f, precision: %.4f, accuracy: %.4f, "
                    "F1: %.4f IoU: %.4f \n") % (
                self.classes[label] + " " * (14 - len(self.classes[label])),
                weights[label], precision[label], accuracy[label],
                self.F1[label], self.iou[label])
        msg += "\n%s accuracy      : %.4f" % (self.mode, accuracy_all)
        msg += "\n%s mean accuracy : %.4f" % (self.mode, np.nanmean(accuracy))
        msg += "\n%s mean IoU      : %.4f" % (self.mode, np.nanmean(self.iou))
        msg += "\n%s mean F1       : %.4f" % (self.mode, np.nanmean(self.F1))
        msg += "\n%s mean loss     : %.4f" % (self.mode, mean_loss)
        msg += "\n%s best mean loss: %.4f\n" % (self.mode, best_loss)
        if self.logger is not None:
            self.logger.info(msg)
        return msg


class EvaluatorAnomalySynthetic:
    """Per-variable driver evaluator vs GT anomaly cube
    (reference: utils/utils_train.py:350-526). Inputs are [T, V, H, W]
    (the reference swaps axes before calling, train_synthetic.py:218)."""

    def __init__(self, logger=None, mode: str = "Training", variables=None):
        self.classes = list(variables or [])
        self.n_classes = len(self.classes)
        self.mode = mode
        self.logger = logger
        self.reset()

    def reset(self):
        n = self.n_classes
        self.correct_all = 0
        self.seen_all = 0
        self.correct_pos = np.zeros(n, np.int64)
        self.seen_pos = np.zeros(n, np.int64)
        self.iou_de_pos = np.zeros(n, np.int64)
        self.predicted_pos = np.zeros(n, np.int64)
        self.correct_neg = np.zeros(n, np.int64)
        self.seen_neg = np.zeros(n, np.int64)
        self.iou_de_neg = np.zeros(n, np.int64)
        self.predicted_neg = np.zeros(n, np.int64)
        self.FP = np.zeros(n, np.int64)
        self.FN = np.zeros(n, np.int64)
        self.correct_p_all = 0
        self.seen_p_all = 0
        self.iou_de_all = 0
        self.predicted_all = 0
        self.F1_pos = np.zeros(n)
        self.iou_pos = np.zeros(n)
        self.F1_neg = np.zeros(n)
        self.iou_neg = np.zeros(n)

    def __call__(self, pred: np.ndarray, gt: np.ndarray):
        self.correct_all += np.sum(pred == gt)
        self.seen_all += gt.size
        for label in range(self.n_classes):
            p, g = pred[:, label], gt[:, label]
            self.correct_pos[label] += np.sum((p == 1) & (g == 1))
            self.seen_pos[label] += np.sum(g == 1)
            self.iou_de_pos[label] += np.sum((p == 1) | (g == 1))
            self.predicted_pos[label] += np.sum(p == 1)
            self.correct_neg[label] += np.sum((p == 0) & (g == 0))
            self.seen_neg[label] += np.sum(g == 0)
            self.iou_de_neg[label] += np.sum((p == 0) | (g == 0))
            self.predicted_neg[label] += np.sum(p == 0)
            self.FP[label] += np.sum((p == 1) & (g == 0))
            self.FN[label] += np.sum((p == 0) & (g == 1))
        self.correct_p_all += np.sum((pred == 1) & (gt == 1))
        self.seen_p_all += np.sum(gt == 1)
        self.iou_de_all += np.sum((pred == 1) | (gt == 1))
        self.predicted_all += np.sum(pred == 1)

    def get_results(self) -> str:
        with np.errstate(divide="ignore", invalid="ignore"):
            self.accuracy_all = self.correct_all / float(max(self.seen_all, 1))
            precision_pos = self.correct_pos / self.predicted_pos.astype(float)
            accuracy_pos = self.correct_pos / (self.seen_pos + 1e-6)
            self.F1_pos = _f1(precision_pos, accuracy_pos)
            self.iou_pos = self.correct_pos / self.iou_de_pos.astype(float)
            precision_neg = self.correct_neg / self.predicted_neg.astype(float)
            accuracy_neg = self.correct_neg / (self.seen_neg + 1e-6)
            self.F1_neg = _f1(precision_neg, accuracy_neg)
            self.iou_neg = self.correct_neg / self.iou_de_neg.astype(float)
            precision_all = self.correct_p_all / float(max(self.predicted_all, 1))
            accuracy_all = self.correct_p_all / (self.seen_p_all + 1e-6)
            self.F1_all = _f1(precision_all, accuracy_all)
            self.iou_all = self.correct_p_all / float(max(self.iou_de_all, 1))

        msg = "-----------------   %s   -----------------\n" % self.mode
        for label in range(self.n_classes):
            msg += ("class %s pos   weight: %.4f, precision: %.4f, "
                    "accuracy: %.4f, F1: %.4f IoU: %.4f \n") % (
                self.classes[label] + " " * max(0, 7 - len(self.classes[label])),
                self.seen_pos[label] / max(self.seen_all / max(self.n_classes, 1), 1e-9),
                precision_pos[label], accuracy_pos[label],
                self.F1_pos[label], self.iou_pos[label])
            msg += (" " * (13 + max(0, 7 - len(self.classes[label])))
                    + "neg   weight: %.4f, precision: %.4f, accuracy: %.4f, "
                      "F1: %.4f IoU: %.4f \n") % (
                self.seen_neg[label] / max(self.seen_all / max(self.n_classes, 1), 1e-9),
                precision_neg[label], accuracy_neg[label],
                self.F1_neg[label], self.iou_neg[label])
        msg += "\n"
        for label in range(self.n_classes):
            msg += ("class %s weight: %.4f, TP: %i, FP: %i, TN: %i FN: %i, "
                    "F1: %.4f, IoU: %.4f \n") % (
                self.classes[label] + " " * max(0, 13 - len(self.classes[label])),
                self.seen_pos[label] / max(self.seen_all / max(self.n_classes, 1), 1e-9),
                self.correct_pos[label], self.FP[label],
                self.correct_neg[label], self.FN[label],
                self.F1_pos[label], self.iou_pos[label])
        msg += "\n"
        msg += ("all var             weight: %.4f, precision: %.4f, "
                "accuracy: %.4f, F1: %.4f IoU: %.4f \n") % (
            self.seen_p_all / max(self.seen_all, 1),
            precision_all, accuracy_all, self.F1_all, self.iou_all)
        msg += "\n%s accuracy               : %.4f" % (self.mode, self.accuracy_all)
        msg += "\n%s mean accuracy positive : %.4f" % (self.mode, np.nanmean(accuracy_pos))
        msg += "\n%s mean IoU positive      : %.4f" % (self.mode, np.nanmean(self.iou_pos))
        msg += "\n%s mean F1 positive       : %.4f" % (self.mode, np.nanmean(self.F1_pos))
        if self.logger is not None:
            self.logger.info(msg)
        return msg


def majority_vote_from_device(vote_sum: np.ndarray,
                              vote_cnt: np.ndarray) -> np.ndarray:
    """Threshold the device-accumulated vote buffers
    (steps.init_epoch_metrics) into the collector's [V, T, H, W] anomaly
    matrix: mean >= 0.5 -> 1, uncovered slots -> NaN."""
    with np.errstate(divide="ignore", invalid="ignore"):
        vote = vote_sum.astype(np.float32) / vote_cnt.astype(np.float32)[
            None, :, None, None]
    return np.where(vote >= 0.5, 1.0, np.where(vote < 0.5, 0.0, vote))

"""Classification metrics on host numpy arrays.

Counterpart of ``ssl4polyp_tpu/metrics/performance.py`` (reference
``src/ssl4polyp/classification/metrics/performance.py``): the same names,
warnings and numerical contracts (macro averaging with 1e-8 smoothing, NaN
AUROC on single-class targets, tau-thresholded binary predictions,
probability-vs-logit sniffing), on numpy alone.  Where the JAX package calls
``sklearn.metrics``, this module computes the same values itself
(:func:`roc_auc_binary`, :func:`roc_auc_ovr_macro`,
:func:`average_precision_binary`, :func:`average_precision_macro`,
:func:`balanced_accuracy_score`, :func:`matthews_corrcoef`,
:func:`precision_recall_f1`), edge cases included: tied scores share a threshold, a
class absent from a subset scores what scikit-learn scores it.
"""

from __future__ import annotations

import warnings
from typing import Dict, Optional

import numpy as np

_PROB_ATOL = 1e-6
_PROB_RTOL = 1e-4
_SMOOTH = 1e-8

__all__ = [
    "average_precision_binary",
    "average_precision_macro",
    "balanced_accuracy_score",
    "matthews_corrcoef",
    "precision_recall_f1",
    "recall_f1",
    "roc_auc_binary",
    "roc_auc_ovr_macro",
    "as_binary_scores",
    "as_class_probabilities",
    "as_label_predictions",
    "mean_f1",
    "mean_precision",
    "mean_recall",
    "mean_auroc",
    "mean_auprc",
    "balanced_accuracy",
    "mcc",
    "binary_metrics_block",
]


# ---------------------------------------------------------------------------
# The scikit-learn functions the JAX package calls, on numpy.
# ---------------------------------------------------------------------------

def _check_scores(y_true: np.ndarray, y_score: np.ndarray) -> None:
    if y_true.shape[0] == 0:
        raise ValueError("Found array with 0 sample(s) while a minimum of 1 is required")
    if y_true.shape[0] != y_score.shape[0]:
        raise ValueError(f"Found input variables with inconsistent numbers of samples: "
                         f"{[y_true.shape[0], y_score.shape[0]]}")
    if not np.all(np.isfinite(np.asarray(y_score, dtype=np.float64))):
        raise ValueError("Input contains NaN or infinity")


def _binary_clf_curve(positive: np.ndarray, y_score: np.ndarray):
    """(fps, tps) at each distinct score, scores descending: the counts of
    false and true positives when everything scoring at least that much is
    called positive.  Tied scores share one threshold."""
    order = np.argsort(y_score, kind="mergesort")[::-1]
    y_score = y_score[order]
    positive = positive[order]
    ends = np.r_[np.where(np.diff(y_score))[0], positive.size - 1]
    tps = np.cumsum(positive, dtype=np.float64)[ends]
    fps = 1 + ends - tps
    return fps, tps


def roc_auc_binary(y_true, y_score) -> float:
    """Area under the ROC curve of 1-D ``y_score`` against two-valued
    ``y_true`` (the larger label is the positive one): the trapezoid over
    the distinct thresholds, which averages tied scores as the rank
    statistic does.  NaN, with a warning, when one class is absent."""
    y_true = np.asarray(y_true).ravel()
    y_score = np.asarray(y_score).ravel()
    _check_scores(y_true, y_score)
    labels = np.unique(y_true)
    if labels.size != 2:
        warnings.warn(
            "Only one class is present in y_true. ROC AUC score is not defined in that case.",
            RuntimeWarning, stacklevel=2)
        return float("nan")
    fps, tps = _binary_clf_curve(y_true == labels[1], y_score)
    if fps.size > 2:
        # Drop the points collinear with both neighbours, as scikit-learn's
        # ``roc_curve(drop_intermediate=True)`` does: the area is the same
        # in exact arithmetic, and the same bits only over the same points.
        keep = np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True]
        fps, tps = fps[keep], tps[keep]
    fpr = np.r_[0.0, fps] / fps[-1]
    tpr = np.r_[0.0, tps] / tps[-1]
    return float(np.sum(np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2.0))


def roc_auc_ovr_macro(y_true, y_prob) -> float:
    """One-vs-rest ROC AUC of (N, C) probabilities, the unweighted mean over
    the classes.  ``ValueError`` when the rows do not sum to 1 or a class is
    absent from ``y_true``, as scikit-learn raises."""
    y_true = np.asarray(y_true).ravel()
    y_prob = np.asarray(y_prob)
    if y_prob.ndim != 2:
        raise ValueError("`y_score` needs to be of shape `(n_samples, n_classes)`, since "
                         f"`y_true` contains multiple classes. Got `y_score.shape={y_prob.shape}`.")
    _check_scores(y_true, y_prob)
    if not np.allclose(1, y_prob.sum(axis=1)):
        raise ValueError("Target scores need to be probabilities for multiclass roc_auc, "
                         "i.e. they should sum up to 1.0 over classes")
    classes = np.unique(y_true)
    if classes.size != y_prob.shape[1]:
        raise ValueError("Number of classes in y_true not equal to the number of "
                         "columns in 'y_score'")
    return float(np.mean([roc_auc_binary(y_true == c, y_prob[:, i])
                          for i, c in enumerate(classes)]))


def average_precision_binary(y_true, y_score) -> float:
    """Average precision with label 1 positive: the step-wise sum over the
    distinct thresholds of (recall step) x (precision there), no
    interpolation.  Without a positive it is 0, with a warning."""
    y_true = np.asarray(y_true).ravel()
    y_score = np.asarray(y_score).ravel()
    _check_scores(y_true, y_score)
    labels = np.unique(y_true)
    if labels.size > 2:
        raise ValueError("average_precision_binary takes two-valued targets")
    if labels.size == 2 and 1 not in labels:
        raise ValueError(f"pos_label=1 is not a valid label. It should be one of {labels}")
    fps, tps = _binary_clf_curve(y_true == 1, y_score)
    ps = tps + fps
    precision = np.where(ps != 0, tps / np.where(ps != 0, ps, 1.0), 0.0)
    if tps[-1] == 0:
        warnings.warn("No positive class found in y_true, recall is set to one for all "
                      "thresholds.", UserWarning, stacklevel=2)
        recall = np.ones_like(tps)
    else:
        recall = tps / tps[-1]
    precision = np.r_[precision[::-1], 1.0]
    recall = np.r_[recall[::-1], 0.0]
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


def average_precision_macro(one_hot, y_prob) -> float:
    """The unweighted mean over the columns of :func:`average_precision_binary`."""
    one_hot = np.asarray(one_hot)
    y_prob = np.asarray(y_prob)
    if one_hot.ndim != 2 or one_hot.shape != y_prob.shape:
        raise ValueError(f"one-hot targets {one_hot.shape} do not fit scores {y_prob.shape}")
    return float(np.mean([average_precision_binary(one_hot[:, c], y_prob[:, c])
                          for c in range(one_hot.shape[1])]))


def _confusion(y_true: np.ndarray, y_pred: np.ndarray):
    """(labels, C) with C[i, j] the count of true label i predicted as j,
    over the sorted union of the labels on either side."""
    y_true = np.asarray(y_true).ravel()
    y_pred = np.asarray(y_pred).ravel()
    if y_true.shape != y_pred.shape:
        raise ValueError(f"Found input variables with inconsistent numbers of samples: "
                         f"{[y_true.shape[0], y_pred.shape[0]]}")
    if y_true.size == 0:
        raise ValueError("Found array with 0 sample(s) while a minimum of 1 is required")
    labels, inverse = np.unique(np.concatenate([y_true, y_pred]), return_inverse=True)
    k = labels.size
    true_i, pred_i = inverse[:y_true.size], inverse[y_true.size:]
    counts = np.bincount(true_i * k + pred_i, minlength=k * k).reshape(k, k)
    return labels, counts.astype(np.float64)


def balanced_accuracy_score(y_true, y_pred) -> float:
    """The mean over the classes present in ``y_true`` of their recall."""
    _, C = _confusion(y_true, y_pred)
    support = C.sum(axis=1)
    present = support > 0
    if not present.all():
        warnings.warn("y_pred contains classes not in y_true", UserWarning, stacklevel=2)
    return float(np.mean(np.diag(C)[present] / support[present]))


def matthews_corrcoef(y_true, y_pred) -> float:
    """Matthews correlation over any number of classes; 0 where either side
    is constant."""
    _, C = _confusion(y_true, y_pred)
    t_sum = C.sum(axis=1)
    p_sum = C.sum(axis=0)
    n_correct = np.trace(C)
    n_samples = p_sum.sum()
    cov_ytyp = n_correct * n_samples - np.dot(t_sum, p_sum)
    cov_ypyp = n_samples ** 2 - np.dot(p_sum, p_sum)
    cov_ytyt = n_samples ** 2 - np.dot(t_sum, t_sum)
    if cov_ypyp * cov_ytyt == 0:
        return 0.0
    return float(cov_ytyp / np.sqrt(cov_ytyt * cov_ypyp))


def precision_recall_f1(y_true, y_pred, average: str = "binary"):
    """(precision, recall, F1) with an empty denominator scoring 0
    (scikit-learn's ``zero_division=0``).  ``binary``: of label 1, on
    two-valued data; ``macro``: the unweighted mean over the labels on
    either side."""
    labels, C = _confusion(y_true, y_pred)
    tp = np.diag(C)
    support = C.sum(axis=1)
    predicted = C.sum(axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(predicted > 0, tp / predicted, 0.0)
        recall = np.where(support > 0, tp / support, 0.0)
        f1 = np.where(support + predicted > 0, 2 * tp / (support + predicted), 0.0)
    if average == "macro":
        return float(precision.mean()), float(recall.mean()), float(f1.mean())
    if average != "binary":
        raise ValueError(f"average must be 'binary' or 'macro', got {average!r}")
    if labels.size > 2:
        raise ValueError("Target is multiclass but average='binary'. Please choose another "
                         "average setting.")
    if 1 not in labels:
        if labels.size == 2:
            raise ValueError(f"pos_label=1 is not a valid label. It should be one of {labels}")
        return 0.0, 0.0, 0.0
    at = int(np.where(labels == 1)[0][0])
    return float(precision[at]), float(recall[at]), float(f1[at])


def recall_f1(y_true, y_pred, average: str = "binary"):
    """(recall, F1) of :func:`precision_recall_f1`."""
    return precision_recall_f1(y_true, y_pred, average)[1:]


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


def _softmax(x: np.ndarray) -> np.ndarray:
    shifted = x - x.max(axis=1, keepdims=True)
    exp = np.exp(shifted)
    return exp / exp.sum(axis=1, keepdims=True)


def _looks_like_prob_vector(x: np.ndarray) -> bool:
    if x.size == 0:
        return True
    return float(x.min()) >= -_PROB_ATOL and float(x.max()) <= 1.0 + _PROB_ATOL


def _looks_like_prob_matrix(x: np.ndarray) -> bool:
    if x.size == 0:
        return True
    if not _looks_like_prob_vector(x):
        return False
    sums = x.sum(axis=1)
    return bool(np.allclose(sums, 1.0, atol=1e-3, rtol=_PROB_RTOL))


def as_binary_scores(preds: np.ndarray) -> np.ndarray:
    """Positive-class probabilities from (N,), (N,1) or (N,2) preds."""
    preds = np.asarray(preds)
    if preds.ndim == 1:
        if np.issubdtype(preds.dtype, np.floating):
            return preds if _looks_like_prob_vector(preds) else _sigmoid(preds)
        return preds.astype(np.float32)
    if preds.ndim == 2:
        if preds.shape[1] == 1:
            return as_binary_scores(preds[:, 0])
        if preds.shape[1] != 2:
            raise ValueError("Binary score extraction needs (N,), (N,1) or (N,2)")
        if np.issubdtype(preds.dtype, np.floating) and _looks_like_prob_matrix(preds):
            return preds[:, 1]
        return _softmax(preds.astype(np.float64))[:, 1]
    raise ValueError("Predictions must be 1D or 2D")


def as_class_probabilities(preds: np.ndarray, n_class: int) -> np.ndarray:
    preds = np.asarray(preds)
    if preds.ndim != 2 or preds.shape[1] != n_class:
        raise ValueError(f"Expected (N, {n_class}) array, got {preds.shape}")
    if np.issubdtype(preds.dtype, np.floating) and _looks_like_prob_matrix(preds):
        return preds
    return _softmax(preds.astype(np.float64))


def as_label_predictions(
    preds: np.ndarray, n_class: int, tau: Optional[float] = None
) -> np.ndarray:
    """Discrete predictions; binary problems threshold P(positive) at τ."""
    preds = np.asarray(preds)
    if preds.ndim == 1:
        if np.issubdtype(preds.dtype, np.floating):
            if n_class != 2:
                raise ValueError("1D float predictions only supported for binary")
            scores = preds if _looks_like_prob_vector(preds) else _sigmoid(preds)
            return (scores >= (0.5 if tau is None else tau)).astype(np.int64)
        return preds.astype(np.int64)
    if preds.ndim == 2:
        if preds.shape[1] == 1:
            return as_label_predictions(preds[:, 0], n_class, tau)
        if n_class == 2:
            scores = as_binary_scores(preds)
            return (scores >= (0.5 if tau is None else tau)).astype(np.int64)
        return np.argmax(as_class_probabilities(preds, n_class), axis=1)
    raise ValueError("Predictions must be 1D or 2D")


def _macro(preds, targets, n_class, tau, per_class_fn) -> float:
    labels = as_label_predictions(preds, n_class, tau)
    targets = np.asarray(targets)
    total = 0.0
    for c in range(n_class):
        pred_c = labels == c
        true_c = targets == c
        total += per_class_fn(pred_c, true_c)
    return float(total / n_class)


def mean_f1(preds, targets, n_class: int = 2, tau: Optional[float] = None) -> float:
    return _macro(
        preds, targets, n_class, tau,
        lambda p, t: (2.0 * ((p & t).sum() + _SMOOTH)) / (p.sum() + t.sum() + _SMOOTH),
    )


def mean_precision(preds, targets, n_class: int = 2, tau: Optional[float] = None) -> float:
    return _macro(
        preds, targets, n_class, tau,
        lambda p, t: ((p & t).sum() + _SMOOTH) / (p.sum() + _SMOOTH),
    )


def mean_recall(preds, targets, n_class: int = 2, tau: Optional[float] = None) -> float:
    return _macro(
        preds, targets, n_class, tau,
        lambda p, t: ((p & t).sum() + _SMOOTH) / (t.sum() + _SMOOTH),
    )


def mean_auroc(preds, targets, n_class: int = 2) -> float:
    preds = np.asarray(preds)
    targets = np.asarray(targets)
    if np.unique(targets).size < 2:
        warnings.warn(
            "AUROC undefined with a single target class; returning NaN.",
            RuntimeWarning,
            stacklevel=2,
        )
        return float("nan")
    if n_class == 2:
        if preds.ndim == 2 and preds.shape[1] == 2:
            # Reference meanAUROC ranks by raw column 1 (``performance.py``:
            # preds[:, 1] straight into roc_auc_score) — NOT by the softmax
            # p1 = sigmoid(x1 - x0), which reverses rankings when x0 varies.
            scores = preds[:, 1]
        else:
            scores = as_binary_scores(preds)
        return roc_auc_binary(targets, scores)
    probs = as_class_probabilities(preds, n_class)
    return roc_auc_ovr_macro(targets, probs)


def mean_auprc(preds, targets, n_class: int = 2) -> float:
    targets = np.asarray(targets)
    if n_class == 2:
        scores = as_binary_scores(np.asarray(preds))
        return average_precision_binary(targets, scores)
    probs = as_class_probabilities(np.asarray(preds), n_class)
    # int cast mirrors the reference's targets.to(torch.long) before one_hot
    one_hot = np.eye(n_class, dtype=np.int64)[np.asarray(targets).astype(np.int64)]
    return average_precision_macro(one_hot, probs)


def balanced_accuracy(preds, targets, n_class: int = 2, tau: Optional[float] = None) -> float:
    labels = as_label_predictions(np.asarray(preds), n_class, tau)
    return float(balanced_accuracy_score(np.asarray(targets), labels))


def mcc(preds, targets, n_class: int = 2, tau: Optional[float] = None) -> float:
    labels = as_label_predictions(np.asarray(preds), n_class, tau)
    return float(matthews_corrcoef(np.asarray(targets), labels))


def binary_metrics_block(
    probs: np.ndarray,
    targets: np.ndarray,
    tau: Optional[float] = None,
    loss: Optional[float] = None,
) -> Dict[str, float]:
    """Full per-split metric block (the reference's reported metric set:
    ``README.md:335`` / ``common_metrics.py:100``).

    Averaging convention: POSITIVE-CLASS binary (scikit-learn's semantics), the
    same convention as the analysis layer's frame recomputation
    (``analysis/common.py::compute_binary_metrics``, reference
    ``common_metrics.py:142-144``) and the threshold policies
    (``thresholds.py``).  The reference's *train-side* functors are
    macro-averaged (``performance.py:100-155``) — an internal inconsistency
    the reference tolerates because its artifact audit is disabled
    (``result_loader.py:189``); ours is active
    (``report_core.recompute_primary_metrics``), so the declared block
    must match the frames recomputation.  The macro functors remain
    available above for multiclass parity.  All thresholded metrics
    derive from ONE confusion pass.
    """
    probs = as_binary_scores(np.asarray(probs))
    targets = np.asarray(targets).astype(np.int64)
    threshold = 0.5 if tau is None else float(tau)
    predictions = (probs >= threshold).astype(np.int64)
    tp = int(((predictions == 1) & (targets == 1)).sum())
    fp = int(((predictions == 1) & (targets == 0)).sum())
    tn = int(((predictions == 0) & (targets == 0)).sum())
    fn = int(((predictions == 0) & (targets == 1)).sum())
    n = len(targets)
    recall = tp / (tp + fn) if tp + fn else 0.0
    precision = tp / (tp + fp) if tp + fp else 0.0
    f1 = (2 * tp) / (2 * tp + fp + fn) if (2 * tp + fp + fn) else 0.0
    tnr = tn / (tn + fp) if tn + fp else 0.0
    bal_acc = 0.5 * (recall + tnr)
    mcc_den = float(tp + fp) * (tp + fn) * (tn + fp) * (tn + fn)
    mcc_val = (
        (tp * tn - fp * fn) / np.sqrt(mcc_den) if mcc_den > 0 else 0.0
    )
    single_class = np.unique(targets).size < 2
    if single_class:
        warnings.warn(
            "AUROC undefined with a single target class; returning NaN.",
            RuntimeWarning,
            stacklevel=2,
        )
    block: Dict[str, float] = {
        "recall": float(recall),
        "precision": float(precision),
        "f1": float(f1),
        "balanced_accuracy": float(bal_acc),
        "auroc": float("nan") if single_class else roc_auc_binary(targets, probs),
        "auprc": average_precision_binary(targets, probs),
        "mcc": float(mcc_val),
        "tp": tp,
        "fp": fp,
        "tn": tn,
        "fn": fn,
        "n_total": n,
        "n_pos": int((targets == 1).sum()),
        "n_neg": int((targets == 0).sum()),
        "prevalence": float((targets == 1).sum() / n) if n else float("nan"),
        "tau": threshold,
    }
    if loss is not None:
        block["loss"] = float(loss)
    return block

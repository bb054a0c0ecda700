"""The port's numpy metrics against scikit-learn and against the JAX
package's metric module (which calls scikit-learn), on drawn scores with
ties, single-class subsets and three classes.

Every value must agree to 1e-12: both sides take the same sums over the same
distinct thresholds, so only the order of a few float64 additions differs.
"""

import warnings

import numpy as np
import pytest
import sklearn.metrics as skm
from hypothesis import given, settings
from hypothesis import strategies as st

from ssl4polyp_tpu.metrics import performance as jax_perf
from ssl4polyp_tpu_torch.metrics import performance as perf

TOL = 1e-12
SETTINGS = settings(max_examples=120, deadline=None, derandomize=True)

# Scores on a coarse grid, so that ties are the rule, not the exception.
_score = st.integers(0, 8).map(lambda i: i / 8.0)
_logit = st.integers(-6, 6).map(lambda i: i / 2.0)


@st.composite
def binary_case(draw, both_classes=False):
    n = draw(st.integers(2 if both_classes else 1, 24))
    targets = np.asarray(draw(st.lists(st.integers(0, 1), min_size=n, max_size=n)))
    if both_classes:
        targets[0], targets[1] = 0, 1
    scores = np.asarray(draw(st.lists(_score, min_size=n, max_size=n)), dtype=np.float64)
    return targets, scores


@st.composite
def multiclass_case(draw, all_present=True):
    n = draw(st.integers(3, 24))
    targets = np.asarray(draw(st.lists(st.integers(0, 2), min_size=n, max_size=n)))
    if all_present:
        targets[:3] = (0, 1, 2)
    logits = np.asarray(draw(st.lists(st.tuples(_logit, _logit, _logit), min_size=n, max_size=n)),
                        dtype=np.float64)
    return targets, logits


def _close(ours, ref):
    if isinstance(ref, float) and np.isnan(ref):
        assert np.isnan(ours)
    else:
        np.testing.assert_allclose(ours, ref, rtol=0, atol=TOL)


def _quiet(fn, *args, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*args, **kwargs)


@SETTINGS
@given(binary_case(both_classes=True))
def test_roc_auc_binary_matches_sklearn(case):
    targets, scores = case
    _close(perf.roc_auc_binary(targets, scores), float(skm.roc_auc_score(targets, scores)))


def test_roc_auc_binary_single_class_is_nan_with_a_warning():
    with pytest.warns(RuntimeWarning):
        assert np.isnan(perf.roc_auc_binary(np.ones(4, int), np.linspace(0, 1, 4)))
    assert np.isnan(_quiet(skm.roc_auc_score, np.ones(4, int), np.linspace(0, 1, 4)))


def test_roc_auc_binary_averages_ties_as_the_rank_statistic_does():
    targets = np.array([0, 1, 0, 1, 1, 0])
    scores = np.array([0.5, 0.5, 0.5, 0.9, 0.5, 0.1])
    # P(pos > neg) + 0.5 P(pos == neg) over the 9 pairs.
    wins = sum((p > q) + 0.5 * (p == q) for p in scores[targets == 1] for q in scores[targets == 0])
    _close(perf.roc_auc_binary(targets, scores), wins / 9.0)


@SETTINGS
@given(binary_case())
def test_average_precision_binary_matches_sklearn(case):
    targets, scores = case  # single-class subsets included
    _close(_quiet(perf.average_precision_binary, targets, scores),
           float(_quiet(skm.average_precision_score, targets, scores)))


def test_average_precision_without_a_positive_is_zero_with_a_warning():
    with pytest.warns(UserWarning):
        assert perf.average_precision_binary(np.zeros(3, int), np.array([0.2, 0.2, 0.7])) == 0.0


@SETTINGS
@given(multiclass_case())
def test_roc_auc_ovr_macro_matches_sklearn(case):
    targets, logits = case
    probs = perf.as_class_probabilities(logits, 3)
    _close(perf.roc_auc_ovr_macro(targets, probs),
           float(skm.roc_auc_score(targets, probs, multi_class="ovr", average="macro")))


def test_roc_auc_ovr_macro_refuses_an_absent_class_as_sklearn_does():
    targets = np.array([0, 1, 1, 0])
    probs = np.full((4, 3), 1.0 / 3.0)
    with pytest.raises(ValueError):
        perf.roc_auc_ovr_macro(targets, probs)
    with pytest.raises(ValueError):
        skm.roc_auc_score(targets, probs, multi_class="ovr", average="macro", labels=None)


@SETTINGS
@given(multiclass_case(all_present=False))
def test_average_precision_macro_matches_sklearn(case):
    targets, logits = case  # a class may be absent: its column scores 0
    probs = perf.as_class_probabilities(logits, 3)
    one_hot = np.eye(3, dtype=np.int64)[targets]
    _close(_quiet(perf.average_precision_macro, one_hot, probs),
           float(_quiet(skm.average_precision_score, one_hot, probs, average="macro")))


@SETTINGS
@given(multiclass_case(all_present=False), st.integers(0, 2 ** 31 - 1))
def test_confusion_metrics_match_sklearn(case, seed):
    targets, logits = case
    preds = np.argmax(logits, axis=1)
    if seed % 3 == 0:  # predictions of one class only
        preds = np.zeros_like(preds)
    _close(_quiet(perf.balanced_accuracy_score, targets, preds),
           float(_quiet(skm.balanced_accuracy_score, targets, preds)))
    _close(perf.matthews_corrcoef(targets, preds), float(skm.matthews_corrcoef(targets, preds)))
    recall, f1 = perf.recall_f1(targets, preds, "macro")
    _close(recall, float(skm.recall_score(targets, preds, zero_division=0, average="macro")))
    _close(f1, float(skm.f1_score(targets, preds, zero_division=0, average="macro")))


@SETTINGS
@given(binary_case(), st.integers(0, 8))
def test_binary_recall_f1_match_sklearn(case, cut):
    targets, scores = case  # single-class subsets included
    preds = (scores >= cut / 8.0).astype(np.int64)
    recall, f1 = perf.recall_f1(targets, preds, "binary")
    _close(recall, float(skm.recall_score(targets, preds, zero_division=0, average="binary")))
    _close(f1, float(skm.f1_score(targets, preds, zero_division=0, average="binary")))
    _close(_quiet(perf.balanced_accuracy_score, targets, preds),
           float(_quiet(skm.balanced_accuracy_score, targets, preds)))
    _close(perf.matthews_corrcoef(targets, preds), float(skm.matthews_corrcoef(targets, preds)))


_BINARY_FUNCTIONS = ("mean_f1", "mean_precision", "mean_recall", "mean_auroc", "mean_auprc",
                     "balanced_accuracy", "mcc")


@pytest.mark.parametrize("name", _BINARY_FUNCTIONS)
@SETTINGS
@given(case=binary_case(), tau=st.sampled_from([None, 0.25, 0.5, 0.75]))
def test_binary_functions_match_the_jax_module(name, case, tau):
    targets, scores = case
    kwargs = {} if name in ("mean_auroc", "mean_auprc") else {"tau": tau}
    for preds in (scores, np.stack([1.0 - scores, scores], axis=1),
                  np.stack([scores * 3.0 - 1.0, 2.0 - scores * 5.0], axis=1)):
        # 1-D probabilities, an (N, 2) probability matrix, and (N, 2) logits
        # whose raw column 1 ranks the other way than their softmax.
        ours = _quiet(getattr(perf, name), preds, targets, 2, **kwargs)
        ref = _quiet(getattr(jax_perf, name), preds, targets, 2, **kwargs)
        _close(ours, ref)


@pytest.mark.parametrize("name", _BINARY_FUNCTIONS)
@SETTINGS
@given(case=multiclass_case())
def test_multiclass_functions_match_the_jax_module(name, case):
    targets, logits = case
    _close(_quiet(getattr(perf, name), logits, targets, 3),
           _quiet(getattr(jax_perf, name), logits, targets, 3))


@SETTINGS
@given(case=binary_case(), tau=st.sampled_from([None, 0.3, 0.5]))
def test_binary_metrics_block_matches_the_jax_module(case, tau):
    targets, scores = case
    ours = _quiet(perf.binary_metrics_block, scores, targets, tau=tau, loss=0.25)
    ref = _quiet(jax_perf.binary_metrics_block, scores, targets, tau=tau, loss=0.25)
    assert list(ours) == list(ref)
    for key, value in ref.items():
        assert type(ours[key]) is type(value), key
        _close(ours[key], value)


def test_mean_auroc_ranks_two_column_logits_by_raw_column_one():
    targets = np.array([0, 1, 0, 1])
    logits = np.array([[5.0, 1.0], [0.0, 0.5], [9.0, 2.0], [-1.0, 0.1]])
    # Raw column 1 ranks the negatives first; the softmax would rank them last.
    assert perf.mean_auroc(logits, targets, 2) == 0.0
    assert perf.roc_auc_binary(targets, perf.as_binary_scores(logits)) == 1.0
    assert jax_perf.mean_auroc(logits, targets, 2) == 0.0


def test_single_class_warnings_are_the_jax_module_s():
    targets, scores = np.zeros(3, int), np.array([0.1, 0.5, 0.9])
    with pytest.warns(RuntimeWarning, match="single target class"):
        assert np.isnan(perf.mean_auroc(scores, targets, 2))
    with pytest.warns(RuntimeWarning, match="single target class"):
        block = perf.binary_metrics_block(scores, targets)
    assert np.isnan(block["auroc"]) and block["auprc"] == 0.0

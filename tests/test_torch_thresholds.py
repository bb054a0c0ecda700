"""The port's threshold policies against the JAX package's module, to 1e-12:
every policy, the Youden optimum (whose ROC curve the port writes out in
numpy where the JAX package calls scikit-learn), persistence and the frozen
SUN reuse."""

import json

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from sklearn.metrics import roc_curve

from ssl4polyp_tpu.metrics import thresholds as ref
from ssl4polyp_tpu_torch.metrics import thresholds as ours

SETTINGS = settings(max_examples=150, deadline=None, derandomize=True)
TOL = 1e-12


@st.composite
def scored_case(draw, both_classes=False, max_size=300):
    """Labels and scores in [0, 1] with ties: rounded to 1-3 decimals."""
    n = draw(st.integers(2, max_size))
    seed = draw(st.integers(0, 2 ** 31 - 1))
    decimals = draw(st.integers(1, 3))
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, n)
    if both_classes:
        labels[0], labels[1] = 0, 1
    elif draw(st.booleans()) and draw(st.booleans()):
        labels[:] = labels[0]  # a single-class validation split
    scores = np.round(rng.random(n) ** draw(st.sampled_from([0.3, 1.0, 3.0])), decimals)
    return scores, labels


def _assert_same_result(a, b):
    assert abs(a.tau - b.tau) <= TOL
    assert a.record.keys() == b.record.keys()
    for key, value in b.record.items():
        if key == "metrics":
            assert a.record[key].keys() == value.keys()
            for name in value:
                assert abs(a.record[key][name] - value[name]) <= TOL, name
        elif isinstance(value, float):
            assert abs(a.record[key] - value) <= TOL, key
        else:
            assert a.record[key] == value, key
    assert a.metrics.keys() == b.metrics.keys()
    for name, value in b.metrics.items():
        assert abs(a.metrics[name] - value) <= TOL, name
    np.testing.assert_allclose(a.candidates, b.candidates, rtol=0, atol=TOL)


@SETTINGS
@given(case=scored_case(), policy=st.sampled_from(ours.SUPPORTED_POLICIES),
       previous=st.sampled_from([None, 0.3, float("nan")]))
def test_every_policy_equals_the_jax_modules(case, policy, previous):
    scores, labels = case
    kwargs = dict(policy=policy, split_name="sun_full/val", epoch=4, previous_tau=previous)
    _assert_same_result(ours.compute_policy_threshold(scores, labels, **kwargs),
                        ref.compute_policy_threshold(scores, labels, **kwargs))


@SETTINGS
@given(case=scored_case(both_classes=True), inputs=st.sampled_from(["probs", "logits"]),
       two_columns=st.booleans())
def test_youden_threshold_equals_the_jax_modules(case, inputs, two_columns):
    scores, labels = case
    if inputs == "logits":
        scores = np.round(8.0 * scores - 4.0, 2)
    if two_columns:
        scores = np.stack([np.zeros_like(scores) if inputs == "logits" else 1.0 - scores, scores],
                          axis=1)
    got = ours.compute_youden_threshold(scores, labels, inputs=inputs)
    assert abs(got - ref.compute_youden_threshold(scores, labels, inputs=inputs)) <= TOL


@SETTINGS
@given(case=scored_case(both_classes=True, max_size=80),
       labelling=st.sampled_from([(0, 1), (-1, 1)]))
def test_roc_curve_equals_scikit_learns(case, labelling):
    scores, labels = case
    labels = np.asarray(labelling)[labels]
    for got, want in zip(ours._roc_curve(labels, scores), roc_curve(labels, scores)):
        np.testing.assert_array_equal(got, want)


def test_youden_edge_cases_raise_or_guard_as_the_jax_module_does():
    for module in (ours, ref):
        with pytest.raises(ValueError, match="outside"):
            module.compute_youden_threshold([0.2, 1.7], [0, 1])
        with pytest.raises(ValueError, match="both classes"):
            module.compute_youden_threshold([0.2, 0.7], [1, 1])
        with pytest.raises(ValueError, match="empty"):
            module.compute_youden_threshold([], [])
        with pytest.raises(ValueError, match="inputs"):
            module.compute_youden_threshold([0.2, 0.7], [0, 1], inputs="scores")
        with pytest.raises(ValueError):
            module.compute_youden_threshold([0.2, 0.7, 0.4], [0, 1, 2])  # not binary
        # The best point is the curve's first, whose threshold is infinite:
        # the guard steps just past the largest score.
        tau = module.compute_youden_threshold([0.9, 0.8, 0.1], [0, 0, 1])
        assert tau == float(np.nextafter(0.9, 1.0))
    with pytest.raises(ValueError, match="Unsupported"):
        ours.compute_policy_threshold([0.1], [1], policy="best", split_name="v", epoch=0)
    with pytest.raises(ValueError, match="empty"):
        ours.compute_policy_threshold([], [], policy="f1_opt_on_val", split_name="v", epoch=0)
    with pytest.raises(ValueError, match="mismatch"):
        ours.compute_policy_threshold([0.1, 0.2], [1], policy="f1_opt_on_val", split_name="v",
                                      epoch=0)


def test_the_candidate_grid_is_capped_as_in_the_jax_module():
    rng = np.random.default_rng(0)
    scores, labels = rng.random(1000), rng.integers(0, 2, 1000)
    kwargs = dict(policy="youden_on_val", split_name="val", epoch=1)
    got = ours.compute_policy_threshold(scores, labels, **kwargs)
    assert got.record["n_candidates"] == ours.MAX_CANDIDATES == ref.MAX_CANDIDATES
    _assert_same_result(got, ref.compute_policy_threshold(scores, labels, **kwargs))


def test_persistence_reads_what_the_jax_module_wrote_and_the_reverse(tmp_path):
    values = {ours.format_threshold_key("SUN_Full", "Val", "F1_opt_on_val"): 0.4125, "other": 1}
    assert list(values)[0] == ref.format_threshold_key("SUN_Full", "Val", "F1_opt_on_val")
    ours.save_thresholds(tmp_path / "a" / "ours.json", values)
    ref.save_thresholds(tmp_path / "ref.json", values, primary=True)
    assert (tmp_path / "a" / "ours.json").read_text() == (tmp_path / "ref.json").read_text()
    assert ref.load_thresholds(tmp_path / "a" / "ours.json") == ours.load_thresholds(
        tmp_path / "ref.json") == {k: float(v) for k, v in values.items()}
    ours.save_thresholds(tmp_path / "skipped.json", values, primary=False)
    assert not (tmp_path / "skipped.json").exists()
    (tmp_path / "flat.json").write_text(json.dumps({"k": 0.5}))  # the bare mapping form
    assert ours.load_thresholds(tmp_path / "flat.json") == {"k": 0.5}
    assert ours.resolve_threshold({"k": 0.5}, "k") == 0.5
    assert ours.resolve_threshold({"k": 0.5}, "missing") is None
    assert ours.resolve_threshold({"k": 0.5}, None) is None


@pytest.mark.parametrize("block, kwargs", [
    ({"primary": {"tau": 0.37, "policy": "f1_opt_on_val", "split": "sun_full/val", "epoch": 6,
                  "notes": {"carried_forward": True}}}, {}),
    ({"primary": {"tau": 0.37, "split": "polypgen/val"}},
     {"checkpoint_path": "run/a.ckpt", "checkpoint_sha256": "ab" * 32}),
    ({"primary": {"tau": 1}, "sensitivity": {"tau": 0.2, "degenerate_val": True}},
     {"source_key": "sensitivity", "expected_split_substring": ""}),
    ({"primary": {"tau": 0.5}}, {"source_key": "missing"}),
])
def test_frozen_sun_threshold_equals_the_jax_modules(block, kwargs):
    assert ours.resolve_frozen_sun_threshold(block, **kwargs) == ref.resolve_frozen_sun_threshold(
        block, **kwargs)


@pytest.mark.parametrize("block, error", [
    ({"other": {"tau": 0.5}}, KeyError), ({"primary": {"tau": float("nan")}}, ValueError),
    ({"primary": {"tau": "0.5"}}, ValueError), ([], ValueError),
])
def test_frozen_sun_threshold_refuses_what_the_jax_module_refuses(block, error):
    for module in (ours, ref):
        with pytest.raises(error):
            module.resolve_frozen_sun_threshold(block)

"""The port's process group and rank-0 gating (``ssl4polyp_tpu_torch/parallel``).

``tests/test_multihost.py``'s checks of the JAX package, ported: every
writer turns into a no-op on a rank past 0 (``primary=False``, what the
engines pass there) while its return values (paths, digests) stay rank 0's;
every CLI calls ``initialize_multihost``; and the padded-stripe gather of the
eval engine on two real processes under gloo, started as ``torchrun`` starts
them.  Besides: one process needs no group, NCCL refuses ranks that share a
device, the mesh refuses what is not ported, and the collectives on two
ranks.
"""

import inspect

import numpy as np
import pytest
import torch

from ssl4polyp_tpu_torch.parallel import mesh, multihost
from tests.test_torch_parallel import run_ranks


def test_save_checkpoint_skipped(tmp_path):
    from ssl4polyp_tpu_torch.utils.checkpoint import (AsyncCheckpointer, save_checkpoint,
                                                      update_pointer)

    target = tmp_path / "ck.ckpt"
    returned = save_checkpoint(target, {"params": {"w": np.zeros(2)}}, {"epoch": 0},
                               primary=False)
    assert returned == target
    assert not target.exists()
    update_pointer(tmp_path / "last.ckpt", target, primary=False)
    assert not (tmp_path / "last.ckpt").exists()
    writer = AsyncCheckpointer()
    assert writer.save(target, {"params": {"w": np.zeros(2)}}, primary=False) == target
    writer.wait()
    assert list(tmp_path.iterdir()) == [] and writer.last_snapshot_seconds is None


def test_cleanup_skipped(tmp_path):
    from ssl4polyp_tpu_torch.utils.checkpoint import cleanup_checkpoints

    victim = tmp_path / "checkpoint-0.ckpt"
    victim.write_bytes(b"x")
    assert cleanup_checkpoints(tmp_path, keep_last=0, primary=False) == []
    assert victim.exists()


def test_run_logger_silent(tmp_path, capsys):
    from ssl4polyp_tpu_torch.utils.logging import RunLogger

    logger = RunLogger(tmp_path / "runs", "stem", primary=False)
    logger.text("hello")
    logger.json_line({"a": 1})
    logger.scalar("x", 1.0, 0)
    logger.close()
    assert not (tmp_path / "runs").exists()
    assert capsys.readouterr().out == ""


def test_exports_digest_without_write(tmp_path):
    from ssl4polyp_tpu_torch.evaluation import exports

    kwargs = dict(metadata_rows=[{"frame_id": "f0", "case_id": "c0"}], probabilities=[0.7],
                  targets=[1], preds=[1])
    result = exports.export_frame_outputs(tmp_path / "out.csv", primary=False, **kwargs)
    assert not result.path.exists()
    assert len(result.sha256) == 64
    # rank 0's digest, of the bytes it writes
    written = exports.export_frame_outputs(tmp_path / "written.csv", **kwargs)
    assert written.sha256 == result.sha256 == exports.sha256_file(written.path)

    curve_kwargs = dict(probabilities=np.asarray([0.1, 0.9]), targets=np.asarray([0, 1]),
                        grid_points=5)
    curve = exports.export_curve_sets(tmp_path / "stem", "test", primary=False, **curve_kwargs)
    assert not (tmp_path / "stem_test_roc_curve.csv").exists()
    assert len(curve["sha256"]) == 64 and len(curve["pr_sha256"]) == 64
    assert curve == exports.export_curve_sets(tmp_path / "stem", "test", **curve_kwargs)


def test_thresholds_and_snapshot_skipped(tmp_path):
    from ssl4polyp_tpu_torch.configs.manifests import snapshot_provenance
    from ssl4polyp_tpu_torch.metrics.thresholds import save_thresholds

    save_thresholds(tmp_path / "tau.json", {"k": 0.5}, primary=False)
    assert not (tmp_path / "tau.json").exists()
    snapshot_provenance(tmp_path / "snap", [], None, None, primary=False)
    assert not (tmp_path / "snap").exists()


def test_every_cli_initializes_the_group():
    from ssl4polyp_tpu_torch.evaluation import eval_classification
    from ssl4polyp_tpu_torch.training import classification, hyperkvasir, pretrain

    for fn in (classification.cli_main, pretrain.cli_main, eval_classification.cli_main,
               hyperkvasir.main):
        assert "initialize_multihost(" in inspect.getsource(fn), fn.__qualname__


def test_one_process_needs_no_group(monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    multihost.initialize_multihost()  # nothing to join
    monkeypatch.setenv("WORLD_SIZE", "1")
    multihost.initialize_multihost()
    assert not multihost.is_distributed() and multihost.is_primary()
    info = multihost.process_info()
    assert (info["process_index"], info["process_count"], info["backend"]) == (0, 1, None)
    assert multihost.any_rank(True) and not multihost.any_rank(False)
    multihost.barrier()
    assert mesh.build_mesh().shape == {"data": 1, "model": 1}
    tensors = [torch.ones(3)]
    mesh.cross_replica_sum(tensors)
    mesh.cross_replica_mean(tensors)
    assert mesh.replicate({"w": tensors[0]})["w"] is tensors[0]
    assert torch.equal(tensors[0], torch.ones(3))
    batch = {"x": np.arange(6)}
    assert mesh.shard_batch(batch)["x"].tolist() == list(range(6))


def test_nccl_refuses_ranks_that_share_a_device(monkeypatch):
    # More ranks on this host than CUDA devices: refused before any
    # rendezvous, naming gloo; nothing falls back in silence.
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="gloo"):
        multihost.initialize_multihost("tcp://127.0.0.1:1", world_size=2, rank=0,
                                       backend="nccl")
    monkeypatch.setenv(multihost.BACKEND_ENV, "nccl")
    with pytest.raises(ValueError, match="2 ranks on this host, 1 devices"):
        multihost.initialize_multihost("tcp://127.0.0.1:1", world_size=2, rank=0)
    assert not multihost.is_distributed()


def test_local_device(monkeypatch):
    assert multihost.local_device("cpu") == torch.device("cpu")
    assert multihost.local_device("cuda:1") == torch.device("cuda", 1)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert multihost.local_device() == torch.device("cuda", 1)
    monkeypatch.delenv("LOCAL_RANK")
    assert multihost.local_device() == torch.device("cuda", 0)


def test_mesh_refuses_what_is_not_ported():
    with pytest.raises(ValueError, match="model=1"):
        mesh.build_mesh(model=2)
    with pytest.raises(ValueError, match="world of 1"):
        mesh.build_mesh(data=2)
    with pytest.raises(TypeError, match="fp32"):
        mesh._flat_collective([torch.ones(2, dtype=torch.bfloat16)], lambda flat: None)


def _rank_group():
    """The eval engine's gather contract (``evaluation/evaluate.py``): each
    rank holds a disjoint stripe padded to one shape with ``valid=False``
    rows; after the all-gather and the valid filter every rank holds every
    frame.  And the mesh's collectives and ``shard_batch`` on two ranks."""
    from ssl4polyp_tpu_torch.evaluation.evaluate import _all_gather

    multihost.initialize_multihost()  # from torchrun's variables alone
    info = multihost.process_info()
    pid = info["process_index"]
    stripe = np.arange(pid * 3, pid * 3 + 3, dtype=np.int32)  # positions
    logits = stripe.astype(np.float32) * 0.5
    valid = np.array([True, True, pid == 0])  # rank 1's last row is padding
    logits, stripe, valid = (_all_gather(a) for a in (logits, stripe, valid))
    summed = [torch.full((2, 3), float(pid + 1)), torch.tensor(float(pid))]
    mesh.cross_replica_sum(summed)
    averaged = [torch.full((4,), float(pid + 1))]
    mesh.cross_replica_mean(averaged)
    replicated = mesh.replicate({"w": torch.full((3,), float(pid + 7))})
    return {"info": info, "primary": multihost.is_primary(), "frames": stripe[valid].tolist(),
            "logits": logits[valid].tolist(), "sum": [t.tolist() for t in summed],
            "mean": averaged[0].tolist(), "replicated": replicated["w"].tolist(),
            "any": [multihost.any_rank(pid == 1), multihost.any_rank(False)],
            "shard": mesh.shard_batch({"x": np.arange(8).reshape(4, 2)})["x"].tolist(),
            "mesh": mesh.build_mesh(data=2).shape}


def test_two_process_group_and_gather_contract(tmp_path):
    ranks = run_ranks("tests.test_torch_multihost:_rank_group", tmp_path)
    for pid, out in enumerate(ranks):
        assert out["info"]["process_index"] == pid and out["info"]["process_count"] == 2
        assert out["info"]["backend"] == "gloo" and out["primary"] == (pid == 0)
        assert out["frames"] == [0, 1, 2, 3, 4]
        assert out["logits"] == [0.0, 0.5, 1.0, 1.5, 2.0]
        assert out["sum"] == [[[3.0] * 3] * 2, 1.0]
        assert out["mean"] == [1.5] * 4
        assert out["replicated"] == [7.0] * 3  # rank 0's
        assert out["any"] == [True, False]
        assert out["shard"] == ([[0, 1], [2, 3]] if pid == 0 else [[4, 5], [6, 7]])
        assert out["mesh"] == {"data": 2, "model": 1}

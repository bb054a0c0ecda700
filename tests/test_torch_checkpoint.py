"""The port's checkpoint files against the JAX package's: the msgpack codec
byte for byte against flax's serializer, files written by either package
read by the other, the pointer, retention and the async writer."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from flax import serialization

from ssl4polyp_tpu.utils import checkpoint as jax_ckpt
from ssl4polyp_tpu_torch.utils import checkpoint as ckpt
from ssl4polyp_tpu_torch.utils import msgpack

ROOT = Path(__file__).resolve().parents[1]


def _document(seed=0):
    """Parameters, optimizer moments and a meta block, as a fine-tune run
    writes them: nested dicts, fp32 matrices, a 0-d count, a uint32 key,
    numpy scalars, and JSON-safe meta with None, bools, ints, floats, lists
    and strings past every msgpack length class used in practice."""
    rng = np.random.default_rng(seed)
    params = {
        "patch_embed": {"kernel": rng.standard_normal((48, 32)).astype(np.float32),
                        "bias": np.zeros(32, np.float32)},
        "blocks": {"attn": {"qkv": {"kernel": rng.standard_normal((2, 32, 96)).astype(np.float32)}}},
        "cls_token": rng.standard_normal((1, 1, 32)).astype(np.float32),
        "head": {"kernel": rng.standard_normal((32, 2)).astype(np.float32)},
    }
    moments = {"mu": {k: np.zeros_like(v) if isinstance(v, np.ndarray) else v
                      for k, v in params.items() if k == "cls_token"},
               "nu": {"cls_token": rng.random((1, 1, 32))},  # float64
               "count": np.asarray(7, np.int32)}
    payload = {"params": params, "opt": moments, "key": np.array([1, 2 ** 31 + 5], np.uint32),
               "best": np.float32(0.75), "steps": np.int64(-12345678901),
               "flags": np.array([True, False]), "empty": np.zeros((0, 3), np.float16),
               "history": [0.5, 1, None, "x", [np.arange(3)]]}
    meta = {"epoch": 3, "step": 2 ** 33, "neg": -40000, "monitor": 0.123456789, "resumed": False,
            "note": None, "model_cfg": {"embed_dim": 32, "depth": 2, "pos_embed": "learned",
                                        "pad_tokens_to": 0, "num_classes": 2},
            "thresholds": {"primary": {"tau": 0.41, "policy": "f1_opt_on_val",
                                       "split": "sun_full/val", "notes": {}},
                           "values": {"sun_full_val_f1_opt_on_val": 0.41}},
            "long": "é" * 300, "many": list(range(40)), "blob": b"\x00\x01" * 200}
    return {"payload": payload, "meta": meta}


def _assert_same_tree(a, b):
    assert type(a) is type(b) or (isinstance(a, np.generic) and isinstance(b, np.generic)), (a, b)
    if isinstance(a, dict):
        assert list(a) == list(b)
        for key in a:
            _assert_same_tree(a[key], b[key])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same_tree(x, y)
    elif isinstance(a, (np.ndarray, np.generic)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def test_packb_gives_flaxs_bytes_and_unpackb_reads_them():
    document = _document()
    ours = msgpack.packb(document)
    assert ours == serialization.msgpack_serialize(document)
    _assert_same_tree(msgpack.unpackb(ours), serialization.msgpack_restore(ours))


@pytest.mark.parametrize("value", [
    0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 63, -1, -32, -33, -128, -129,
    -32768, -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63, 1.5, float("inf"), True, None, "", "a" * 31,
    "a" * 32, "a" * 255, "a" * 256, "a" * 65536, b"", b"x" * 256, [], list(range(15)),
    list(range(16)), {str(i): i for i in range(16)}, {"b": 1, "a": {"d": 2, "c": 3}},
    1 + 2j, np.float64(2.5), np.bool_(True), np.arange(4, dtype=np.int8).reshape(2, 2),
    np.asarray(3.0), np.zeros(1, np.float32), np.zeros(2, np.float32), np.zeros(5, np.uint8),
], ids=repr)
def test_every_msgpack_form_of_the_subset_matches_flax(value):
    document = {"payload": {"x": value}, "meta": {}}
    ours = msgpack.packb(document)
    assert ours == serialization.msgpack_serialize(document)
    _assert_same_tree(msgpack.unpackb(ours), serialization.msgpack_restore(ours))


def test_what_the_format_does_not_hold_is_refused_not_mis_written(monkeypatch):
    with pytest.raises(TypeError):
        msgpack.packb({"x": (1, 2)})  # flax's writer refuses tuples too
    with pytest.raises(TypeError):
        msgpack.packb({"x": object()})
    with pytest.raises(ValueError):
        msgpack.packb({"x": np.array([object()])})
    with pytest.raises(ValueError, match="truncated"):
        msgpack.unpackb(msgpack.packb({"x": np.arange(9)})[:-3])
    with pytest.raises(ValueError, match="follow"):
        msgpack.unpackb(msgpack.packb({"x": 1}) + b"\x00")
    with pytest.raises(ValueError, match="extension type 9"):
        msgpack.unpackb(b"\xd4\x09\x00")
    # Above the chunk limit flax writes a chunked form: read here, and refused
    # on write (the limit lowered so that the test stays small).
    big = np.arange(1000, dtype=np.float32).reshape(10, 100)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 1024)
    chunked = serialization.msgpack_serialize({"payload": {"w": big, "b": np.ones(3)}})
    restored = msgpack.unpackb(chunked)
    np.testing.assert_array_equal(restored["payload"]["w"], big)
    np.testing.assert_array_equal(restored["payload"]["b"], np.ones(3))
    monkeypatch.setattr(msgpack, "MAX_CHUNK_SIZE", 1024)
    with pytest.raises(NotImplementedError, match="chunk"):
        msgpack.packb({"w": big})


def test_bfloat16_arrays_round_trip_where_numpy_knows_the_dtype():
    ml_dtypes = pytest.importorskip("ml_dtypes")
    array = np.arange(6, dtype=np.float32).astype(ml_dtypes.bfloat16).reshape(2, 3)
    ours = msgpack.packb({"w": array})
    assert ours == serialization.msgpack_serialize({"w": array})
    restored = msgpack.unpackb(ours)["w"]
    assert restored.dtype == array.dtype
    np.testing.assert_array_equal(restored.astype(np.float32), array.astype(np.float32))


@pytest.mark.parametrize("writer, reader", [(jax_ckpt, ckpt), (ckpt, jax_ckpt), (ckpt, ckpt)],
                         ids=["jax-to-port", "port-to-jax", "port-to-port"])
def test_a_file_written_by_either_package_is_read_by_the_other(tmp_path, writer, reader):
    document = _document(1)
    path = writer.save_checkpoint(tmp_path / "ck.ckpt", document["payload"], document["meta"])
    restored = reader.load_checkpoint(path)
    # Both writers snapshot every leaf with a shape to an array first, so a
    # numpy scalar comes back as a 0-d array.
    reference = serialization.msgpack_restore(serialization.msgpack_serialize(
        {"payload": jax_ckpt._to_numpy(document["payload"]), "meta": document["meta"]}))
    _assert_same_tree(restored, reference)
    meta = dict(document["meta"], blob=str(document["meta"]["blob"]))  # the sidecar is JSON
    assert reader.load_checkpoint_meta(path) == meta
    assert not list(tmp_path.glob("*.tmp"))


def test_the_two_writers_give_the_same_file(tmp_path):
    document = _document(2)
    a = jax_ckpt.save_checkpoint(tmp_path / "a.ckpt", document["payload"], document["meta"])
    b = ckpt.save_checkpoint(tmp_path / "b.ckpt", document["payload"], document["meta"])
    assert a.read_bytes() == b.read_bytes()
    assert Path(str(a) + ".json").read_text() == Path(str(b) + ".json").read_text()


def test_torch_tensors_are_saved_as_their_arrays(tmp_path):
    weights = torch.arange(6.0).reshape(2, 3)
    payload = {"params": {"w": weights, "steps": [torch.tensor(3)]}}
    path = ckpt.save_checkpoint(tmp_path / "t.ckpt", payload, {"epoch": 1})
    restored = jax_ckpt.load_checkpoint(path)["payload"]["params"]
    np.testing.assert_array_equal(restored["w"], np.arange(6.0, dtype=np.float32).reshape(2, 3))
    assert restored["w"].dtype == np.float32 and restored["steps"][0] == 3
    assert ckpt.save_checkpoint(tmp_path / "skipped.ckpt", {}, primary=False).exists() is False


def test_pointer_is_replaced_atomically(tmp_path, monkeypatch):
    a = ckpt.save_checkpoint(tmp_path / "a.ckpt", {"x": np.ones(2)}, {"tag": "a"})
    pointer = tmp_path / "last.ckpt"
    ckpt.update_pointer(pointer, a)
    assert pointer.is_symlink() and os.readlink(pointer) == "a.ckpt"  # relative: same directory
    assert ckpt.load_checkpoint(pointer)["meta"]["tag"] == "a"
    b = ckpt.save_checkpoint(tmp_path / "b.ckpt", {"x": np.zeros(2)}, {"tag": "b"})

    # The old pointer stays in place until os.replace moves the new one over
    # it: no unlink of the pointer, so no moment without one.
    calls = []
    real_replace = os.replace

    def replace(src, dst):
        assert Path(dst) == pointer and pointer.exists()
        assert ckpt.load_checkpoint(pointer)["meta"]["tag"] == "a"
        assert ckpt.load_checkpoint(src)["meta"]["tag"] == "b"
        calls.append((src, dst))
        real_replace(src, dst)

    monkeypatch.setattr(ckpt.os, "replace", replace)
    monkeypatch.setattr(Path, "unlink", lambda self, missing_ok=False: (
        pytest.fail("the pointer was unlinked") if self == pointer else None))
    ckpt.update_pointer(pointer, b)
    assert len(calls) == 1
    assert ckpt.load_checkpoint(pointer)["meta"]["tag"] == "b"
    assert sorted(p.name for p in tmp_path.iterdir() if "last" in p.name) == ["last.ckpt"]
    ckpt.update_pointer(tmp_path / "unwritten.ckpt", b, primary=False)
    assert not (tmp_path / "unwritten.ckpt").exists()
    # The JAX package follows the port's pointer.
    assert jax_ckpt.load_checkpoint(pointer)["meta"]["tag"] == "b"


def test_pointer_falls_back_to_a_copy_where_symlinks_fail(tmp_path, monkeypatch):
    a = ckpt.save_checkpoint(tmp_path / "a.ckpt", {"x": np.ones(2)}, {"tag": "a"})

    def refuse(self, target):
        raise OSError("no symlinks here")

    monkeypatch.setattr(Path, "symlink_to", refuse)
    ckpt.update_pointer(tmp_path / "last.ckpt", a)
    assert not (tmp_path / "last.ckpt").is_symlink()
    assert ckpt.load_checkpoint(tmp_path / "last.ckpt")["meta"]["tag"] == "a"


def test_retention_keeps_the_last_and_the_one_based_milestones(tmp_path):
    for epoch in range(10):
        ckpt.save_checkpoint(tmp_path / f"checkpoint-{epoch}.ckpt", {"e": np.asarray(epoch)}, {})
    assert ckpt.cleanup_checkpoints(tmp_path, keep_last=2, keep_every_n_epochs=4,
                                    primary=False) == []
    removed = ckpt.cleanup_checkpoints(tmp_path, keep_last=2, keep_every_n_epochs=4)
    kept = sorted(p.name for p in tmp_path.glob("checkpoint-*.ckpt"))
    # (epoch + 1) % 4 == 0: the pretrain engine saves on completed-epoch counts.
    assert kept == ["checkpoint-3.ckpt", "checkpoint-7.ckpt", "checkpoint-8.ckpt",
                    "checkpoint-9.ckpt"]
    assert len(removed) == 6
    assert sorted(p.name for p in tmp_path.glob("*.json")) == [k + ".json" for k in kept]


def test_async_checkpointer_orders_snapshots_and_surfaces_errors(tmp_path, monkeypatch):
    saver = ckpt.AsyncCheckpointer()
    events = []
    weights = torch.arange(5.0)
    monkeypatch.setattr(ckpt, "_WRITE_DELAY_S", 0.2)
    saver.save(tmp_path / "ck-1.ckpt", {"params": {"w": weights}}, {"epoch": 1},
               pointer=tmp_path / "last.ckpt",
               cleanup=lambda: events.append((tmp_path / "ck-1.ckpt").exists()))
    weights += 100.0  # the train step updates in place while the writer runs
    saver.wait()
    monkeypatch.setattr(ckpt, "_WRITE_DELAY_S", 0.0)
    assert events == [True]  # the callback ran after the rename
    restored = ckpt.load_checkpoint(tmp_path / "last.ckpt")
    np.testing.assert_array_equal(restored["payload"]["params"]["w"], np.arange(5.0))
    assert restored["meta"]["epoch"] == 1 and saver.last_write_seconds is not None
    assert not list(tmp_path.glob("*.tmp"))

    saver.save(tmp_path / "x.ckpt", {"bad": object()}, {})  # unserializable
    with pytest.raises(TypeError):
        saver.wait()
    saver.save(tmp_path / "y.ckpt", {"params": {"w": np.ones(1)}}, {})  # still usable
    saver.wait()
    assert (tmp_path / "y.ckpt").exists()


def test_async_crash_safety(tmp_path):
    """A process killed mid-write leaves the previous checkpoint and the
    pointer intact: the atomic rename is the commit point."""
    child = f"""
import os, sys, time
import numpy as np
from ssl4polyp_tpu_torch.utils import checkpoint as ck

out = {str(tmp_path)!r}
ck.save_checkpoint(os.path.join(out, "checkpoint-1.ckpt"),
                   {{"params": {{"w": np.arange(3.0)}}}}, {{"epoch": 1}})
ck.update_pointer(os.path.join(out, "last.ckpt"), os.path.join(out, "checkpoint-1.ckpt"))
ck._WRITE_DELAY_S = 60.0  # park the writer between .tmp and the rename
saver = ck.AsyncCheckpointer()
saver.save(os.path.join(out, "checkpoint-2.ckpt"),
           {{"params": {{"w": np.arange(3.0) + 1}}}}, {{"epoch": 2}},
           pointer=os.path.join(out, "last.ckpt"))
time.sleep(1.0)  # let the thread write the .tmp
print("MIDWRITE", flush=True)
os._exit(1)  # hard crash mid-save
"""
    result = subprocess.run([sys.executable, "-c", child], cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, timeout=300)
    assert "MIDWRITE" in result.stdout, result.stdout
    assert result.returncode == 1
    assert not (tmp_path / "checkpoint-2.ckpt").exists()  # never committed
    restored = ckpt.load_checkpoint(tmp_path / "last.ckpt")
    assert restored["meta"]["epoch"] == 1
    np.testing.assert_array_equal(restored["payload"]["params"]["w"], np.arange(3.0))

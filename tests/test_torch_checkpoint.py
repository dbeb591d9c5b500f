"""The port's checkpoint manager (``repro_torch.checkpoint``) and
``reshard_checkpoint``: the reference's own tests of them
(``tests/test_substrate.py``, ``tests/test_elastic.py``) ported to trees
of tensors, and checkpoint directories read across the two packages in
both directions, with the same keys and the same leaf bytes, for dict,
list, tuple, NamedTuple and dataclass trees of f32, int32, int64, bool and
bf16 leaves. The reference writes a bf16 leaf as raw 2-byte words (numpy
``V2``) and cannot cast it back (ROADMAP F7, pinned below); the port
restores such a leaf by reinterpreting its bytes."""

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jck

from repro_torch import checkpoint as tck
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    load_checkpoint, restore_into,
                                    save_checkpoint)
from repro_torch.distributed import reshard_checkpoint


def _tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones((2,), dtype=torch.int32)},
            "l": [torch.zeros(3), torch.full((2, 2), 7.0)]}


def _leaves(tree):
    return [v for _, v in tck.manager._flatten(tree)]


def test_checkpoint_roundtrip(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 5, t, {"note": "x"})
    arrays, meta = load_checkpoint(str(tmp_path))
    assert meta["step"] == 5 and meta["note"] == "x"
    out = restore_into(t, arrays)
    assert sorted(out) == sorted(t) and isinstance(out["l"], list)
    for a, b in zip(_leaves(t), _leaves(out)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_latest_and_gc(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        ck.save(s, _tree())
    ck.wait()
    assert latest_step(str(tmp_path)) == 3
    steps = sorted(int(p.name.split("_")[1])
                   for p in tmp_path.glob("step_*"))
    assert steps == [2, 3]
    assert latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "none"))


def test_async_save_error_surfaces_on_wait(tmp_path, monkeypatch):
    """A failed background save raises on the caller's thread at the next
    wait(), once."""
    from repro_torch.checkpoint import manager

    def boom(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(manager, "save_checkpoint", boom)
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    ck.save(1, _tree())
    with pytest.raises(OSError, match="disk full"):
        ck.wait()
    ck.wait()                      # error raises once, then clears


def test_async_save_does_not_capture_base_exceptions(tmp_path, monkeypatch):
    """SystemExit / KeyboardInterrupt in the writer are not kept as a
    deferred save error."""
    from repro_torch.checkpoint import manager

    def bail(*a, **kw):
        raise SystemExit(3)

    monkeypatch.setattr(manager, "save_checkpoint", bail)
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    ck.save(1, _tree())
    ck.wait()                      # no deferred error raised
    assert ck._error is None


def test_async_snapshot_is_taken_at_save(tmp_path):
    """Writes to the tensors after ``save`` returns do not reach the
    checkpoint."""
    t = _tree()
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(1, t)
    t["a"].add_(100.0)
    ck.wait()
    arrays, _ = load_checkpoint(str(tmp_path))
    np.testing.assert_array_equal(arrays["a"],
                                  np.arange(12.0).reshape(3, 4))


def test_reshard_checkpoint_roundtrip(tmp_path):
    tree = {"w": torch.arange(64.0).reshape(8, 8), "b": torch.ones(4)}
    save_checkpoint(str(tmp_path), 1, tree)
    arrays, _ = load_checkpoint(str(tmp_path))
    out = reshard_checkpoint(
        arrays, lambda: {"w": torch.zeros((8, 8)), "b": torch.zeros(4)})
    assert torch.equal(out["w"], tree["w"])
    assert torch.equal(out["b"], tree["b"])


def test_restore_errors(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"w": torch.zeros(3)})
    arrays, _ = load_checkpoint(str(tmp_path))
    with pytest.raises(KeyError, match="checkpoint missing leaf v"):
        restore_into({"v": torch.zeros(3)}, arrays)
    with pytest.raises(ValueError, match="w: shape"):
        restore_into({"w": torch.zeros(4)}, arrays)
    # dtype and device follow the template
    out = restore_into({"w": torch.zeros(3, dtype=torch.float64)}, arrays)
    assert out["w"].dtype == torch.float64


class Pair(NamedTuple):
    x: object
    y: object


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Slab:
    rows: object
    scale: object


_VALUES = {
    "f32": np.linspace(-2, 2, 12, dtype=np.float32).reshape(3, 4),
    "i32": np.arange(-3, 3, dtype=np.int32),
    "i64": np.arange(5, dtype=np.int64) * (1 << 40),
    "bool": np.array([True, False, True]),
    "bf16": np.array([1.0, -2.5, 3.140625, 1e-3, 65280.0], np.float32),
}


def _ref_leaf(kind):
    v = _VALUES[kind]
    return np.asarray(jnp.asarray(v, jnp.bfloat16)) if kind == "bf16" else v


def _port_leaf(kind):
    v = torch.as_tensor(_VALUES[kind])
    return v.to(torch.bfloat16) if kind == "bf16" else v


def _shape(kind, leaf):
    """The same structure in each form, with ``leaf(kind)`` leaves."""
    k = kind
    return {
        "dict": lambda: {"w": leaf(k), "opt": {"m": leaf(k), "n": leaf(k)}},
        "list": lambda: [leaf(k), [leaf(k), leaf(k)]],
        "tuple": lambda: (leaf(k), (leaf(k),), {"z": leaf(k)}),
        "namedtuple": lambda: Pair(leaf(k), Pair(leaf(k), None)),
        "dataclass": lambda: {"s": Slab(leaf(k), [leaf(k)])},
    }


KINDS = ["f32", "i32", "i64", "bool", "bf16"]
SHAPES = ["dict", "list", "tuple", "namedtuple", "dataclass"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_same_keys_and_bytes_both_ways(tmp_path, kind, shape):
    """Each package writes the same tree: the same keys and leaf bytes,
    and each reads the other's directory."""
    jtree = _shape(kind, _ref_leaf)[shape]()
    ttree = _shape(kind, _port_leaf)[shape]()
    jck.save_checkpoint(str(tmp_path / "ref"), 3, jtree)
    save_checkpoint(str(tmp_path / "port"), 3, ttree)
    ja, jm = jck.load_checkpoint(str(tmp_path / "ref"))
    ta, tm = load_checkpoint(str(tmp_path / "port"))
    assert jm == tm == {"step": 3}
    assert list(ja) == list(ta)
    for key in ja:
        assert ja[key].dtype == ta[key].dtype, key
        assert ja[key].shape == ta[key].shape, key
        assert ja[key].tobytes() == ta[key].tobytes(), key
    # the port reads the reference's directory and its own alike
    for arrays in (ja, *load_checkpoint(str(tmp_path / "ref"))[:1]):
        out = restore_into(ttree, arrays)
        for a, b in zip(_leaves(ttree), _leaves(out)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert type(out) is type(ttree)
    # the reference reads the port's directory (all but bf16: F7)
    if kind != "bf16":
        got = jck.restore_into(jtree, jck.load_checkpoint(
            str(tmp_path / "port"))[0])
        for a, b in zip(jax.tree.leaves(jtree), jax.tree.leaves(got)):
            np.testing.assert_array_equal(np.asarray(b),
                                          np.asarray(a).astype(
                                              np.asarray(b).dtype))


def test_bf16_restore_fault_is_real(tmp_path):
    """F7 as the reference has it: it writes a bf16 leaf as raw ``V2``
    words and its ``restore_into`` cannot cast them back, from its own
    directory or from the port's."""
    tree = {"w": jnp.asarray([1.0, -2.5], jnp.bfloat16)}
    jck.save_checkpoint(str(tmp_path / "ref"), 1, tree)
    save_checkpoint(str(tmp_path / "port"), 1,
                    {"w": torch.tensor([1.0, -2.5]).to(torch.bfloat16)})
    for sub in ("ref", "port"):
        arrays, _ = jck.load_checkpoint(str(tmp_path / sub))
        assert arrays["w"].dtype.kind == "V"
        with pytest.raises(ValueError, match="No cast function"):
            jck.restore_into(tree, arrays)
    out = restore_into({"w": torch.zeros(2, dtype=torch.bfloat16)},
                       load_checkpoint(str(tmp_path / "ref"))[0])
    assert torch.equal(out["w"], torch.tensor([1.0, -2.5]).to(
        torch.bfloat16))


def test_bf16_leaf_into_other_dtypes(tmp_path):
    """A V2 leaf is bf16 bytes: restored into an f32 tensor or a numpy
    template it is upcast exactly."""
    v = torch.tensor([1.0, -2.5, 3.140625]).to(torch.bfloat16)
    save_checkpoint(str(tmp_path), 1, {"w": v})
    arrays, _ = load_checkpoint(str(tmp_path))
    out = restore_into({"w": torch.zeros(3)}, arrays)
    assert torch.equal(out["w"], v.float())
    out = restore_into({"w": np.zeros(3, np.float32)}, arrays)
    np.testing.assert_array_equal(out["w"], v.float().numpy())

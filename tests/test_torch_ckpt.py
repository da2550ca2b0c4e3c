"""``repro_torch.ckpt`` against the reference's ``repro.ckpt``: the same
on-disk layout, byte for byte.

Trees hold nested dicts and lists (a dict key ``"0"`` beside a sequence
index 0), f32 with ±inf, ±0 and a NaN payload, bf16 bit patterns with NaN
payloads, ±0 and ±inf, int32 with the ``NEVER`` sentinel, empty arrays and
a 0-d f32 −0.0. Both packages write the same npz keys, the same bytes per
array and the same JSON meta, and each restores the other's file bitwise. Version,
tree-set, keypath, dtype and shape disagreements raise
``CheckpointMismatchError``; ``prune``, ``latest`` and ``list`` behave as the
reference's; the params-only pair reads across packages too.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ml_dtypes

from repro import ckpt as jckpt
from repro_torch import ckpt
from repro_torch.core.state import NEVER

BF16_SPECIALS = np.asarray([0x7FC1, 0xFFC3, 0x8000, 0x0000, 0x7F80, 0xFF80, 0x3F80,
                            0x0001], np.uint16)


def numpy_tree(seed: int = 0) -> dict:
    """The reference's view: numpy leaves, bf16 as ``ml_dtypes.bfloat16``."""
    rng = np.random.default_rng(seed)
    f32 = rng.normal(size=(3, 4)).astype(np.float32)
    f32[0, :3] = [np.inf, -np.inf, -0.0]
    f32.view(np.uint32)[0, 3] = 0x7FC01234      # a NaN with a payload
    bits = np.concatenate([BF16_SPECIALS,
                           rng.integers(0, 1 << 16, size=9).astype(np.uint16)])
    ints = rng.integers(-5, 50, size=7).astype(np.int32)
    ints[[1, 4]] = NEVER
    return {
        "params": {"w": f32, "b": bits.view(ml_dtypes.bfloat16)},
        "state": [ints, np.zeros((0, 3), np.float32), {"0": np.float32(-0.0)}],
        "0": np.arange(4, dtype=np.uint8),
    }


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_torch(v) for v in tree]
    a = np.asarray(tree)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def leaf_bytes(x) -> bytes:
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy().tobytes()
    return np.asarray(x).tobytes()


def assert_same_leaves(got, want):
    """Equal structure, dtypes and bytes (NaN payloads included)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want)
        for k in want:
            assert_same_leaves(got[k], want[k])
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            assert_same_leaves(g, w)
    else:
        assert type(got) is type(want) or isinstance(got, np.ndarray), (type(got), type(want))
        assert tuple(np.shape(got)) == tuple(np.shape(want))
        assert str(got.dtype).replace("torch.", "") == str(want.dtype).replace("torch.", "")
        assert leaf_bytes(got) == leaf_bytes(want)


META = {"engine": "sync/flat", "np_rng_state": np.random.default_rng(5).bit_generator.state,
        "extra": {"clock": {"now": 1.5, "events": []}}}


def arrays():
    return {"metric": np.asarray([0.1, 0.2], np.float64),
            "selected_history": np.asarray([[1, 0, 1]], np.uint8)}


@pytest.fixture()
def both(tmp_path):
    """One round written by each package from the same tree."""
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jckpt.save_federated_round(jdir, round_idx=3, trees={"run": numpy_tree()},
                               arrays=arrays(), meta=META)
    ckpt.save_federated_round(tdir, round_idx=3, trees={"run": to_torch(numpy_tree())},
                              arrays=arrays(), meta=META)
    return jdir, tdir


def test_same_npz_keys_bytes_and_meta(both):
    jdir, tdir = both
    jz = np.load(os.path.join(jdir, "fedround_00000003.npz"))
    tz = np.load(os.path.join(tdir, "fedround_00000003.npz"))
    assert sorted(jz.files) == sorted(tz.files)
    assert "tree:run/d:0" in tz.files and "tree:run/d:state/s:2/d:0" in tz.files
    for key in jz.files:
        assert jz[key].dtype == tz[key].dtype, key
        assert jz[key].shape == tz[key].shape, key
        assert jz[key].tobytes() == tz[key].tobytes(), key
    with open(os.path.join(jdir, "fedround_00000003.json")) as f:
        jmeta = json.load(f)
    with open(os.path.join(tdir, "fedround_00000003.json")) as f:
        tmeta = json.load(f)
    assert jmeta == tmeta
    assert tmeta["schema"]["trees"]["run"]["d:params/d:b"] == "bfloat16"
    assert tmeta["format_version"] == ckpt.FORMAT_VERSION == jckpt.FORMAT_VERSION


@pytest.mark.parametrize("reader", ["torch", "jax"])
def test_each_package_restores_the_others_file(both, reader):
    jdir, tdir = both
    if reader == "torch":
        trees, arrs, meta = ckpt.restore_federated_round(
            jdir, likes={"run": to_torch(numpy_tree(seed=9))})
        assert_same_leaves(trees["run"], to_torch(numpy_tree()))
    else:
        trees, arrs, meta = jckpt.restore_federated_round(
            tdir, likes={"run": numpy_tree(seed=9)})
        assert_same_leaves(jax_to_numpy(trees["run"]), numpy_tree())
    np.testing.assert_array_equal(arrs["metric"], arrays()["metric"])
    assert meta["np_rng_state"] == META["np_rng_state"]
    assert meta["round"] == 3


def jax_to_numpy(tree):
    if isinstance(tree, dict):
        return {k: jax_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [jax_to_numpy(v) for v in tree]
    return np.asarray(tree)


def test_restore_onto_the_device_of_the_template(both):
    _, tdir = both
    like = to_torch(numpy_tree())
    trees, _, _ = ckpt.restore_federated_round(tdir, likes={"run": like})
    assert trees["run"]["params"]["w"].device == like["params"]["w"].device
    assert trees["run"]["params"]["b"].dtype == torch.bfloat16


def _rewrite_meta(path, fn):
    fp = os.path.join(path, "fedround_00000003.json")
    with open(fp) as f:
        meta = json.load(f)
    fn(meta)
    with open(fp, "w") as f:
        json.dump(meta, f)


def _like_wrong_dtype():
    t = to_torch(numpy_tree())
    t["params"]["b"] = t["params"]["b"].to(torch.float32)
    return {"run": t}


def _like_wrong_key():
    t = to_torch(numpy_tree())
    t["params"]["w2"] = t["params"].pop("w")
    return {"run": t}


def _like_wrong_shape():
    t = to_torch(numpy_tree())
    t["params"]["w"] = torch.zeros(4, 3)
    return {"run": t}


def _like_list_for_dict():
    t = to_torch(numpy_tree())
    t["state"][2] = [t["state"][2]["0"]]    # s:0 where the file has d:0
    return {"run": t}


MISMATCHES = {
    "version": (lambda m: m.update(format_version=2), None, "format version"),
    "unknown tree": (None, lambda: {}, "did not ask for"),
    "missing tree": (None, lambda: {"run": to_torch(numpy_tree()), "more": {}},
                     "missing required tree"),
    "keypath": (None, _like_wrong_key, "keypaths disagree"),
    "dict key vs index": (None, _like_list_for_dict, "keypaths disagree"),
    "dtype": (None, _like_wrong_dtype, "dtype"),
    "shape": (None, _like_wrong_shape, "shape"),
}


@pytest.mark.parametrize("case", list(MISMATCHES))
@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_mismatches_are_loud(both, case, writer):
    jdir, tdir = both
    path = tdir if writer == "torch" else jdir
    edit, likes, match = MISMATCHES[case]
    if edit is not None:
        _rewrite_meta(path, edit)
    likes = likes() if likes is not None else {"run": to_torch(numpy_tree())}
    with pytest.raises(ckpt.CheckpointMismatchError, match=match):
        ckpt.restore_federated_round(path, likes=likes)


def test_optional_and_subset_restores(both):
    _, tdir = both
    trees, _, _ = ckpt.restore_federated_round(
        tdir, likes={"run": to_torch(numpy_tree()), "aggregator_state": {}},
        optional=("aggregator_state",))
    assert set(trees) == {"run"}
    ckpt.save_federated_round(tdir, round_idx=4, arrays={}, meta={},
                              trees={"run": to_torch(numpy_tree()), "x": [torch.ones(2)]})
    trees, _, _ = ckpt.restore_federated_round(tdir, likes={"x": [torch.zeros(2)]},
                                               subset=True)
    assert torch.equal(trees["x"][0], torch.ones(2))


def test_prune_latest_and_list_match_reference(tmp_path):
    tree = {"a": np.arange(3, dtype=np.float32)}
    dirs = {"torch": str(tmp_path / "t"), "jax": str(tmp_path / "j")}
    for r in (0, 1, 2, 5, 7):
        ckpt.save_federated_round(dirs["torch"], round_idx=r, trees={"t": to_torch(tree)},
                                  arrays={}, meta={})
        jckpt.save_federated_round(dirs["jax"], round_idx=r, trees={"t": tree},
                                   arrays={}, meta={})
    assert ckpt.list_federated_rounds(dirs["torch"]) == \
        jckpt.list_federated_rounds(dirs["jax"]) == [0, 1, 2, 5, 7]
    assert ckpt.latest_federated_round(dirs["torch"]) == 7
    assert ckpt.prune_federated_rounds(dirs["torch"], 2) == \
        jckpt.prune_federated_rounds(dirs["jax"], 2) == [0, 1, 2]
    assert sorted(os.listdir(dirs["torch"])) == sorted(os.listdir(dirs["jax"]))
    assert ckpt.list_federated_rounds(str(tmp_path / "none")) == []
    assert ckpt.latest_federated_round(str(tmp_path / "none")) is None
    with pytest.raises(ValueError, match="keep_last"):
        ckpt.prune_federated_rounds(dirs["torch"], 0)
    with pytest.raises(FileNotFoundError):
        ckpt.read_federated_meta(str(tmp_path / "none"))


def test_params_only_checkpoints_cross_read(tmp_path):
    tree = numpy_tree(seed=2)["params"]
    tdir, jdir = str(tmp_path / "t"), str(tmp_path / "j")
    ckpt.save_checkpoint(tdir, to_torch(tree), step=4, extra={"note": "x"})
    jckpt.save_checkpoint(jdir, tree, step=4, extra={"note": "x"})
    assert ckpt.latest_step(tdir) == jckpt.latest_step(jdir) == 4
    tz, jz = (np.load(os.path.join(d, "ckpt_00000004.npz")) for d in (tdir, jdir))
    assert sorted(tz.files) == sorted(jz.files)
    assert all(tz[k].tobytes() == jz[k].tobytes() for k in tz.files)
    got, meta = ckpt.restore_checkpoint(jdir, to_torch(numpy_tree(seed=3)["params"]))
    assert_same_leaves(got, to_torch(tree))
    assert meta == {"step": 4, "note": "x"}
    back, _ = jckpt.restore_checkpoint(tdir, numpy_tree(seed=3)["params"])
    assert_same_leaves(jax_to_numpy(back), tree)
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(str(tmp_path / "none"), to_torch(tree))


def test_client_state_round_trips_bitwise_in_both_layouts(tmp_path):
    from repro_torch.core.state import ClientState, init_client_state, to_bf16

    st = init_client_state(5, np.linspace(0, 0.6, 5), device="cpu")
    st = ClientState(**{**st.__dict__, "loss_prev": torch.tensor([0.1, -0.0, 3.0, 7.5, 1e-3])})
    for state in (st, to_bf16(st)):
        ckpt.save_federated_round(str(tmp_path), round_idx=0, trees={"s": state},
                                  arrays={}, meta={})
        got, _, _ = ckpt.restore_federated_round(
            str(tmp_path), likes={"s": init_client_state(5, device="cpu") if
                                  state.loss_prev.dtype == torch.float32
                                  else to_bf16(init_client_state(5, device="cpu"))})
        for name, want in state.__dict__.items():
            have = getattr(got["s"], name)
            assert have.dtype == want.dtype
            assert leaf_bytes(have) == leaf_bytes(want), name

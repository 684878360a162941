"""The port's checkpoint store (``repro_torch.checkpoint.store``) against the
reference's (``repro.checkpoint.store``): the reference's own cases on the
port, and checkpoints moved between the packages in both directions, zlib
and zstd, with byte-equal manifests and leaf file names."""

import os
import tempfile

import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from _torch_parity import CPU, one_torch_thread  # noqa: F401
from repro.checkpoint import store as jstore
from repro_torch import codec
from repro_torch.checkpoint import store

try:
    import zstandard  # noqa: F401
    HAVE_ZSTD = True
except ImportError:
    HAVE_ZSTD = False


def _arrays(rng):
    """The reference test's tree as NumPy: f32, bf16 (its uint16 bits), i32."""
    b = np.asarray(jnp.asarray(rng.normal(size=(3,)), jnp.bfloat16))
    return {
        "a": {"w": rng.normal(size=(4, 8)).astype(np.float32)},
        "b": b,
        "c": rng.integers(0, 10, (2, 2)).astype(np.int32),
        "step": np.asarray(7, np.int32),
    }


def _torch_tree(arrays):
    out = {}
    for k, v in arrays.items():
        if isinstance(v, dict):
            out[k] = _torch_tree(v)
        elif v.dtype.name == "bfloat16":
            out[k] = torch.from_numpy(v.view(np.int16).copy()).view(torch.bfloat16)
        else:
            out[k] = torch.from_numpy(v.copy())
    return out


def _jax_tree(arrays):
    return {k: (_jax_tree(v) if isinstance(v, dict) else jnp.asarray(v))
            for k, v in arrays.items()}


def _bits(x) -> np.ndarray:
    """A leaf's raw bytes as uint8, whatever package holds it."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        x = x.numpy()
    return np.asarray(x).reshape(-1).view(np.uint8)


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]


def _assert_same_tree(got, want):
    assert len(_leaves(got)) == len(_leaves(want))
    for a, b in zip(_leaves(got), _leaves(want)):
        assert tuple(a.shape) == tuple(np.shape(b))
        np.testing.assert_array_equal(_bits(a), _bits(b))


def _manifest(ckpt_dir, step):
    path = os.path.join(ckpt_dir, f"step_{step:08d}", "MANIFEST.msgpack")
    with open(path, "rb") as f:
        return msgpack.unpackb(f.read())


# ---------------------------------------------------------------------------
# the reference's cases, on the port
# ---------------------------------------------------------------------------

def test_roundtrip_exact(rng):
    t = _torch_tree(_arrays(rng))
    with tempfile.TemporaryDirectory() as d:
        store.save(d, 3, t, extra={"data_cursor": 11})
        like = {"a": {"w": torch.zeros(4, 8)}, "b": torch.zeros(3, dtype=torch.bfloat16),
                "c": torch.zeros(2, 2, dtype=torch.int32),
                "step": torch.zeros((), dtype=torch.int32)}
        back, extra = store.restore(d, None, like, device="cpu")
        assert extra["data_cursor"] == 11
        for a, b in zip(_leaves(t), _leaves(back)):
            assert a.dtype == b.dtype and b.device == CPU
        _assert_same_tree(back, t)


def test_keep_last_gc(rng):
    t = _torch_tree(_arrays(rng))
    with tempfile.TemporaryDirectory() as d:
        for s in range(5):
            store.save(d, s, t, keep_last=2)
        assert store.list_steps(d) == [3, 4]
        assert store.latest_step(d) == 4


def test_no_tmp_left_behind(rng):
    t = _torch_tree(_arrays(rng))
    with tempfile.TemporaryDirectory() as d:
        store.save(d, 1, t)
        assert not any(n.endswith(".tmp") for n in os.listdir(d))
        assert store.list_steps(os.path.join(d, "absent")) == []
        assert store.latest_step(os.path.join(d, "absent")) is None


def test_leaf_extension_matches_recorded_codec(rng):
    t = _torch_tree(_arrays(rng))
    with tempfile.TemporaryDirectory() as d:
        store.save(d, 1, t)
        m = _manifest(d, 1)
        assert m["codec"] == ("zstd" if HAVE_ZSTD else "zlib")
        ext = ".bin." + {"zstd": "zst", "zlib": "zlib"}[m["codec"]]
        ckpt = os.path.join(d, "step_00000001")
        for e in m["leaves"]:
            assert e["file"].endswith(ext)
            assert os.path.exists(os.path.join(ckpt, e["file"]))


def test_zlib_fallback_writes_zlib_extension_and_roundtrips(rng, monkeypatch):
    t = _torch_tree(_arrays(rng))
    with tempfile.TemporaryDirectory() as d:
        monkeypatch.setattr(store, "zstd", None)  # a machine without zstandard
        store.save(d, 2, t)
        m = _manifest(d, 2)
        assert m["codec"] == "zlib"
        assert all(e["file"].endswith(".bin.zlib") for e in m["leaves"])
        back, _ = store.restore(d, 2, t, device="cpu")
        _assert_same_tree(back, t)


def test_legacy_zlib_leaves_under_zst_suffix_still_restore(rng, monkeypatch):
    """Zlib leaves written under a ``.zst`` suffix: the manifest's codec,
    not the suffix, drives restore."""
    t = _torch_tree(_arrays(rng))
    with tempfile.TemporaryDirectory() as d:
        monkeypatch.setattr(store, "zstd", None)
        monkeypatch.setattr(
            store, "_leaf_file",
            lambda ps, codec_name: store.hashlib.sha1(
                ps.encode()).hexdigest()[:16] + ".bin.zst")
        store.save(d, 3, t)
        m = _manifest(d, 3)
        assert m["codec"] == "zlib"
        assert all(e["file"].endswith(".bin.zst") for e in m["leaves"])
        monkeypatch.undo()  # restore with real module state (zstd or not)
        back, _ = store.restore(d, 3, t, device="cpu")
        _assert_same_tree(back, t)


def test_shape_mismatch_and_missing_leaf_raise(rng):
    t = _torch_tree(_arrays(rng))
    with tempfile.TemporaryDirectory() as d:
        store.save(d, 1, t)
        bad = dict(t, b=torch.zeros(5, dtype=torch.bfloat16))
        with pytest.raises(ValueError, match="shape mismatch"):
            store.restore(d, 1, bad, device="cpu")
        with pytest.raises(KeyError, match="missing leaf extra"):
            store.restore(d, 1, dict(t, extra=torch.zeros(1)), device="cpu")
        with pytest.raises(FileNotFoundError):
            store.restore(os.path.join(d, "absent"), None, t, device="cpu")


def test_unknown_and_unavailable_codecs_raise(rng, monkeypatch):
    t = {"x": torch.ones(3)}
    with tempfile.TemporaryDirectory() as d:
        store.save(d, 0, t)
        path = os.path.join(d, "step_00000000", "MANIFEST.msgpack")
        with open(path, "rb") as f:
            m = codec.unpackb(f.read())
        for name, err, match in (("lz4", ValueError, "unknown checkpoint codec"),
                                 ("zstd", ModuleNotFoundError, "zstandard")):
            with open(path, "wb") as f:
                f.write(codec.packb(dict(m, codec=name)))
            if name == "zstd":
                monkeypatch.setattr(store, "zstd", None)
            with pytest.raises(err, match=match):
                store.restore(d, 0, t, device="cpu")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_roundtrip_property(seed):
    rng = np.random.default_rng(seed)
    t = {"x": torch.from_numpy(rng.normal(size=(rng.integers(1, 5),)).astype(np.float32)),
         "seq": [torch.from_numpy(rng.integers(0, 9, 3).astype(np.int32)),
                 (np.float32(seed),)]}
    with tempfile.TemporaryDirectory() as d:
        store.save(d, 0, t)
        back, _ = store.restore(d, 0, t, device="cpu")
        assert isinstance(back["seq"], list) and isinstance(back["seq"][1], tuple)
        torch.testing.assert_close(back["x"], t["x"], rtol=0, atol=0)
        torch.testing.assert_close(back["seq"][0], t["seq"][0], rtol=0, atol=0)
        assert float(back["seq"][1][0]) == float(seed)


def test_restore_places_leaves_on_the_device_asked_for(rng):
    t = _torch_tree(_arrays(rng))
    with tempfile.TemporaryDirectory() as d:
        store.save(d, 0, t)
        back, _ = store.restore(d, 0, t, device="cpu")
        assert all(leaf.device == CPU for leaf in _leaves(back))
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                store.restore(d, 0, t)  # device=None means the card


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

CODECS = ["zlib"] + (["zstd"] if HAVE_ZSTD else [])


def _set_codec(monkeypatch, name):
    if name == "zlib":
        monkeypatch.setattr(store, "zstd", None)
        monkeypatch.setattr(jstore, "zstd", None)


@pytest.mark.parametrize("codec_name", CODECS)
def test_jax_checkpoint_restores_in_port(rng, monkeypatch, codec_name):
    _set_codec(monkeypatch, codec_name)
    arrays = _arrays(rng)
    with tempfile.TemporaryDirectory() as d:
        jstore.save(d, 5, _jax_tree(arrays), extra={"who": "jax", "n": 1.5})
        assert _manifest(d, 5)["codec"] == codec_name
        back, extra = store.restore(d, 5, _torch_tree(arrays), device="cpu")
        assert extra == {"who": "jax", "n": 1.5}
        assert back["b"].dtype == torch.bfloat16 and back["c"].dtype == torch.int32
        _assert_same_tree(back, arrays)


@pytest.mark.parametrize("codec_name", CODECS)
def test_port_checkpoint_restores_in_jax(rng, monkeypatch, codec_name):
    _set_codec(monkeypatch, codec_name)
    arrays = _arrays(rng)
    with tempfile.TemporaryDirectory() as d:
        store.save(d, 6, _torch_tree(arrays), extra={"who": "torch"})
        back, extra = jstore.restore(d, 6, _jax_tree(arrays))
        assert extra == {"who": "torch"}
        assert back["b"].dtype == jnp.bfloat16
        _assert_same_tree(back, arrays)


@pytest.mark.parametrize("codec_name", CODECS)
def test_manifests_and_leaf_files_are_byte_equal(rng, monkeypatch, codec_name):
    """The same tree saved by each package: byte-equal manifests, the same
    leaf file names, and the same leaf bytes (both compress the same raw
    bytes at the same level)."""
    _set_codec(monkeypatch, codec_name)
    arrays = _arrays(rng)
    seq = [np.arange(3, dtype=np.uint32), np.float32(2.5)]
    jax_tree = dict(_jax_tree(arrays), seq=[jnp.asarray(x) for x in seq])
    torch_tree = dict(_torch_tree(arrays), seq=list(seq))
    extra = {"metrics": {"err": 0.25, "samples": 12.0}, "reason": "drift"}
    with tempfile.TemporaryDirectory() as dj, tempfile.TemporaryDirectory() as dt:
        jstore.save(dj, 1, jax_tree, extra=extra)
        store.save(dt, 1, torch_tree, extra=extra)
        cj, ct = (os.path.join(x, "step_00000001") for x in (dj, dt))
        assert sorted(os.listdir(cj)) == sorted(os.listdir(ct))
        for name in os.listdir(cj):
            with open(os.path.join(cj, name), "rb") as a, \
                    open(os.path.join(ct, name), "rb") as b:
                assert a.read() == b.read(), name
        assert [e["path"] for e in _manifest(dt, 1)["leaves"]] == \
            ["a/w", "b", "c", "seq/0", "seq/1", "step"]
        back, _ = store.restore(dj, 1, torch_tree, device="cpu")
        assert back["seq"][0].dtype == torch.int32  # uint32 words, same bits
        np.testing.assert_array_equal(back["seq"][0].numpy().view(np.uint32),
                                      seq[0])

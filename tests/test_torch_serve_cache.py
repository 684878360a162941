"""The decode cache's layout in the model layer, and what the serving
engine reads through it.

* ``api.write_cache_row`` on every family's cache (dense, MoE, SSM, the
  hybrid with trailing layers, the published Zamba2 at a tiny size, the
  encoder-decoder): only the row written changes; SSM and conv state equal
  the prefill's row; a KV leaf's first ``min(S, Lc)`` positions equal the
  prefill's and the rest of the row is kept; ``api.kv_positions`` is the
  KV leaf's length.  The leaves are read here by the reference's names
  (``k``/``v``: rows on axis 1, positions on axis 3; ``ssm``: rows on axis
  ndim - 4; ``conv``: ndim - 3), apart from the model layer's statement.
* The serving engine's spans with the recorder on, for mamba2-130m and the
  tiny Zamba2: ``serve.decode.mamba`` a layer a step, ``serve.decode.shared``
  a site a step, KV counts exactly where the cache holds KV, the splice's
  bytes those of the prefill caches; nothing recorded while it is off.
* Importing the serving engine or the model API loads no data plane,
  control plane or observability module, and the span recorder's module
  no other module of the package (fresh interpreters)."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401
from repro_torch.configs import registry as treg
from repro_torch.models import api
from repro_torch.serve.engine import Request, ServeEngine

ROOT = Path(__file__).resolve().parents[1]
TINY_ZAMBA2 = dict(n_layers=8, d_model=64, n_heads=4, n_kv_heads=4, head_dim=32, d_ff=96,
                   ssm_state=16, ssm_head_dim=16, ssm_chunk=16, hybrid_layer_ids=(1, 3, 6),
                   shared_adapter_rank=8, vocab_size=250, vocab_pad_multiple=32)


def _cfg(arch: str):
    if arch == "zamba2-7b-instruct":
        return dataclasses.replace(treg.get_config(arch), dtype="float32", remat="none",
                                   **TINY_ZAMBA2)
    over = {"n_layers": 5} if arch == "zamba2-7b" else {}   # two groups and a trailing layer
    if arch == "olmoe-1b-7b":
        over["moe_capacity_factor"] = 16.0
    return treg.get_config(arch).reduced(dtype="float32", bank_mode="none", **over)


def _leaves(tree, name=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{name}/{k}")
    else:
        yield name, tree


def _axes(name: str, t: torch.Tensor):
    """(row axis, position axis or None) of a leaf, by the reference's names."""
    last = name.rsplit("/", 1)[-1]
    if last in ("k", "v"):
        return 1, 3
    return {"ssm": t.ndim - 4, "conv": t.ndim - 3}[last], None


ARCHS = ["smollm-360m", "olmoe-1b-7b", "mamba2-130m", "zamba2-7b", "zamba2-7b-instruct",
         "seamless-m4t-medium"]


@pytest.mark.parametrize("prompt,cache_len", [(6, 16), (16, 8)], ids=["short", "past-cache"])
@pytest.mark.parametrize("arch", ARCHS)
def test_write_cache_row(arch, prompt, cache_len):
    cfg = _cfg(arch)
    params = api.init(0, cfg, device="cpu")
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, prompt), generator=g)}
    if cfg.family == "encdec":
        frames = cfg.cross_len // 2 if prompt < cache_len else cfg.cross_len + 8
        batch["frames"] = torch.randn(1, frames, cfg.d_model, generator=g)
    with torch.inference_mode():
        _, _, part = api.apply(params, batch, cfg, return_cache=True)
        cache = api.init_cache(cfg, 3, cache_len, device="cpu")
        for _, t in _leaves(cache):
            t.copy_(torch.randn(t.shape, generator=g))
        before = {n: t.clone() for n, t in _leaves(cache)}
        api.write_cache_row(cfg, cache, 1, part)
    parts = dict(_leaves(part))
    kv_lengths = []
    assert set(parts) == set(before)
    for name, t in _leaves(cache):
        row, pos = _axes(name, t)
        got, old, new = t.select(row, 1), before[name].select(row, 1), parts[name].select(row, 0)
        for other in (0, 2):
            assert torch.equal(t.select(row, other), before[name].select(row, other)), name
        if pos is None:
            assert torch.equal(got, new.to(t.dtype)), name
            continue
        kv_lengths.append(t.shape[pos])
        n, rest = min(parts[name].shape[pos], t.shape[pos]), t.shape[pos]
        assert 0 < n and (n < rest) == (prompt < cache_len)
        pos -= 1                                   # the row taken away
        assert torch.equal(got.narrow(pos, 0, n), new.narrow(pos, 0, n)), name
        assert torch.equal(got.narrow(pos, n, rest - n), old.narrow(pos, n, rest - n)), name
    assert api.kv_positions(cfg, cache_len) == (kv_lengths[0] if kv_lengths else 0)
    assert (cfg.family == "ssm") == (not kv_lengths)


def _serve(arch: str, spans_on: bool, monkeypatch):
    """Six requests through a three-row engine; returns it and the bytes
    of every prefill cache its admissions made."""
    cfg = _cfg(arch)
    params = api.init(0, cfg, device="cpu")
    eng = ServeEngine(params, cfg, max_batch=3, max_seq=64, prefill_buckets=(8, 16),
                      device="cpu")
    prefill_bytes = []
    real_apply = api.apply

    def apply(*a, **k):
        out = real_apply(*a, **k)
        prefill_bytes.append(sum(t.numel() * t.element_size() for _, t in _leaves(out[2])))
        return out

    monkeypatch.setattr(api, "apply", apply)
    g = torch.Generator().manual_seed(2)
    for rid, n in enumerate((3, 9, 14, 5, 12, 7)):
        eng.submit(Request(rid=rid, prompt=torch.randint(0, cfg.vocab_size, (n,),
                                                         generator=g).tolist(),
                           max_new_tokens=3 + rid % 3))
    if spans_on:
        eng.spans.start()
    eng.run_until_done()
    assert len(eng.finished) == 6
    return cfg, eng, prefill_bytes


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-7b-instruct"])
def test_serving_spans_cover_every_mamba_layer(arch, monkeypatch):
    cfg, eng, prefill_bytes = _serve(arch, True, monkeypatch)
    summary = eng.spans.summary()
    steps = summary["serve.decode"]["count"]
    sites = len(getattr(cfg, "hybrid_layer_ids", ()))
    assert steps > 0
    mamba = summary["serve.decode.mamba"]
    assert mamba["count"] == cfg.n_layers * steps and mamba["parent"] == "serve.decode"
    if sites:
        shared = summary["serve.decode.shared"]
        assert shared["count"] == sites * steps and shared["parent"] == "serve.decode"
    else:
        assert "serve.decode.shared" not in summary
    holds_kv = api.kv_positions(cfg, eng.max_seq) > 0
    assert holds_kv == bool(sites)
    assert ("kv_resident" in summary["serve.decode"]) == holds_kv
    assert ("kv_valid" in summary["serve.decode"]) == holds_kv
    if holds_kv:
        assert summary["serve.decode"]["kv_resident"] == \
            summary["serve.decode"]["rows"] * eng.max_seq
    assert summary["serve.splice"]["count"] == len(prefill_bytes) == 6
    assert summary["serve.splice"]["nbytes"] == sum(prefill_bytes)


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-7b-instruct"])
def test_serving_records_nothing_while_off(arch, monkeypatch):
    # a decode step that takes no ``spans`` serves as well while the
    # recorder is off: the engine hands it none
    real = api.decode_step
    monkeypatch.setattr(api, "decode_step",
                        lambda params, tokens, cache, lengths, cfg, slot_ids=None:
                        real(params, tokens, cache, lengths, cfg, slot_ids))
    _, eng, _ = _serve(arch, False, monkeypatch)
    assert eng.spans.records == [] and eng.spans.summary() == {}


@pytest.mark.parametrize("module,allowed", [
    ("repro_torch.serve.engine", None),
    ("repro_torch.models.api", None),
    ("repro_torch.spans", {"repro_torch", "repro_torch.spans"}),
])
def test_import_loads_no_data_plane(module, allowed):
    code = (f"import sys, {module}; "
            "print(' '.join(sorted(m for m in sys.modules if m.startswith('repro_torch'))))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout.split()
    assert module in out
    if allowed is not None:
        assert set(out) == allowed
    loaded = {m.split(".")[1] for m in out if "." in m}
    assert not loaded & {"dataplane", "control", "obs"}, sorted(out)

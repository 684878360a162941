"""The published Zamba2 hybrid (family ``zamba2``,
``repro_torch.configs.zamba2_7b_instruct``) on the CPU at a tiny size that
keeps its shape: two B/C groups, two shared blocks used in turn at three
sites with uneven gaps (layers 1, 3 and 6 of 8, so layer 7 trails), a
per-site delta and linear, seeded random weights drawn by the benchmark
harness from the configuration's ``init`` scales.

* The port's prefill logits against the plain float32 reference
  (``bench/configs/zamba2_lm.py``, loaded by path).
* Prefill, then decode through the cache in ``ServeEngine`` (rows of
  unequal lengths spliced into one batch), against the reference's full
  forward over each prompt and its served tokens.
* The one-group path as before: mamba2-130m, reduced, against the JAX
  package through ``apply`` and ``decode_step``.
* The grouped SSD against a token recurrence written here.
* The reference against ``transformers``' ``Zamba2ForCausalLM`` (Zyphra's
  published implementation), weights copied by name.

Tolerances, each the largest absolute gap over the real vocabulary's
logits (the tied head over a unit-RMS hidden state and N(0, 1) embedding
rows: logits of RMS about sqrt(d) = 8 here, up to 36 to 45): float32
against float32 within 2e-4 (the same arithmetic in other orders; read
5.5e-5 to 8.6e-5 over five seeds); bfloat16 within 4.0 (weights,
activations and the residual stream rounded to 8 bits of mantissa through
8 layers; read 1.02 to 2.24 over five seeds, while the float8 control, the
reference with float8 e4m3 matrices, reads 9.44 to 12.43).
"""

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401
from repro_torch.configs import registry as treg
from repro_torch.configs.zamba2_7b_instruct import Zamba2Config
from repro_torch.models import api
from repro_torch.models.lm import LM
from repro_torch.nn import ssd
from repro_torch.serve.engine import Request, ServeEngine

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
CONFIG = json.loads((BENCH / "configs" / "zamba2-7b-instruct.json").read_text())
TINY = dict(n_layers=8, d_model=64, n_heads=4, n_kv_heads=4, head_dim=32, d_ff=96,
            ssm_state=16, ssm_head_dim=16, ssm_chunk=16, hybrid_layer_ids=(1, 3, 6),
            shared_adapter_rank=8, vocab_size=250, vocab_pad_multiple=32)
TOL = {"float32": 2e-4, "bfloat16": 4.0}


def _load(name: str, path: Path):
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


sys.path.insert(0, str(BENCH))          # the runner's ``benchkit``
ref = _load("bench_reference_zamba2_lm", BENCH / "configs" / "zamba2_lm.py")
serve = _load("bench_runner_serve_zamba2_test", BENCH / "runners" / "serve.py")


def _model(dtype: str, seed: int = 2**31 + 7, **over):
    cfg = dataclasses.replace(treg.get_config("zamba2-7b-instruct"),
                              **dict(TINY, dtype=dtype, **over))
    weights = serve.make_weights(LM, cfg, CONFIG["init"], seed, torch.device("cpu"))
    return cfg, weights, api.from_jax_params(weights, cfg, device="cpu")


def _ref_logits(w, cfg, tokens):
    """The reference's logits (B, S, V) of ``tokens`` (B, S), S padded
    to the chunk and cut back."""
    b, s = tokens.shape
    s_pad = -(-s // cfg.ssm_chunk) * cfg.ssm_chunk
    toks = torch.zeros(b, s_pad, dtype=torch.long)
    toks[:, :s] = tokens
    h = ref.hidden(w, toks, dataclasses.asdict(cfg))[:, :s]
    return ref.logits(w, h.reshape(b * s, -1), None,
                      dataclasses.asdict(cfg)).reshape(b, s, -1)


def test_the_published_configuration():
    cfg = treg.get_config("zamba2-7b-instruct")
    assert isinstance(cfg, Zamba2Config) and cfg.family == "zamba2"
    assert "zamba2-7b-instruct" not in treg.ARCH_IDS
    assert treg.get_config("zamba2-7b").family == "hybrid"
    assert cfg.param_count() == 7_356_749_648
    # every parameter the module tree holds, the count's own terms
    meta = LM(cfg, None, torch.device("meta"))
    assert sum(p.numel() for p in meta.parameters()) == cfg.param_count()
    # the benchmark's model block is the catalog's published config
    pub, m = CONFIG, CONFIG["model"]
    assert (m["n_layers"], m["d_model"], m["d_ff"], m["vocab_size"]) == (
        pub["num_hidden_layers"], pub["hidden_size"], pub["ffn_hidden_size"], pub["vocab_size"])
    assert (m["ssm_groups"], m["ssm_state"], m["ssm_head_dim"], m["ssm_expand"],
            m["ssm_conv_width"], m["ssm_chunk"]) == (
        pub["mamba_ngroups"], pub["mamba_d_state"], pub["mamba_headdim"],
        pub["mamba_expand"], pub["mamba_d_conv"], pub["chunk_size"])
    assert m["ssm_expand"] * m["d_model"] // m["ssm_head_dim"] == pub["n_mamba_heads"]
    assert (m["n_heads"], m["n_kv_heads"], m["head_dim"], 2 * m["d_model"]) == (
        pub["num_attention_heads"], pub["num_key_value_heads"], pub["attention_head_dim"],
        pub["attention_hidden_size"])
    assert m["hybrid_layer_ids"] == pub["hybrid_layer_ids"] == [
        i for i, t in enumerate(pub["layers_block_type"]) if t == "hybrid"]
    assert (m["num_mem_blocks"], m["shared_adapter_rank"], m["mlp_act"], m["rope_theta"],
            m["norm_eps"]) == (pub["num_mem_blocks"], pub["adapter_rank"], pub["hidden_act"],
                               pub["rope_theta"], pub["rms_norm_eps"])
    for key, value in m.items():
        assert getattr(cfg, key) == (tuple(value) if isinstance(value, list) else value), key


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_logits_match_the_reference(dtype, rng):
    cfg, weights, params = _model(dtype)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 40)))
    with torch.inference_mode():
        got, _ = api.apply(params, {"tokens": tokens}, cfg)
    want = _ref_logits(ref.as_f32(weights), cfg, tokens)
    v = cfg.vocab_size
    assert float((got[..., :v].float() - want[..., :v]).abs().max()) <= TOL[dtype]
    assert torch.all(got[..., v:] < -1e30)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_through_the_engine(dtype, rng):
    """Requests of unequal prompt lengths share the batch: each prefill's
    KV (its bucket's pad positions included) and SSM and conv state are
    spliced into its row, then every row decodes through the cache."""
    cfg, weights, params = _model(dtype)
    eng = ServeEngine(params, cfg, max_batch=3, max_seq=96,
                      prefill_buckets=(8, 16, 32), max_admit_wait_s=1.0, device="cpu")
    last = {}
    real_decode, real_step = api.decode_step, ServeEngine._decode

    def decode(*a, **k):
        out = real_decode(*a, **k)
        last["logits"] = out[0]
        return out

    def step(self):
        nxt = real_step(self)
        for row, req in enumerate(self.row_req):
            if self.active[row]:
                logits[req.rid].append(last["logits"][row, -1].float())
        return nxt

    lengths = (3, 13, 29, 8, 21)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, n).tolist(),
                    max_new_tokens=int(rng.integers(6, 14))) for i, n in enumerate(lengths)]
    logits = {r.rid: [] for r in reqs}
    with pytest.MonkeyPatch().context() as mp:
        mp.setattr(api, "decode_step", decode)
        mp.setattr(ServeEngine, "_decode", step)
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
    assert sorted(f.rid for f in eng.finished) == [r.rid for r in reqs]
    w = ref.as_f32(weights)
    v = cfg.vocab_size
    for f in eng.finished:
        req = reqs[f.rid]
        seq = torch.tensor(list(req.prompt) + f.output[:-1])[None]
        want = _ref_logits(w, cfg, seq)[0, len(req.prompt):, :v]
        mine = torch.stack(logits[f.rid])[:, :v]
        assert len(f.output) == req.max_new_tokens
        assert mine.argmax(-1).tolist() == f.output[1:]
        assert float((mine - want).abs().max()) <= TOL[dtype], f.rid


def test_one_group_path_as_before(rng):
    """mamba2-130m (one B/C group), reduced, against the JAX package
    through ``apply`` and three ``decode_step``s, as the parity tests hold
    it (f32 within 1e-4)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import registry as jreg
    from repro.models import api as japi

    jcfg = jreg.get_config("mamba2-130m").reduced(remat="none", dtype="float32")
    tcfg = treg.get_config("mamba2-130m").reduced(remat="none", dtype="float32")
    assert ssd.ssm_groups(tcfg) == 1
    jp = japi.init(jax.random.PRNGKey(3), jcfg)
    tp = api.from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu")
    tokens = rng.integers(0, jcfg.vocab_size, (2, 24))
    mask = (np.arange(24)[None] < np.array([[24], [17]])).astype(np.float32)
    want, _, jc = japi.apply(jp, {"tokens": jnp.asarray(tokens), "pad_mask": jnp.asarray(mask)},
                             jcfg, return_cache=True)
    with torch.inference_mode():
        got, _, tc = api.apply(tp, {"tokens": torch.from_numpy(tokens),
                                    "pad_mask": torch.from_numpy(mask)}, tcfg, return_cache=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    jc, tc = japi.init_cache(jcfg, 2, 32), api.init_cache(tcfg, 2, 32, device="cpu")
    for cache_len in ([0, 3], 5, [4, 9]):
        toks = rng.integers(0, jcfg.vocab_size, (2, 1))
        wl, jc = japi.decode_step(jp, jnp.asarray(toks), jc, jnp.asarray(cache_len, jnp.int32),
                                  jcfg)
        with torch.inference_mode():
            gl, tc = api.decode_step(tp, torch.from_numpy(toks), tc,
                                     torch.tensor(cache_len), tcfg)
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), atol=1e-4, rtol=1e-4)


def test_grouped_ssd_is_the_recurrence():
    """G = 2: head h reads group h // (H / G), in the chunked form, the
    port's token recurrence and one decode step, against a recurrence
    written here (f32 within 1e-4: another algorithm in f32)."""
    g = torch.Generator().manual_seed(11)
    bt, s, h, p, n, groups = 2, 32, 4, 4, 5, 2
    x = torch.randn(bt, s, h, p, generator=g)
    dt = torch.rand(bt, s, h, generator=g) * 0.5
    a = -torch.rand(h, generator=g) * 4
    b, c = torch.randn(bt, s, groups, n, generator=g), torch.randn(bt, s, groups, n, generator=g)
    grp = torch.arange(h) // (h // groups)
    state, ys = torch.zeros(bt, h, p, n), []
    for t in range(s):
        state = (torch.exp(dt[:, t] * a)[:, :, None, None] * state
                 + dt[:, t, :, None, None] * x[:, t, :, :, None] * b[:, t, grp, None, :])
        ys.append(torch.einsum("bhpn,bhn->bhp", state, c[:, t, grp]))
    want = torch.stack(ys, 1)
    for chunk in (4, 8, 32):
        y, st = ssd.ssd_chunked(x, dt, a, b, c, chunk)
        assert torch.allclose(y, want, atol=1e-4, rtol=1e-4)
        assert torch.allclose(st, state, atol=1e-4, rtol=1e-4)
    y, st = ssd.ssd_sequential(x, dt, a, b, c)
    assert torch.allclose(y, want, atol=1e-4, rtol=1e-4)
    assert torch.allclose(st, state, atol=1e-4, rtol=1e-4)


def _hf_model(cfg, w):
    """``transformers``' Zamba2ForCausalLM at ``cfg`` holding weights ``w``
    (the harness's tree, float32), copied by name."""
    transformers = pytest.importorskip("transformers")
    from transformers.models.zamba2 import modeling_zamba2 as hfz

    sites = set(cfg.hybrid_layer_ids)
    hcfg = transformers.Zamba2Config(
        vocab_size=cfg.vocab_size, hidden_size=cfg.d_model, num_hidden_layers=cfg.n_layers,
        layers_block_type=["hybrid" if i in sites else "mamba" for i in range(cfg.n_layers)],
        mamba_d_state=cfg.ssm_state, mamba_d_conv=cfg.ssm_conv_width,
        mamba_expand=cfg.ssm_expand, mamba_ngroups=cfg.ssm_groups,
        n_mamba_heads=cfg.ssm_heads, chunk_size=cfg.ssm_chunk,
        intermediate_size=cfg.d_ff, hidden_act="gelu", num_attention_heads=cfg.n_heads,
        num_key_value_heads=cfg.n_kv_heads, num_mem_blocks=cfg.num_mem_blocks,
        use_shared_attention_adapter=False, adapter_rank=cfg.shared_adapter_rank,
        use_mem_rope=True, rope_theta=cfg.rope_theta, rms_norm_eps=cfg.norm_eps,
time_step_limit=None, add_bias_linear=False,
        use_conv_bias=True, tie_word_embeddings=True, use_cache=False,
        attn_implementation="eager")
    model = hfz.Zamba2ForCausalLM(hcfg).eval()
    assert hcfg.attention_head_dim == cfg.head_dim

    def put(param, value):
        assert tuple(param.shape) == tuple(value.shape), (param.shape, value.shape)
        param.data.copy_(value)

    L, B, S = w["layers"], w["blocks"], w["sites"]
    put(model.model.embed_tokens.weight, w["embed"]["embedding"][:cfg.vocab_size])
    put(model.lm_head.weight, w["embed"]["embedding"][:cfg.vocab_size])
    put(model.model.final_layernorm.weight, w["final_norm"]["scale"])
    for i, layer in enumerate(model.model.layers):
        mamba_layer = layer.mamba_decoder if i in sites else layer
        mx = mamba_layer.mamba
        # the published time_step_limit is null: no clamp, as the published
        # kernels apply it; transformers' CPU path clamps dt at
        # time_step_min instead, which 0 makes the same
        mx.time_step_min = 0.0
        put(mamba_layer.input_layernorm.weight, L["ln1"]["scale"][i])
        put(mx.in_proj.weight, L["mamba"]["in_proj"][i].t())
        put(mx.conv1d.weight, L["mamba"]["conv_w"][i].t()[:, None, :])
        put(mx.conv1d.bias, L["mamba"]["conv_b"][i])
        for k in ("dt_bias", "A_log", "D"):
            put(getattr(mx, k), L["mamba"][k][i])
        put(mx.norm.weight, L["mamba"]["norm"]["scale"][i])
        put(mx.out_proj.weight, L["mamba"]["out_proj"][i].t())
    for j, layer_id in enumerate(cfg.hybrid_layer_ids):
        hybrid = model.model.layers[layer_id]
        blk, b = hybrid.shared_transformer, j % cfg.num_mem_blocks
        assert blk.block_id == b
        put(hybrid.linear.weight, S["linear"][j].t())
        put(blk.input_layernorm.weight, B["ln_attn"]["scale"][b])
        put(blk.pre_ff_layernorm.weight, B["ln_mlp"]["scale"][b])
        for name in ("q", "k", "v", "o"):
            put(getattr(blk.self_attn, f"{name}_proj").weight, B["attn"][f"w{name}"][b].t())
        put(blk.feed_forward.gate_up_proj.weight, B["mlp"]["wgu"][b].t())
        put(blk.feed_forward.down_proj.weight, B["mlp"]["wd"][b].t())
        lora = blk.feed_forward.gate_up_proj_adapter_list[j]
        put(lora[0].weight, S["lora_a"][j].t())
        put(lora[1].weight, S["lora_b"][j].t())
    return model


def test_the_reference_is_zyphras_published_model(rng, monkeypatch):
    """The reference's logits equal ``transformers``' over a prompt of one
    SSD chunk and then through its cached decode, token by token, past two
    chunk boundaries.  Its CPU path's prefill over several chunks is not
    read: ``Zamba2MambaMixer.torch_forward`` sums the carried states over
    the wrong chunk axis (``.sum(dim=2)`` of the decays), so its logits
    depart from the token recurrence from the second chunk on, for one
    B/C group as for two; its cached decode is the recurrence itself."""
    monkeypatch.setenv("USE_TF", "0")       # transformers without TensorFlow
    cfg = dataclasses.replace(treg.get_config("zamba2-7b-instruct"),
                              **dict(TINY, vocab_size=256, dtype="float32"))
    w = ref.as_f32(serve.make_weights(LM, cfg, CONFIG["init"], 2**31 + 5, torch.device("cpu")))
    model = _hf_model(cfg, w)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 3 * cfg.ssm_chunk)))
    first = cfg.ssm_chunk
    with torch.no_grad():
        out = model(input_ids=tokens[:, :first], use_cache=True)
        want, past = [out.logits], out.past_key_values
        for i in range(first, tokens.shape[1]):
            out = model(input_ids=tokens[:, i:i + 1], past_key_values=past, use_cache=True)
            want.append(out.logits)
            past = out.past_key_values
    want = torch.cat(want, dim=1)
    got = _ref_logits(w, cfg, tokens)
    assert float((got - want).abs().max()) <= TOL["float32"]
    # every site counts: the same forward with one site's linear zeroed differs
    w["sites"]["linear"][1] = 0
    assert float((_ref_logits(w, cfg, tokens) - want).abs().max()) > 1.0

"""The port's configs (``repro_torch.configs``) against the reference's: every
arch's ``ModelConfig`` and its ``reduced()`` variant field for field, the
analytic parameter counts, the input shapes and their applicability, and
the paper's own BNN config."""

import dataclasses

import pytest

from _torch_parity import one_torch_thread  # noqa: F401
from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg


def test_arch_ids_are_the_reference_s():
    assert treg.ARCH_IDS == jreg.ARCH_IDS
    assert sorted(treg.all_configs()) == sorted(jreg.all_configs())


@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_config_fields_and_param_counts(arch):
    ref, port = jreg.get_config(arch), treg.get_config(arch)
    assert type(port).__module__.startswith("repro_torch.")
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    if arch == "boundswitch-h32":  # the paper's BNN: no LM parameter count
        assert (port.words, port.param_bytes()) == (ref.words, ref.param_bytes())
        return
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()
    for over in ({}, {"dtype": "float32", "remat": "none"}):
        r_ref, r_port = ref.reduced(**over), port.reduced(**over)
        assert dataclasses.asdict(r_port) == dataclasses.asdict(r_ref)
        assert r_port.param_count() == r_ref.param_count()
        assert r_port.active_param_count() == r_ref.active_param_count()
    for name in ("padded_vocab", "d_inner", "ssm_heads", "is_attention_free",
                 "supports_long_context"):
        assert getattr(port, name) == getattr(ref, name)
    assert port.kv_cache_len(8192) == ref.kv_cache_len(8192)


def test_shapes_and_applicability():
    assert {k: dataclasses.asdict(v) for k, v in tbase.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    for arch in treg.all_configs():
        for name in tbase.SHAPES:
            assert tbase.shape_applicable(treg.get_config(arch), tbase.SHAPES[name]) == \
                jbase.shape_applicable(jreg.get_config(arch), jbase.SHAPES[name])


def test_published_widths_of_the_served_models():
    """The two models the card serves at full width, with their published
    sizes (0.362 B and 0.129 B parameters)."""
    smol, mamba = treg.get_config("smollm-360m"), treg.get_config("mamba2-130m")
    assert (smol.n_layers, smol.d_model, smol.n_heads, smol.n_kv_heads, smol.d_ff,
            smol.vocab_size, smol.tie_embeddings) == (32, 960, 15, 5, 2560, 49152, True)
    assert (mamba.n_layers, mamba.d_model, mamba.ssm_state, mamba.ssm_chunk) == \
        (24, 768, 128, 256)
    assert round(smol.param_count() / 1e9, 3) == 0.362
    assert round(mamba.param_count() / 1e9, 3) == 0.129

"""Helpers of the port's multi-rank tests (``test_torch_dist_*.py``): N
gloo ranks spawned on the CPU, meeting through a ``file://`` store under the
test's ``tmp_path`` (never a fixed port: test workers run side by side), and
the functions the ranks run.  Imports torch and the port only, so a spawned
rank loads neither JAX nor the reference."""

import pickle

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import registry as treg
from repro_torch.distributed import compress, sharding
from repro_torch.launch import dryrun, mesh as meshlib
from repro_torch.models import api as tapi
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts


def _entry(rank, world, tmp, fn, args):
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            rank=rank, world_size=world)
    try:
        torch.set_num_threads(1)
        result = fn(rank, *args)
        with open(f"{tmp}/rank{rank}.pkl", "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, tmp_path, *args) -> list:
    """``fn(rank, *args)`` on ``world`` gloo ranks; each rank's result."""
    mp.spawn(_entry, args=(world, str(tmp_path), fn, args), nprocs=world, join=True)
    out = []
    for r in range(world):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def host_mesh(shape):
    """A ("data", "model") CPU mesh over the gloo ranks."""
    return meshlib._build(tuple(shape), ("data", "model"), "cpu")


def psum_rank(rank, shape, xs):
    """``compressed_psum`` over "data" of ``xs[rank]`` (one input per rank)."""
    mesh = host_mesh(shape)
    return compress.compressed_psum(torch.from_numpy(xs[rank]), mesh, "data").numpy()


def placements_rank(rank, specs):
    """For each spec: the placements on a (2, 2) mesh, and this rank's
    shard of a (4, 6) arange made whole again."""
    mesh = host_mesh((2, 2))
    full = torch.arange(24.0).reshape(4, 6)
    out = []
    for spec in specs:
        d = sharding.distribute(full, mesh, spec)
        out.append((repr(list(d.placements)), tuple(d.to_local().shape),
                    d.full_tensor().numpy()))
    return out


def train_rank(rank, arch, over, params_np, opt_kw, batch_np, shape):
    """One step of ``make_train_step`` on a sharded state (``rules_for``
    on a ``shape`` mesh), from the given reference weights and batch;
    returns the metrics and the whole state's pytree."""
    mesh = host_mesh(shape)
    cfg = treg.get_config(arch).reduced(**over)
    opt_cfg = topt.OptimizerConfig(**opt_kw)
    model = tapi.from_jax_params(params_np, cfg, device="cpu")
    state = {"params": model, "opt": topt.adamw_init(list(model.parameters()), opt_cfg),
             "step": torch.zeros((), dtype=torch.int32)}
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    rules = dryrun.rules_for(cfg, "train", mesh)
    pspecs, _ = sharding.legalize(sharding.param_specs(model, rules),
                                  dict(model.named_parameters()), mesh)
    bspecs, _ = sharding.legalize(sharding.batch_specs(batch, rules),
                                  sharding.tree_paths(batch), mesh)
    specs = {"params": pspecs, "opt": sharding.opt_state_specs(pspecs, state["opt"]),
             "batch": bspecs}
    state, batch = sharding.distribute_state(state, mesh, specs, batch)
    sharded = sum(any(p.is_shard() for p in t.placements) for t in model.parameters())
    with implicit_replication():
        state, metrics = tts.make_train_step(cfg, opt_cfg)(state, batch)
    metrics = {k: float(v.full_tensor() if hasattr(v, "full_tensor") else v)
               for k, v in metrics.items()}
    tree = tts.state_tree(sharding.gather_state(state))
    return metrics, {k: v for k, v in _leaves(tree).items()}, sharded


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.float().numpy()}
    return {prefix: np.asarray(tree, np.float32)}


def prefill_rank(rank, arch, over, params_np, batch_np, shape):
    """The forward pass (``api.apply``) of ``arch`` from the given
    reference weights, its params sharded by ``rules_for`` for a prefill on
    a ``shape`` mesh and the batch by ``batch_specs``; the logits whole."""
    mesh = host_mesh(shape)
    cfg = treg.get_config(arch).reduced(**over)
    model = tapi.from_jax_params(params_np, cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    rules = dryrun.rules_for(cfg, "prefill", mesh)
    pspecs, _ = sharding.legalize(sharding.param_specs(model, rules),
                                  dict(model.named_parameters()), mesh)
    bspecs, _ = sharding.legalize(sharding.batch_specs(batch, rules),
                                  sharding.tree_paths(batch), mesh)
    sharding.distribute_state({"params": model, "opt": {}}, mesh,
                              {"params": pspecs, "opt": {}})
    batch = sharding.distribute_tree(batch, mesh, bspecs)
    with torch.no_grad(), implicit_replication():
        logits, _ = tapi.apply(model, batch, cfg)
    return logits.full_tensor().numpy()


def decode_rank(rank, arch, over, params_np, tokens_np, cache_np, cache_len, slot_np, shape):
    """One decode step (``api.decode_step``) of ``arch`` from the given
    reference weights and cache, its params sharded by ``rules_for`` for a
    decode on a ``shape`` mesh, the cache by the dry-run's cache specs and
    the tokens by ``batch_specs``; the logits and the written cache whole."""
    mesh = host_mesh(shape)
    cfg = treg.get_config(arch).reduced(**over)
    model = tapi.from_jax_params(params_np, cfg, device="cpu")
    rules = dryrun.rules_for(cfg, "decode", mesh)
    pspecs, _ = sharding.legalize(sharding.param_specs(model, rules),
                                  dict(model.named_parameters()), mesh)
    sharding.distribute_state({"params": model, "opt": {}}, mesh,
                              {"params": pspecs, "opt": {}})
    cache = sharding.tree_unflatten({k: torch.from_numpy(v) for k, v in
                                     sharding.tree_paths(cache_np).items()})
    cspecs, _ = sharding.legalize(dryrun._decode_cache_specs(cache, rules, mesh),
                                  sharding.tree_paths(cache), mesh)
    cache = sharding.distribute_tree(cache, mesh, cspecs)
    inputs = {"tokens": torch.from_numpy(tokens_np), "slot_ids": torch.from_numpy(slot_np)}
    ispecs, _ = sharding.legalize(sharding.batch_specs(inputs, rules),
                                  sharding.tree_paths(inputs), mesh)
    inputs = sharding.distribute_tree(inputs, mesh, ispecs)
    with torch.no_grad(), implicit_replication():
        logits, cache = tapi.decode_step(model, inputs["tokens"], cache, cache_len, cfg,
                                         inputs["slot_ids"])
    whole = {k: v.full_tensor().float().numpy() for k, v in sharding.tree_paths(cache).items()}
    return logits.full_tensor().numpy(), whole

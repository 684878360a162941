"""The serving runner: one run of a cell whose configuration names
``"runner": "serve"``.

``run_cell`` builds the configuration's model (``arch`` from the program's
registry with the file's ``model`` fields applied), draws every parameter
from the seed by the program's parameter names and shapes at the file's
``init`` scales, loads them into the program, and serves the cell's request
stream through ``repro_torch.serve.engine.ServeEngine``'s public calls,
``submit`` and ``step``: a closed loop of ``in_flight`` requests, each
finished request replaced at once.  Set-up primes the loop: the first
``in_flight`` requests are sent and admitted (their prefills warm every
bucket the stream reaches, their first decode the full batch) before the
window opens, so the window holds no cold start.  After the window it
drains the engine,
reads the peak memory, frees the program and teacher-forces every finished
request through the configuration's plain reference.  Host spans
(``bench.admit_step``, ``bench.decode_step``) time each step; with
``trace`` a ``torch.profiler`` sub-window at the window's end gives the
device numbers.

A step is an admitting step when requests wait before it (in the closed
loop a waiting request always finds a free row, so it is admitted there),
else a decode step.  Every step decodes every active row once, and an
admitted request also gets its prefill's token: a request admitted at step
s with n output tokens has tokens 0 and 1 at the end of step s and token k
at the end of step s + k - 1 (``step_tokens``, which holds each finished
request to that count).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import sys
import time
from pathlib import Path

import numpy as np

from benchkit import profiling
from benchkit.runner import (SUB_MAX_S, SUB_SHARE, ForbiddenImport, NoDevice,
                             _merge, forbidden_modules, passes)
from benchkit.spec import Spec

DRAIN_S = 200.0            # a safety bound: the drain ends by its step count
LOGIT_ROWS = 4096          # positions whose reference logits are held at once
BLOCK_TOKENS = 16384       # tokens the reference forwards at once


# -- weights ---------------------------------------------------------------

def _shape_tree(mod):
    """The module's parameters as a tree of (shape, dtype), a ``ModuleList``
    stacked on a leading axis (the layout ``api.load_params`` takes)."""
    from torch import nn

    if isinstance(mod, nn.ModuleList):
        subs = [_shape_tree(m) for m in mod]
        return _stack_shapes(subs)
    out = {k: (tuple(p.shape), p.dtype) for k, p in mod._parameters.items()}
    out.update({k: _shape_tree(m) for k, m in mod._modules.items()})
    return out


def _stack_shapes(subs):
    if isinstance(subs[0], dict):
        return {k: _stack_shapes([s[k] for s in subs]) for k in subs[0]}
    if any(s != subs[0] for s in subs):
        raise ValueError("a module list whose members differ in shape")
    shape, dtype = subs[0]
    return (len(subs),) + shape, dtype


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, path)
        else:
            yield path, v


def _draw(spec: dict, shape, g, dev):
    """One leaf, float32, by its ``init`` entry."""
    import torch

    (kind, arg), = spec.items()
    f32 = dict(generator=g, device=dev, dtype=torch.float32)
    if kind == "normal":
        return float(arg[0]) + float(arg[1]) * torch.randn(shape, **f32)
    if kind == "normal_fan_in":
        return float(arg) / math.sqrt(shape[-2]) * torch.randn(shape, **f32)
    if kind == "uniform":
        return float(arg[0]) + (float(arg[1]) - float(arg[0])) * torch.rand(shape, **f32)
    if kind == "log_of_uniform":
        return torch.log(float(arg[0]) + (float(arg[1]) - float(arg[0]))
                         * torch.rand(shape, **f32))
    if kind == "softplus_inverse_log_uniform":
        lo, hi = math.log(float(arg[0])), math.log(float(arg[1]))
        dt = torch.exp(lo + (hi - lo) * torch.rand(shape, **f32)).clamp_min(1e-4)
        return dt + torch.log(-torch.expm1(-dt))
    raise ValueError(f"unknown init {kind!r}")


def make_weights(model_cls, cfg, init: dict, seed: int, dev) -> dict:
    """Every parameter of ``model_cls(cfg)`` drawn on ``dev`` from ``seed``,
    one call a leaf (layers stacked), rounded to the program's dtype."""
    import torch

    shapes = _shape_tree(model_cls(cfg, None, torch.device("meta")))
    missing = [p for p, _ in _leaves(shapes) if p not in init]
    if missing:
        raise ValueError(f"no init scale for {missing}")
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed) % 2**63)
    flat = {p: _draw(init[p], shape, g, dev).to(dtype)
            for p, (shape, dtype) in sorted(_leaves(shapes))}

    def build(tree, prefix=""):
        return {k: build(v, f"{prefix}.{k}" if prefix else k) if isinstance(v, dict)
                else flat[f"{prefix}.{k}" if prefix else k] for k, v in tree.items()}
    return build(shapes)


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}


# -- the run ---------------------------------------------------------------

@dataclasses.dataclass
class _Step:
    start: float
    end: float
    admitted: int           # requests admitted (their prompts prefilled)
    prompt_tokens: int      # their prompt tokens
    rows: int               # rows decoded
    head_slots: int         # distinct head slots among them
    profiled: bool



def run_cell(root, workload: str, seed: int, seconds: float, trace: bool, *,
             device=None, overrides: dict | None = None, t_start=None,
             control: bool = False, log=None) -> dict:
    """Run one serving cell once; the data plane's ``run_cell`` contract
    (``benchkit.runner``).  ``control=True`` also judges the control, the
    reference with its matrices in float8 e4m3, on the same prompts and
    served tokens: the result's ``control``."""
    clock = time.perf_counter
    t_start = clock() if t_start is None else t_start
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    root = Path(root)
    cell = Spec(root).cell(workload)
    overrides = overrides or {}
    cfgf = _merge(cell.config, overrides.get("config"))
    mix = _merge(cell.mix, overrides.get("mix"))
    import torch

    sys.path.insert(0, str(root / "src"))
    from repro_torch.configs.registry import get_config
    from repro_torch.models import api
    from repro_torch.models.lm import LM
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = dataclasses.replace(get_config(cfgf["arch"]), **cfgf["model"])
    m = dataclasses.asdict(cfg)
    traffic = cell.generator(mix, num_slots=cfg.bank_slots,
                             vocab_size=cfg.vocab_size, seed=seed, seconds=seconds,
                             max_prompt=int(cfgf["max_prompt_tokens"]),
                             max_new=int(cfgf["max_new_tokens"]))
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            raise NoDevice(f"cell {workload} needs {cell.chips} CUDA device(s)")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    t_imp = clock()
    weights = make_weights(LM, cfg, cfgf["init"], seed, dev)
    params = api.from_jax_params(weights, cfg, device=dev)
    weights = _to(weights, "cpu")            # the reference's copy, off the card
    t_w = clock()
    ekw = {k: v for k, v in cfgf["engine"].items() if k != "why"}
    ekw["prefill_buckets"] = tuple(ekw["prefill_buckets"])

    eng = ServeEngine(params, cfg, device=dev, **ekw)
    steps: list[_Step] = []
    sent: dict[int, float] = {}
    stream: dict[int, int] = {}           # rid -> index in the stream
    admit_step: dict[int, int] = {}
    finish_step: dict[int, int] = {}
    inflight: dict[int, int] = {}         # rid -> head slot, admitted
    done: dict[int, object] = {}          # rid -> Finished
    next_rid = 0
    prof = None
    pre: dict = {}
    sub_from = seconds - min(SUB_MAX_S, SUB_SHARE * seconds)

    def submit():
        nonlocal next_rid
        i = next_rid % len(traffic)
        stream[next_rid] = i
        sent[next_rid] = clock()
        eng.submit(Request(rid=next_rid, prompt=traffic.prompts[i].tolist(),
                           slot_id=int(traffic.slots[i]),
                           max_new_tokens=int(traffic.max_new[i])))
        next_rid += 1

    def step(open_window: bool):
        waiting = {r.rid for r in eng.waiting}
        nfin = len(eng.finished)
        name = "admit_step" if waiting else "decode_step"
        ctx = (torch.profiler.record_function(profiling.SPAN_PREFIX + name)
               if prof is not None else contextlib.nullcontext())
        a = clock()
        with ctx:
            eng.step()
        c = clock()
        admitted = waiting - {r.rid for r in eng.waiting}
        for rid in admitted:
            admit_step[rid] = len(steps)
            inflight[rid] = int(traffic.slots[stream[rid]])
        steps.append(_Step(
            start=a, end=c, admitted=len(admitted),
            prompt_tokens=sum(len(traffic.prompts[stream[r]]) for r in admitted),
            rows=len(inflight), head_slots=len(set(inflight.values())),
            profiled=prof is not None))
        for f in eng.finished[nfin:]:
            done[f.rid] = f
            finish_step[f.rid] = len(steps) - 1
            inflight.pop(f.rid, None)
            if open_window:
                submit()
        return c

    # -- priming, the warm-up: the first ``in_flight`` requests sent and
    # admitted (every block of the stream holds the same lengths, so their
    # prefills reach every bucket the window does) and decoded once; the
    # decode step always runs the whole batch (inactive rows ride along
    # masked), so its shapes are the window's ----------------------------
    for _ in range(traffic.in_flight):
        submit()
    while eng.waiting:
        step(True)
    n_prime = len(steps)
    sync()
    t_warm = clock()
    if trace:
        profiling.warm()
    freeze = bool(cfgf.get("host", {}).get("gc_freeze_after_setup", False))
    if freeze:
        gc.collect()
        gc.freeze()

    # -- the window: the primed closed loop --------------------------------
    t_setup_end = t0 = clock()
    log(f"set-up s: start to weights {t_imp - t_start:.3f} (imports, traffic, the "
        f"card), weights {t_w - t_imp:.3f}, priming {t_warm - t_w:.3f} ({n_prime} "
        f"steps), the rest {t0 - t_warm:.3f}")
    while True:
        c = step(True)
        if trace and prof is None and not pre and c - t0 >= sub_from:
            sync()
            pre.update(window_s=clock() - t0, steps=len(steps))
            prof = profiling.start()
            t_sub0 = clock()
        if c - t0 >= seconds:
            break
    window_s = c - t0
    if prof is not None:
        sync()
        t_sub1 = clock()
        prof.stop()
    n_window = len(steps)
    max_steps = n_window + int(traffic.max_new.max()) * (
        2 + len(eng.waiting) // ekw["max_batch"]) + 16
    while (inflight or eng.waiting) and len(steps) < max_steps \
            and clock() - t0 - window_s < DRAIN_S:
        step(False)
    sync()

    # -- after the window: memory, the trace, then the program goes --------
    found = forbidden_modules()
    if found:
        raise ForbiddenImport("loaded after the window: " + ", ".join(found))
    mem_peak = (int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0)
    summary = None
    if trace:
        if prof is None:
            raise RuntimeError("the traced sub-window never opened")
        summary = profiling.summarize(prof)
        if summary["busy_s"] <= 0:
            raise RuntimeError("the profiler shows no device time in the "
                               "traced sub-window")
        summary["decode_busy_s"], summary["decode_spans"] = \
            profiling.busy_within(prof, "decode_step")
    del eng, params
    if freeze:
        gc.unfreeze()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    served = [(stream[rid], f.output) for rid, f in sorted(done.items())
              if not f.rejected and len(f.output) == traffic.max_new[stream[rid]]]
    unfinished = len(sent) - len(served)
    tol = float(cfgf["check"]["tol"])
    checks, ctl_checks, note, wrong_req = check_tokens(
        cell.reference, m, weights, traffic, served, unfinished, tol=tol,
        dev=dev, control=control)
    for line in note:
        log(line)

    # -- what the readers are given -----------------------------------------
    # Host numbers come from the whole window or, in a traced run, from the
    # part before the profiler: ``window_s``; ``served_window`` (output
    # tokens delivered), ``processed_window`` (prompt tokens prefilled and
    # rows decoded), ``decode_step_s`` (wall of each step that admitted
    # nothing), ``admit_step_s`` and ``admitted_window`` (wall of each
    # admitting step, requests admitted).  ``model``: the configuration's
    # fields.  ``sub`` (traced runs): ``profiling.summarize``'s numbers with
    # the sub-window's ``wall_s``, ``served`` (tokens delivered) and
    # ``ticks``, ``served_rate_unprofiled``, ``decode_busy_s`` and
    # ``decode_spans`` (device-busy seconds inside the decode steps' spans,
    # their number) and ``decode_bytes`` (the least bytes of those steps).
    tokens = step_tokens(len(steps), admit_step, finish_step,
                         {rid: len(f.output) for rid, f in done.items()})
    n_host = pre["steps"] if pre else n_window
    host = steps[n_prime:n_host]
    host_s = pre["window_s"] if pre else window_s
    dec = [s for s in host if s.admitted == 0]
    adm = [s for s in host if s.admitted > 0]
    first_tok = {rid: steps[s].end - sent[rid] for rid, s in admit_step.items()
                 if n_prime <= s < n_window}
    ttft_ms = float(np.median(list(first_tok.values())) * 1e3) if first_tok else None
    ctx = dict(
        closed=True, window_s=host_s, setup_s=t_setup_end - t_start,
        served_window=int(tokens[n_prime:n_host].sum()),
        processed_window=sum(s.prompt_tokens + s.rows for s in host),
        decode_step_s=np.asarray([s.end - s.start for s in dec]),
        admit_step_s=np.asarray([s.end - s.start for s in adm]),
        admitted_window=sum(s.admitted for s in adm),
        model=m, num_slots=cfg.bank_slots, sub=None)
    if summary is not None:
        from benchkit import lm_work

        sub_idx = [i for i, s in enumerate(steps[:n_window]) if s.profiled]
        sub_dec = [steps[i] for i in sub_idx if steps[i].admitted == 0]
        if len(sub_dec) != summary["decode_spans"]:
            raise RuntimeError(f"{summary['decode_spans']} decode spans traced "
                               f"for {len(sub_dec)} decode steps")
        nbytes = [lm_work.decode_bytes(m, s.rows, s.head_slots) for s in sub_dec]
        ctx["sub"] = dict(
            summary, wall_s=t_sub1 - t_sub0,
            served=int(tokens[sub_idx].sum()), ticks=len(sub_idx),
            served_rate_unprofiled=ctx["served_window"] / max(host_s, 1e-9),
            decode_bytes=None if None in nbytes else float(sum(nbytes)))
    dec_ms = float(np.median(ctx["decode_step_s"]) * 1e3) if dec else float("nan")
    log(f"window {window_s:.3f} s: sent {len(sent)} requests, succeeded "
        f"{len(served)}, failed {len(sent) - len(served)}; steps {n_window - n_prime} "
        f"({len(adm)} admitting, {sum(s.admitted for s in adm)} admitted) and "
        f"{len(steps) - n_window} draining; tokens out {ctx['served_window']}, "
        f"processed {ctx['processed_window']}; decode step median {dec_ms:.2f} ms; "
        f"ttft p50 {ttft_ms} ms")

    metrics = {}
    for mt in (cell.per_layer if trace else cell.end_to_end):
        v = mt.reader.read(ctx)
        if v is None:
            continue
        if not math.isfinite(v):
            raise RuntimeError(f"{mt.name} is not finite")
        metrics[mt.name] = {"value": float(v), "unit": mt.unit}
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else dev.type),
            "count": cell.chips, "memory_peak_bytes": mem_peak}
    failed = len(sent) - len(served) + wrong_req
    result = {"correct": passes(checks), "attempted": len(sent), "failed": failed,
              "metrics": metrics, "device": info,
              "requests": {"sent": len(sent), "succeeded": len(sent) - failed,
                           "failed": failed, "ttft_p50_ms": ttft_ms}}
    if summary is not None:
        info["busy_s"] = summary["busy_s"]
        info["window_s"] = ctx["sub"]["wall_s"]
        result["breakdown"] = {"device_ops": [list(x) for x in summary["device_ops"]],
                               "idle_gaps": [list(x) for x in summary["idle_gaps"]]}
    if ctl_checks is not None:
        result["control"] = {"correct": passes(ctl_checks), "checks": ctl_checks}
    result["checks"] = checks
    return result


def step_tokens(n_steps: int, admit_step: dict, finish_step: dict,
                lengths: dict) -> np.ndarray:
    """Output tokens delivered at the end of each step.  A request admitted
    at step s and finished at step f with n tokens delivered two at s and
    one at every later step when f - s + 2 == n (one token a decoded row a
    step, one from the prefill); otherwise all n count at f, where they are
    known to have come."""
    out = np.zeros(n_steps, np.int64)
    for rid, f in finish_step.items():
        s, n = admit_step.get(rid), lengths[rid]
        if s is not None and f - s + 2 == n:
            out[s] += 2
            out[s + 1:f + 1] += 1
        else:
            out[f] += n
    return out


# -- the check ---------------------------------------------------------------

def _blocks(lengths: list[int], chunk: int):
    """Sequences (by index) in blocks of like length: each block padded to
    a multiple of ``chunk``, its rows times its length at most
    ``BLOCK_TOKENS`` (one row at least)."""
    order = sorted(range(len(lengths)), key=lambda i: lengths[i])
    out, cur = [], []
    for i in order:
        s_pad = -(-lengths[i] // chunk) * chunk
        if cur and (len(cur) + 1) * s_pad > BLOCK_TOKENS:
            out.append(cur)
            cur = []
        cur.append(i)
    if cur:
        out.append(cur)
    return out


def check_tokens(ref, m: dict, weights: dict, traffic, served, unfinished: int, *,
                 tol: float, dev, control: bool):
    """Teacher-force every finished request (its prompt, then its served
    tokens but the last) through the reference's full forward, in blocks,
    and read at every generated position the gap by which the served
    token's reference logit lies below the reference's largest.  With
    ``control``, the control (the reference with float8 e4m3 matrices)
    picks its own greedy token at the same positions, and its gap is read
    the same way.  Returns ({name: {value, limit}}, the control's or None,
    log lines, finished requests with a token over ``tol``)."""
    import torch

    ref.exact()
    w = ref.as_f32(_to(weights, dev))
    wc = ref.fp8(w) if control else None
    chunk = int(m["ssm_chunk"])
    seqs = [np.concatenate([traffic.prompts[i], np.asarray(out[:-1], np.int64)])
            for i, out in served]
    gaps, ctl_gaps, wrong_req, ties = [], [], 0, 0
    with torch.inference_mode():
        for blk in _blocks([len(s) for s in seqs], chunk):
            s_pad = -(-max(len(seqs[i]) for i in blk) // chunk) * chunk
            toks = np.zeros((len(blk), s_pad), np.int64)
            rows, pos, want, slot = [], [], [], []
            for r, i in enumerate(blk):
                toks[r, :len(seqs[i])] = seqs[i]
                idx, out = served[i]
                p = len(traffic.prompts[idx])
                n = len(out)
                rows += [r] * n
                pos += range(p - 1, p - 1 + n)
                want += list(out)
                slot += [int(traffic.slots[idx])] * n
            toks_t = torch.from_numpy(toks).to(dev)
            sel = (torch.as_tensor(rows, device=dev), torch.as_tensor(pos, device=dev))
            h = ref.hidden(w, toks_t, m)[sel]
            hc = ref.hidden(wc, toks_t, m)[sel] if control else None
            want_t = torch.as_tensor(want, device=dev)
            slot_t = torch.as_tensor(slot, device=dev)
            g_blk = []
            for a in range(0, h.shape[0], LOGIT_ROWS):
                z = slice(a, a + LOGIT_ROWS)
                lg = ref.logits(w, h[z], slot_t[z], m)
                top2 = lg.topk(2, dim=-1).values
                best = top2[:, 0]
                ties += int(((top2[:, 0] - top2[:, 1]) < tol).sum())
                g_blk.append(best - lg.gather(1, want_t[z, None])[:, 0])
                if control:
                    pick = ref.logits(wc, hc[z], slot_t[z], m).argmax(-1)
                    ctl_gaps.append((best - lg.gather(1, pick[:, None])[:, 0]).cpu())
            g_blk = torch.cat(g_blk).cpu()
            gaps.append(g_blk)
            owner = torch.as_tensor(rows)
            wrong_req += int(torch.unique(owner[g_blk > tol]).numel())
    gap = torch.cat(gaps) if gaps else torch.zeros(0)
    checks = {
        "wrong_tokens": {"value": int((gap > tol).sum()), "limit": 0},
        "logit_gap_max": {"value": float(gap.max()) if gap.numel() else 0.0,
                          "limit": tol},
        "unfinished_requests": {"value": int(unfinished), "limit": 0},
    }
    note = [f"compared {gap.numel()} served tokens of {len(served)} finished "
            f"requests with the float32 reference; {ties} positions whose "
            f"reference top two lie within tol {tol} (compared all the same)"]
    ctl_checks = None
    if control:
        cg = torch.cat(ctl_gaps) if ctl_gaps else torch.zeros(0)
        ctl_checks = dict(checks,
                          wrong_tokens={"value": int((cg > tol).sum()), "limit": 0},
                          logit_gap_max={"value": float(cg.max()) if cg.numel() else 0.0,
                                         "limit": tol})
        note.append(f"control (float8 e4m3 matrices): widest gap "
                    f"{ctl_checks['logit_gap_max']['value']:.6f}, "
                    f"{ctl_checks['wrong_tokens']['value']} tokens over tol")
    return checks, ctl_checks, note, wrong_req

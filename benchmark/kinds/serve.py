"""The serving kind: a closed loop of clients on `runtime/engine.py:Engine`.

Set-up, in order: build the kernels (`ops/_build.py`, a cache hit in a
checkout that has built them), draw the configuration's Q8_0 blocks on the
device from the seed (reference/blocks.py), hand them to the port as a
file's tensors through `checkpoint/params.py:load_parameters`, then the
CLI's `unstack_layer_params` and `fuse_layer_weights`, make the Engine with
the mix's slots, context, prefill chunk and decode chunk, and run its
`warmup` over the buckets up to the prefill chunk (the cell's own shapes).

Every client then submits its first request at once, and each submits its
next as soon as its last one finishes (no think time), from this one
thread, between `Engine.step` calls, as `run_forever` interleaves them.
The first `ramp_steps` engine steps of that loop are the ramp, part of
set-up: after that fixed amount of work the slots hold requests at every
stage of prefill and decoding, as a busy server's do, and the window
opens. Set-up's objects leave the garbage collector's scans (`gc.freeze`)
as a long-running server's would. The window closes at the end of the
first step that ends `seconds` after it opened, with a device
synchronization. Each request submitted in the window is timed from
`Job.created` to its first token; one that has none when the window
closes, or failed, ranks above every served one
(`stats.first_token_waits`).

The end-to-end counts come from what the engine shows of each job after
each step: its output tokens (`Job.output_tokens`) and its prompt's
progress (`Job.prompt_tokens`, `Job.reused_tokens` and the pending tokens
of the slot that holds it). The spans (spans.py) only feed per-layer
readings; where they disagree with those counts they are dropped, and the
readings that need them report nothing.

After the window the loop keeps serving, counted in no metric, until the
finished greedy requests hold the check's `target_tokens` or `drain_s`
seconds have passed. Then the peak of device memory is read, the program
is freed, and the oracle (oracle.py) judges a sample of the finished
greedy requests.
"""

from __future__ import annotations

import gc
import sys
import time
from dataclasses import dataclass, field


@dataclass
class Sent:
    """A request as submitted, with what the run saw of it."""

    req: object
    job: object
    in_window: bool
    counted: int = 0  # output tokens already counted
    prefilled: int = 0  # prompt tokens already counted


@dataclass
class Served:
    """What the metric readers read of a serving run."""

    dims: object
    mix: dict
    on_card: bool = False  # ran on a CUDA card (device metrics need one)
    setup_s: float = 0.0
    window_s: float = 0.0
    output_tokens: int = 0  # emitted by steps in the window
    prompt_tokens: int = 0  # prefilled by steps in the window
    completed: int = 0  # requests that finished in the window
    ttft_s: list = field(default_factory=list)  # window requests; inf = failed / unserved
    failed: int = 0  # window requests that failed
    all_failed: int = 0  # requests of the whole run that failed
    unserved: int = 0  # window requests with no first token when the window closed
    steps: list = field(default_factory=list)  # spans.Step of the window
    spans_ok: bool = True  # the spans agree with the engine's public counts
    marks: list = field(default_factory=list)
    trace: object = None  # the traced trace.Slice, or None
    slice_steps: list = field(default_factory=list)
    memory_peak_bytes: int = 0
    finished: list = field(default_factory=list)  # (request, served tokens), greedy


SLICE_S = 2.0  # seconds of a traced slice


def _model_config(dims, mix):
    from llamago_tpu_torch.config import ModelConfig

    if dims.head_dim * dims.n_heads != dims.dim:
        raise ValueError(f"{dims.name}: the port's head size is dim / heads")
    return ModelConfig(
        vocab_size=dims.vocab, dim=dims.dim, n_layers=dims.n_layers, n_heads=dims.n_heads,
        n_kv_heads=dims.n_kv_heads, ffn_dim=dims.ffn, norm_eps=dims.norm_eps,
        rope_theta=dims.rope_theta, max_seq_len=int(mix["context"]), dtype=dims.compute,
        weight_dtype="int8", kv_dtype="int8" if dims.kv_cache == "int8" else dims.kv_cache)


def checkpoint_tensors(dims, seed: int, device) -> dict:
    """The configuration as a Q8_0 file's tensors: matrices as QuantTensor
    blocks in host memory ([out, in], ggml's block_q8_0 bytes), norm gains as
    f32 numpy arrays. Each group is drawn on the device and copied out."""
    from llamago_tpu_torch.checkpoint.quant_file import QuantTensor

    from benchmark.reference.blocks import layer_blocks, norm_gains, pack_q8_0, table_blocks

    def qt(q, s):
        return QuantTensor("q8_0", pack_q8_0(q, s).cpu().numpy(), tuple(q.shape))

    gains = {k: v.cpu().numpy() for k, v in norm_gains(dims, seed, device).items()}
    t = {"tok_embeddings.weight": qt(*table_blocks(dims, seed, "tok_embeddings", device)),
         "output.weight": qt(*table_blocks(dims, seed, "output", device)),
         "norm.weight": gains["norm"]}
    names = {"wq": "attention.wq", "wk": "attention.wk", "wv": "attention.wv",
             "wo": "attention.wo", "w1": "feed_forward.w1", "w2": "feed_forward.w2",
             "w3": "feed_forward.w3"}
    for i in range(dims.n_layers):
        for k, (q, s) in layer_blocks(dims, seed, i, device).items():
            t[f"layers.{i}.{names[k]}.weight"] = qt(q, s)
        t[f"layers.{i}.attention_norm.weight"] = gains["attention_norm"][i]
        t[f"layers.{i}.ffn_norm.weight"] = gains["ffn_norm"][i]
    return t


def build_engine(dims, mix, seed: int, device, note=lambda what: None):
    """The Engine of the cell, warmed up over its own shapes."""
    from llamago_tpu_torch.checkpoint.params import (
        fuse_layer_weights,
        load_parameters,
        unstack_layer_params,
    )
    from llamago_tpu_torch.runtime.engine import Engine
    from llamago_tpu_torch.tokenizer import Vocab

    from benchmark.vocab import byte_pieces

    config = _model_config(dims, mix)
    tensors = checkpoint_tensors(dims, seed, device)
    params = load_parameters(config, tensors, device=device)
    del tensors
    params = fuse_layer_weights(unstack_layer_params(params, config.n_layers))
    note("weights drawn and loaded")
    engine = Engine(config, params, Vocab(byte_pieces(dims.vocab)), slots=int(mix["slots"]),
                    decode_chunk_size=int(mix["decode_chunk"]),
                    prefill_chunk=int(mix["prefill_chunk"]), device=device)
    engine.warmup(max_bucket=int(mix["prefill_chunk"]), include_embed=False)
    note("engine warmed up")
    return engine


def log(ctx, what: str) -> None:
    print(f"[bench] {time.perf_counter() - ctx.t_start:8.2f} s  {what}", file=sys.stderr,
          flush=True)


def _gen(mix, req):
    from llamago_tpu_torch.config import GenerateConfig

    s = mix["sampling"]
    return GenerateConfig(max_tokens=req.max_tokens, ctx_size=int(mix["context"]),
                          temp=0.0 if req.greedy else float(s["temp"]),
                          top_k=int(s["top_k"]), top_p=float(s["top_p"]),
                          repeat_penalty=float(s["repeat_penalty"]),
                          repeat_last_n=int(s["repeat_last_n"]), seed=req.seed,
                          stop_at_eos=False)


def run(ctx) -> Served:
    import torch

    from llamago_tpu_torch.runtime.engine import JobStatus
    from llamago_tpu_torch.ops import _build

    from benchmark.spans import Recorder
    from benchmark.stats import first_token_waits, percentile
    from benchmark.trace import Slice, warm_profiler
    from benchmark.traffic import Traffic

    dims, mix, dev = ctx.dims, ctx.mix, ctx.device
    cuda = dev.type == "cuda"
    log(ctx, "start")
    if cuda:
        _build.build_all()
        log(ctx, "kernels built or found")
    engine = build_engine(dims, mix, ctx.seed, dev, lambda what: log(ctx, what))
    traffic = Traffic(mix, ctx.seed)
    rec = Recorder(engine)
    tracing = ctx.trace and cuda
    if tracing:
        warm_profiler(dev)
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    out = Served(dims=dims, mix=mix, on_card=cuda)

    done = (JobStatus.FINISHED, JobStatus.FAILED)
    sent: list[Sent] = []
    current: list[Sent] = []
    in_window = False

    def submit(client: int) -> Sent:
        req = traffic.next_for(client)
        s = Sent(req, engine.submit(req.text, _gen(mix, req)), in_window)
        sent.append(s)
        return s

    def after_step(counting: bool) -> None:
        holding = {id(sl.job): sl for sl in engine.slots if sl.job is not None}
        for c, s in enumerate(current):
            n = len(s.job.output_tokens)
            p = prefilled(s.job, holding.get(id(s.job)), s.prefilled)
            if counting:
                out.output_tokens += n - s.counted
                out.prompt_tokens += p - s.prefilled
            s.counted, s.prefilled = n, p
            if s.job.status in done:
                if counting and s.job.status == JobStatus.FINISHED:
                    out.completed += 1
                current[c] = submit(c)

    # the ramp: a fixed number of steps of the same closed loop
    current.extend(submit(c) for c in range(traffic.clients))
    for _ in range(int(mix["ramp_steps"])):
        rec.step()
        after_step(counting=False)
    if cuda:
        torch.cuda.synchronize(dev)
    log(ctx, f"ramp: {len(rec.steps)} steps")
    rec.steps.clear()
    rec.marks.clear()
    in_window = True
    gc.collect()
    gc.freeze()
    t0 = time.perf_counter()
    out.setup_s = t0 - ctx.t_start
    # two traced slices, at 30% and 60% of the window, read after it closes:
    # the second stands in if the first comes back lossy
    starts = [0.3, 0.6] if tracing else []
    slices, cur = [], None
    while True:
        if cur is None and starts and time.perf_counter() - t0 >= starts[0] * ctx.seconds:
            starts.pop(0)
            cur = (Slice(dev), len(rec.steps))
            cur[0].start()
        st = rec.step()
        after_step(counting=True)
        if cur is not None and st.t1 - cur[0].t0 >= SLICE_S:
            cur[0].stop()
            slices.append((cur[0], cur[1], len(rec.steps)))
            cur = None
        if st.t1 - t0 >= ctx.seconds:
            break
    if cur is not None:  # the window closed inside a slice: not used
        cur[0].stop()
    if cuda:
        torch.cuda.synchronize(dev)
    out.window_s = time.perf_counter() - t0
    out.steps = list(rec.steps)
    out.marks = list(rec.marks)
    why = rec.disagrees(out.prompt_tokens, out.output_tokens)
    if why:
        log(ctx, f"spans off: {why}; the readings that need them report nothing")
        out.spans_ok, out.steps, out.marks, slices = False, [], [], []
    for sl, first, last in slices:
        # a lossy trace: fewer device operations than one a layer a step
        if sl.collect() >= (last - first) * dims.n_layers:
            out.trace, out.slice_steps = sl, out.steps[first:last]
            break

    window_end = time.time()
    window_reqs = [s for s in sent if s.in_window]
    gaps = sorted(st.t1 - st.t0 for st in rec.steps)
    log(ctx, f"steps' host ms: median {1e3 * gaps[len(gaps) // 2]:.1f}, "
             f"p90 {1e3 * gaps[int(len(gaps) * 0.9)]:.1f}, max {1e3 * gaps[-1]:.1f}")
    log(ctx, f"window {out.window_s:.3f} s: {len(rec.steps)} steps, "
             f"{sum(1 for st in out.steps if st.forwards > 1)} decode chunks, "
             f"{sum(len(st.prefills) for st in out.steps)} prefill chunks, "
             f"{out.completed} requests completed, "
             f"{len(window_reqs)} submitted, "
             f"{out.output_tokens} output and {out.prompt_tokens} prompt tokens; "
             f"traced slice: {len(out.slice_steps)} steps")

    timeline = []
    for s in window_reqs:
        j = s.job
        failed = j.status == JobStatus.FAILED
        out.failed += failed
        out.unserved += not failed and not j.output_tokens
        first = j.started + j.ttft_ms / 1e3 if j.output_tokens and not failed else None
        timeline.append((j.created, first, failed))
    out.ttft_s = first_token_waits(timeline, window_end)
    if out.ttft_s:
        log(ctx, f"first-token waits of the window's requests (s): p50 "
                 f"{percentile(out.ttft_s, 50):.3f}, p95 {percentile(out.ttft_s, 95):.3f}; "
                 f"{out.unserved} had no first token when the window closed")

    # the drain: served, counted in no metric, until the check has its tokens
    c = mix["check"]
    t_drain = time.perf_counter()
    while (greedy_tokens(sent, int(c["max_requests"])) < int(c["target_tokens"])
           and time.perf_counter() - t_drain < float(mix.get("drain_s", 0))):
        engine.step()
        after_step(counting=False)
    log(ctx, f"drain: {time.perf_counter() - t_drain:.2f} s")
    if cuda:
        out.memory_peak_bytes = int(torch.cuda.max_memory_allocated(dev))
    out.finished = [(s.req, list(s.job.output_tokens)) for s in sent
                    if s.req.greedy and s.job.status == JobStatus.FINISHED]
    out.all_failed = sum(1 for s in sent if s.job.status == JobStatus.FAILED)

    del engine, rec, current, sent, window_reqs
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


def prefilled(job, slot, before: int) -> int:
    """Prompt tokens of `job` in the cache so far, from what the engine
    shows: none while queued, all but the slot's pending ones once admitted
    (a reused prefix is not prefilled), all once it has left its slot. A
    job that failed keeps `before`."""
    from llamago_tpu_torch.runtime.engine import JobStatus

    if job.status == JobStatus.QUEUED:
        return 0
    if job.status == JobStatus.FAILED:
        return before
    fed = job.prompt_tokens - job.reused_tokens
    return fed - len(slot.pending) if slot is not None else fed


def greedy_tokens(sent: list, max_requests: int) -> int:
    """Served tokens of the longest `max_requests` finished greedy requests."""
    from llamago_tpu_torch.runtime.engine import JobStatus

    n = sorted((len(s.job.output_tokens) for s in sent
                if s.req.greedy and s.job.status == JobStatus.FINISHED), reverse=True)
    return sum(n[:max_requests])


def check(ctx, run: Served) -> tuple[dict, dict | None]:
    """The numbers compared, each {value, limit}, and None; with the control
    (ctx.control), the gap compared is the control's, so that `passes`
    judges it as it judges the program, and the second item holds the
    program's own gap of the run."""
    from benchmark.oracle import pick, served_gaps

    c = ctx.mix["check"]
    sample = pick(run.finished, ctx.seed, int(c["max_requests"]), int(c["target_tokens"]))
    wrong = sum(1 for req, toks in sample
                if len(toks) != req.max_tokens or not all(0 <= t < ctx.dims.vocab for t in toks))
    tokens = sum(len(t) for _, t in sample)
    gap = ctrl = None
    t0 = time.perf_counter()
    if sample:
        gaps, cg = served_gaps(ctx.dims, ctx.seed, sample, ctx.device, control=ctx.control)
        gap = float(max(float(g.max()) for g in gaps))
        if cg is not None:
            ctrl = {"program_max_logit_gap": gap}
            gap = float(max(float(g.max()) for g in cg))
    log(ctx, f"reference over {len(sample)} requests, {tokens} served tokens: "
             f"{time.perf_counter() - t0:.2f} s")
    lim = ctx.limits
    numbers = {
        "max_logit_gap": {"value": gap, "limit": float(lim["max_logit_gap"]["limit"])},
        "checked_tokens": {"value": tokens, "limit": int(c["min_tokens"])},
        "wrong_lengths": {"value": wrong, "limit": 0},
        "failed_requests": {"value": run.all_failed, "limit": 0},
    }
    return numbers, ctrl


def passes(numbers: dict) -> bool:
    """Every number within its limit: the gap and the counts of faults at or
    below theirs, the checked tokens at or above theirs."""
    n = numbers
    return (n["max_logit_gap"]["value"] is not None
            and n["max_logit_gap"]["value"] <= n["max_logit_gap"]["limit"]
            and n["checked_tokens"]["value"] >= n["checked_tokens"]["limit"]
            and n["wrong_lengths"]["value"] <= 0 and n["failed_requests"]["value"] <= 0)


"""Generation engine: continuously-batched prefill/decode with context swap.

Counterpart of the JAX package's `runtime/engine.py` (reference: the pods
scheduler and per-job loop, pkg/server/server.go:84-278). ONE resident
model decodes a slot-batched step; "pods" are decode slots:

  * admission: a queued job is tokenized (leading space + BOS,
    server.go:120-124) and its prompt prefilled into a free slot's cache
    rows in bucket-sized chunks interleaved with decode steps, reusing
    any prefix the slot's previous contents share;
  * decode: every iteration samples one token for all active slots from
    the pending logits, then runs one batched forward step, or a chunk of
    `decode_chunk_size` steps with one host sync (runtime/decode_loop.py);
  * context swap (server.go:165-172): when a slot hits the context limit,
    keep the first keep_count positions, re-feed half of the remaining
    most-recent tokens, and continue;
  * per-job tok/s accounting (server.go:244-274), and the spans of every
    step (runtime/spans.py): admission, each launch, each host wait on the
    device.

Inactive rows still flow through the batched forward and still write one
cache row per step (the cache write clamps like dynamic_update_slice,
runtime/kv_cache.py); `_decode_positions` parks them where that write is
harmless. With `speculative=True`, all-greedy batches take prompt-lookup
speculative decoding (runtime/speculative.py) while their drafts keep
being accepted.

Under a mesh (parallel/) every rank runs its own Engine over its blocks of
the weights and of the cache, with the same host state: the forward's
collectives bind the ranks, and the logits every rank samples from are the
whole [slots, vocab] (gathered over tp and dp), sampled with the same
per-slot generators. Lockstep admission keeps the host state equal:
`enable_lockstep_admission` lets `step` admit only the jobs every rank
agreed on (parallel/multihost.py:serve_lockstep broadcasts them), embedding
requests ride the same broadcast (`embed_routed`, `run_embeds`), and
deadline expiry is decided on rank 0 (`expired_job_ids`, `apply_expiry`).
"""

from __future__ import annotations

import contextlib
import threading
import time
import uuid
from dataclasses import dataclass, field
from enum import Enum

import numpy as np
import torch

from llamago_tpu_torch.config import GenerateConfig, ModelConfig
from llamago_tpu_torch.models.llama import forward_impl, prefill_into_slot
from llamago_tpu_torch.ops.sampling import SamplerState, push_tokens, reset_slots, sample
from llamago_tpu_torch.parallel.tp_kernels import active_mesh
from llamago_tpu_torch.runtime.kv_cache import KVCache
from llamago_tpu_torch.runtime.spans import H2D, READ_CHUNK, READ_SPEC, READ_TOKENS, SPANS
from llamago_tpu_torch.tokenizer import EOS_TOKEN, Vocab, detokenize, tokenize
from llamago_tpu_torch.utils import debug as _dbg
from llamago_tpu_torch.utils.device import resolve_device

DEFAULT_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096)


class JobStatus(str, Enum):
    QUEUED = "queued"
    PROCESSING = "processing"
    FINISHED = "finished"
    FAILED = "failed"


@dataclass
class Job:
    id: str
    prompt: str
    gen: GenerateConfig
    status: JobStatus = JobStatus.QUEUED
    created: float = field(default_factory=time.time)
    started: float = 0.0
    finished: float = 0.0
    prompt_tokens: int = 0
    reused_tokens: int = 0  # prompt prefix served from cached KV
    output_tokens: list[int] = field(default_factory=list)
    output: str = ""
    error: str = ""
    ttft_ms: float = 0.0

    @property
    def tokens_per_second(self) -> float:
        dur = (self.finished or time.time()) - self.started
        return len(self.output_tokens) / dur if dur > 0 else 0.0


@dataclass
class _Slot:
    job: Job | None = None
    pos: int = 0                      # next cache position to write
    history: list[int] = field(default_factory=list)  # prompt + generated
    remaining: int = 0
    # prompt tokens admitted but not yet prefilled (absorbed one chunk per
    # engine step, so a long prompt cannot freeze the other slots)
    pending: list[int] = field(default_factory=list)
    # first cache position that stopped mirroring `history` (set by a
    # context swap or by parking); None = cache[p] == history[p] for all
    # p < pos, which prefix reuse relies on
    swap_point: int | None = None

    @property
    def free(self) -> bool:
        return self.job is None

    @property
    def decodable(self) -> bool:
        """Holds a job whose prompt is fully prefilled (logits pending)."""
        return self.job is not None and not self.pending

    @property
    def mapped(self) -> int:
        """Leading cache positions that mirror history (reusable KV)."""
        n = min(self.pos, len(self.history))
        return n if self.swap_point is None else min(n, self.swap_point)


class Engine:
    """One resident model serving up to `slots` concurrent jobs on
    `device` (cuda unless the caller passes "cpu")."""

    # static top-K ladder: the sampler's candidate count is one of these
    # (per-request K is applied by masking inside it), so top_k <= 0
    # ("full vocab") keeps its meaning
    _TOPK_LADDER = (128, 512, 2048)

    def __init__(
        self,
        config: ModelConfig,
        params,
        vocab: Vocab,
        slots: int = 1,
        buckets: tuple[int, ...] = DEFAULT_BUCKETS,
        decode_chunk_size: int = 1,
        speculative: bool = False,
        draft_len: int = 7,
        prefill_chunk: int = 256,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.config = config
        self.params = params
        self.vocab = vocab
        self.n_slots = slots
        self.buckets = tuple(b for b in buckets if b <= config.max_seq_len) or (
            config.max_seq_len,)
        self.cache = self._make_cache()
        self.sampler_state = SamplerState.create(
            slots, config.max_seq_len, config.vocab_size, device=self.device)
        self.logits = torch.zeros((slots, config.vocab_size), dtype=torch.float32,
                                  device=self.device)
        self.generators = [self._generator(i) for i in range(slots)]
        self.slots = [_Slot() for _ in range(slots)]
        self.decode_chunk_size = decode_chunk_size
        # prompt-lookup speculative decoding for all-greedy batches
        self.speculative = speculative
        self.draft_len = draft_len
        # Adaptive gate: a verify step streams every weight whether or not
        # its drafts land, so on text that does not repeat it emits about
        # one token per weight stream and loses to chunked decode. Each
        # slot keeps an EMA of accepted drafts per step, starting at the
        # optimistic draft_len; while every active slot's EMA is below the
        # threshold, _spec_steps yields to chunked decode and only probes
        # with one verify step every spec_probe_interval decisions.
        self.spec_accept_ema = np.full(slots, float(draft_len), np.float32)
        self.spec_gate_threshold = 1.5  # accepted drafts per step
        self.spec_probe_interval = 8  # gated decisions between probes
        self._spec_probe_countdown = 0
        self._spec_probing = False  # the last decision was a probe
        self.prefill_chunk = max(16, min(prefill_chunk, self.buckets[-1]))
        self._queue: list[Job] = []
        # None = every queued job is admissible (one process). Lockstep
        # serving sets 0 (enable_lockstep_admission): step() then admits
        # only the first _agreed_n jobs, the prefix every rank agreed on
        self._agreed_n: int | None = None
        # lockstep embedding requests: an HTTP thread must not run a forward
        # that holds collectives on rank 0 alone; the request waits here for
        # the tick's broadcast, and every rank computes it (embed_routed)
        self._embed_pending: list[tuple[str, str, threading.Event, dict]] = []
        self._embed_inflight: dict[str, tuple[threading.Event, dict]] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._wake = threading.Event()
        self._eos_ids = frozenset(
            getattr(vocab, "stop_ids", None)
            or {getattr(vocab, "eos_id", EOS_TOKEN)})

    def _generator(self, seed: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(seed)
        return g

    def _tensor(self, arr, dtype=None) -> torch.Tensor:
        # a blocking copy from pageable memory: on the card it waits for the
        # work queued before it
        with SPANS.wait(H2D):
            return torch.as_tensor(np.asarray(arr), dtype=dtype, device=self.device)

    def _first_eos(self, emitted: list[int]) -> int:
        for i, t in enumerate(emitted):
            if t in self._eos_ids:
                return i
        return -1

    def _halving_rungs(self) -> list[int]:
        """Every n_steps the speculative path can select (the halving
        ladder of _spec_steps)."""
        rungs = []
        n = max(1, self.decode_chunk_size)
        while n >= 1:
            rungs.append(n)
            if n == 1:
                break
            n //= 2
        return rungs

    def _make_cache(self) -> KVCache:
        """The slots' cache: under a mesh this rank's block of it, so that
        warmup's wipe and _rebuild_device_state keep the layout."""
        return KVCache.create(self.config, batch=self.n_slots, device=self.device,
                              mesh=active_mesh())

    # ------------------------------------------------------------- queue

    def submit(self, prompt: str, gen: GenerateConfig, job_id: str | None = None) -> Job:
        """Queue a job (reference: PlaceJob, server.go:282-305)."""
        job = Job(id=job_id or str(uuid.uuid4()), prompt=prompt, gen=gen)
        with self._lock:
            self._queue.append(job)
        self._wake.set()
        return job

    def embed(self, text: str) -> tuple[np.ndarray, int]:
        """Embedding of `text`: the final-RMSNorm'd hidden state at the last
        prompt position (reference: llama.go:412-419), computed on a
        scratch 1-slot cache so decode slots stay untouched. Returns
        (embedding f32 [dim], prompt_token_count)."""
        prefix = " " if getattr(self.vocab, "space_prefix", True) else ""
        ids = tokenize(self.vocab, prefix + text, bos=True)
        if len(ids) > self.buckets[-1]:
            raise ValueError(
                f"input of {len(ids)} tokens exceeds the largest prefill "
                f"bucket {self.buckets[-1]}")
        return self._embed_ids(ids)

    def _embed_ids(self, ids: list[int]) -> tuple[np.ndarray, int]:
        bucket = self._bucket(len(ids))
        padded = ids + [0] * (bucket - len(ids))
        cache = KVCache.create(self.config, batch=1, max_seq=bucket, device=self.device,
                               mesh=active_mesh())
        with (torch.cuda.device(self.device) if self.device.type == "cuda"
              else contextlib.nullcontext()):
            _, _, emb = forward_impl(
                self.params, self._tensor([padded], torch.long), cache,
                torch.zeros(1, dtype=torch.long, device=self.device), self.config,
                logit_index=self._tensor([len(ids) - 1], torch.long),
                return_embedding=True)
            return emb[0].cpu().numpy().astype(np.float32), len(ids)

    def embed_routed(self, text: str, timeout_s: float = 120.0) -> tuple[np.ndarray, int]:
        """`embed` that an HTTP handler thread may call. One process: it
        computes at once. Under lockstep admission the forward holds
        collectives, so it must run on every rank: the request waits for the
        next tick's broadcast (parallel/multihost.py:serve_lockstep ->
        run_embeds), and the handler blocks on the result."""
        if self._agreed_n is None:
            return self.embed(text)
        done = threading.Event()
        box: dict = {}
        with self._lock:
            self._embed_pending.append((str(uuid.uuid4()), text, done, box))
        self._wake.set()
        if not done.wait(timeout_s):
            raise TimeoutError("embedding request timed out awaiting the lockstep tick")
        if "error" in box:
            raise box["error"]
        return box["result"]

    def drain_embeds(self) -> list[dict]:
        """Rank 0, each tick: take the queued embedding requests for the
        broadcast; their waiters stay registered until run_embeds."""
        with self._lock:
            pending, self._embed_pending = self._embed_pending, []
            for rid, _text, done, box in pending:
                self._embed_inflight[rid] = (done, box)
        return [{"id": rid, "text": text} for rid, text, _, _ in pending]

    def run_embeds(self, reqs: list[dict]) -> None:
        """Every rank, each tick: compute the broadcast embedding requests in
        their order. A too-long input fails the same way on every rank, so
        the error is kept for the waiter, not raised."""
        for r in reqs:
            try:
                result, err = self.embed(r["text"]), None
            except ValueError as e:
                result, err = None, e
            waiter = self._embed_inflight.pop(r["id"], None)
            if waiter is None:  # not rank 0: nobody waits here
                continue
            done, box = waiter
            if err is not None:
                box["error"] = err
            else:
                box["result"] = result
            done.set()

    # --------------------------------------------------------- admission

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _fits(self, reuse: int, n_ids: int) -> bool:
        """Would chunked prefill of ids[reuse:] at write_pos=reuse keep every
        padded bucket inside the cache? A bucket past the end would have
        its start clamped and overwrite valid reused rows."""
        p, rem = reuse, n_ids - reuse
        s = self.config.max_seq_len
        while rem > 0:
            c = min(self.prefill_chunk, rem)
            if p + self._bucket(c) > s:
                return False
            p += c
            rem -= c
        return True

    def _admit(self, slot_idx: int, job: Job) -> None:
        # the `admit` span: a = the slot (-1 if the job failed), b = prompt tokens
        with SPANS.span("admit", job.id, slot_idx) as span:
            if not self._place(slot_idx, job):
                span.a = -1
            span.b = job.prompt_tokens

    def _place(self, slot_idx: int, job: Job) -> bool:
        """Tokenize `job` into slot `slot_idx`; False if it failed there."""
        slot = self.slots[slot_idx]
        gen = job.gen
        job.started = time.time()

        prefix = " " if getattr(self.vocab, "space_prefix", True) else ""
        ids = tokenize(self.vocab, prefix + job.prompt, bos=True)
        ctx = min(gen.ctx_size, self.config.max_seq_len)
        if len(ids) >= ctx:
            job.status = JobStatus.FAILED
            job.error = f"prompt is too long: {len(ids)} tokens >= context {ctx}"
            job.finished = time.time()
            return False

        job.status = JobStatus.PROCESSING
        job.prompt_tokens = len(ids)

        # per-slot prefix caching: prefill only the suffix the slot's
        # previous contents do not already hold
        reuse = 0
        old = slot.history[: slot.mapped]
        while reuse < len(old) and reuse < len(ids) - 1 and old[reuse] == ids[reuse]:
            reuse += 1
        while reuse > 0 and not self._fits(reuse, len(ids)):
            reuse = max(0, reuse - 16)
        if not self._fits(reuse, len(ids)):
            job.status = JobStatus.FAILED
            job.error = (f"prompt of {len(ids)} tokens does not fit the "
                         f"context layout (context {ctx}, prefill buckets "
                         f"{self.buckets})")
            job.finished = time.time()
            return False
        job.reused_tokens = reuse
        _dbg.check(0 <= reuse <= slot.mapped,
                   "reuse exceeds the slot's mapped prefix",
                   reuse=reuse, mapped=slot.mapped)

        slot.job = job
        slot.history = list(ids)
        slot.remaining = gen.max_tokens
        # a new tenant inherits the slot's acceptance EMA: resetting it to
        # the optimistic prior would force a speculative burst at the start
        # of every job under churn; the periodic probes of _spec_steps
        # re-open the gate within one probe interval when the traffic
        # really repeats itself
        slot.swap_point = None
        slot.pos = reuse
        slot.pending = list(ids[reuse:])
        seed = gen.seed if gen.seed >= 0 else time.time_ns() % (2**31)
        self.generators[slot_idx].manual_seed(seed)

        # reset the repeat-penalty window (per-request size, server.go:127-138),
        # then feed the prompt into it (server.go:187-198)
        mask = np.zeros(self.n_slots, bool)
        mask[slot_idx] = True
        window = np.full(self.n_slots,
                         max(1, min(gen.repeat_last_n or ctx, self.config.max_seq_len)),
                         np.int64)
        reset_slots(self.sampler_state, self._tensor(mask), self._tensor(window))
        self._push_slot_tokens(slot_idx, ids)
        return True

    def _advance_prefills(self) -> bool:
        """Absorb ONE pending prefill chunk (at most) into its slot."""
        for i, slot in enumerate(self.slots):
            if slot.job is None or not slot.pending:
                continue
            chunk = slot.pending[: self.prefill_chunk]
            _dbg.check(
                slot.pos + self._bucket(len(chunk)) <= self.config.max_seq_len,
                "prefill chunk bucket would clamp past the cache end",
                pos=slot.pos, chunk=len(chunk))
            self._prefill(i, chunk, write_pos=slot.pos)
            slot.pos += len(chunk)
            slot.pending = slot.pending[len(chunk):]
            return True
        return False

    def _push_slot_tokens(self, slot_idx: int, ids: list[int]) -> None:
        toks = np.full((self.n_slots, len(ids)), -1, np.int64)
        toks[slot_idx] = ids
        active = np.zeros(self.n_slots, bool)
        active[slot_idx] = True
        push_tokens(self.sampler_state, self._tensor(toks), self._tensor(active))

    def _prefill(self, slot_idx: int, ids: list[int], write_pos: int) -> None:
        bucket = self._bucket(len(ids))
        if write_pos + bucket > self.config.max_seq_len:
            raise ValueError(
                f"prefill bucket overruns cache: write_pos={write_pos} "
                f"bucket={bucket} max_seq_len={self.config.max_seq_len}")
        padded = np.zeros((1, bucket), np.int64)
        padded[0, : len(ids)] = ids
        job = self.slots[slot_idx].job
        with SPANS.span("prefill", job and job.id, len(ids), write_pos):
            logits, self.cache = prefill_into_slot(
                self.params, self._tensor(padded), self.cache, slot_idx,
                self._tensor([write_pos], torch.long),
                self._tensor([len(ids) - 1], torch.long), self.config)
            self.logits[slot_idx] = logits

    # ------------------------------------------------------ context swap

    def _maybe_context_swap(self, slot_idx: int) -> None:
        """Context-swap eviction (server.go:160-172): on overflow keep the
        first `keep_count` positions and re-feed half of the last
        (ctx - keep) evaluated tokens; the pending token then goes through
        the normal decode step exactly once."""
        slot = self.slots[slot_idx]
        gen = slot.job.gen
        ctx = min(gen.ctx_size, self.config.max_seq_len)
        if slot.pos + 1 <= ctx:
            return
        keep = min(gen.keep_count, ctx // 2)
        left = slot.pos - keep
        evaluated = slot.history[:-1]  # pending token is history[-1]
        refeed = evaluated[len(evaluated) - left // 2:] if left // 2 else []
        if refeed:
            with SPANS.span("swap", slot.job.id, len(refeed)):
                self._prefill(slot_idx, refeed, write_pos=keep)
        slot.pos = keep + len(refeed)
        slot.swap_point = keep if slot.swap_point is None else min(slot.swap_point, keep)

    # ------------------------------------------------------------- step

    def _gather_gen_arrays(self):
        temp = np.ones(self.n_slots, np.float32)
        top_k = np.ones(self.n_slots, np.int64)
        top_p = np.ones(self.n_slots, np.float32)
        rp = np.ones(self.n_slots, np.float32)
        active = np.zeros(self.n_slots, bool)
        for i, s in enumerate(self.slots):
            if s.decodable:
                g = s.job.gen
                temp[i], top_p[i], rp[i] = g.temp, g.top_p, g.repeat_penalty
                # top_k <= 0 means "disabled: use the full vocab"
                top_k[i] = g.top_k if g.top_k > 0 else self.config.vocab_size
                active[i] = True
        return temp, top_k, top_p, rp, active

    def _static_top_k(self, top_k: np.ndarray, active: np.ndarray) -> int:
        need = int(top_k[active].max()) if active.any() else 1
        for k in self._TOPK_LADDER:
            if need <= k:
                return min(k, self.config.vocab_size)
        return self.config.vocab_size

    def _decode_positions(self, active: np.ndarray, writes: int) -> np.ndarray:
        """Per-slot cache positions for a decode forward that performs
        `writes` sequential cache writes per batch row. Inactive rows are
        parked where their writes cannot clobber live data: a slot
        mid-prefill at its prefill cursor; a free slot at its mapped-prefix
        end (lower, shrinking the mapping, if that would overrun)."""
        s_max = self.cache.max_seq * self.cache.seq_split  # all positions, under sp too
        pos = np.zeros(self.n_slots, np.int64)
        for i, slot in enumerate(self.slots):
            if active[i]:
                pos[i] = slot.pos
            elif slot.job is not None:
                pos[i] = min(slot.pos, s_max - 1)
            else:
                park = min(slot.mapped, max(s_max - writes, 0))
                pos[i] = park
                if park < slot.mapped:
                    slot.swap_point = park if slot.swap_point is None else min(
                        slot.swap_point, park)
        return pos

    def step(self) -> bool:
        """One engine iteration. Returns True if any work was done."""
        with SPANS.step():
            with self._lock:
                for i, slot in enumerate(self.slots):
                    if not self._queue or self._agreed_n == 0:
                        # lockstep admits only the agreed prefix of the queue:
                        # a job submitted since the drain waits for the next tick
                        break
                    if slot.free:
                        job = self._queue.pop(0)
                        if self._agreed_n is not None:
                            self._agreed_n -= 1
                        self._admit(i, job)

            did_prefill = self._advance_prefills()

            temp, top_k, top_p, rp, active = self._gather_gen_arrays()
            if not active.any():
                return did_prefill

            # --- sample one token per active slot from the pending logits
            rows = int(active.sum())
            with SPANS.span("sample", a=rows):
                tokens_dev = sample(
                    self.logits, self.sampler_state, self._tensor(temp), self._tensor(top_k),
                    self._tensor(top_p), self._tensor(rp), self.generators,
                    max_top_k=self._static_top_k(top_k, active))
                with SPANS.wait(READ_TOKENS):
                    tokens = tokens_dev.tolist()
                push_tokens(self.sampler_state, tokens_dev[:, None], self._tensor(active))

            now = time.time()
            for i, slot in enumerate(self.slots):
                if slot.job is None or not active[i]:
                    continue
                tok = int(tokens[i])
                job = slot.job
                job.output_tokens.append(tok)
                if len(job.output_tokens) == 1:
                    job.ttft_ms = (now - job.started) * 1000.0
                slot.history.append(tok)
                slot.remaining -= 1
                stopped = self._publish_output(job)
                if (stopped or slot.remaining <= 0
                        or (job.gen.stop_at_eos and tok in self._eos_ids)):
                    self._finish(slot)
                    active[i] = False

            if not active.any():
                return True

            for i in range(self.n_slots):
                if active[i]:
                    self._maybe_context_swap(i)

            n_spec = self._spec_steps(active, temp)
            if n_spec > 0:
                self._decode_speculative(active, n_spec)
                return True

            n_chunk = self._chunkable(active)
            if n_chunk > 1:
                self._decode_chunked(active, n_chunk, temp, top_k, top_p, rp)
                return True

            feed = np.zeros((self.n_slots, 1), np.int64)
            pos = self._decode_positions(active, writes=1)
            for i, slot in enumerate(self.slots):
                if active[i]:
                    feed[i, 0] = slot.history[-1]
            rows = int(active.sum())
            # the `decode` span: a = rows, b = the sum of their cache positions
            with SPANS.span("decode", None, rows, int(pos[active].sum())):
                self.logits, self.cache = forward_impl(
                    self.params, self._tensor(feed), self.cache, self._tensor(pos), self.config)
            for i, slot in enumerate(self.slots):
                if active[i] and slot.job is not None:
                    slot.pos += 1
            return True

    # ------------------------------------------------- speculative decode

    def _spec_steps(self, active: np.ndarray, temp: np.ndarray) -> int:
        """Speculative steps to run now (0: none). Only all-greedy batches
        speculate (temp <= 0 is pure argmax in ops/sampling.py, so
        prompt-lookup greedy is lossless), never while a prefill is in
        flight or a queued job could enter a free slot, and only with
        context headroom for the worst case."""
        if not self.speculative:
            return 0
        if any(active[i] and temp[i] > 0 for i in range(self.n_slots)):
            return 0
        if any(s.pending for s in self.slots):
            return 0
        with self._lock:
            if self._queue and self._agreed_n != 0 and any(s.free for s in self.slots):
                return 0
        probing = False
        emas = [self.spec_accept_ema[i] for i in range(self.n_slots) if active[i]]
        # Occupancy-aware threshold: chunked decode emits n_active tokens per
        # weight stream with one host sync per chunk, while each speculative
        # dispatch waits for its tokens on the host before its restore
        # forward, so with more active slots speculation must clear a
        # higher bar. The
        # occupancy term (not the floor) is capped at draft_len - 1: the EMA
        # never exceeds draft_len, and an unreachable bar would close the
        # gate for good while the probes kept costing; capping the whole
        # expression would zero the floor at draft_len = 1.
        thresh = max(self.spec_gate_threshold,
                     min(0.875 * float(len(emas)), float(self.draft_len) - 1.0))
        if emas and max(emas) < thresh:
            if self._spec_probe_countdown > 0:
                self._spec_probe_countdown -= 1
                return 0
            self._spec_probe_countdown = self.spec_probe_interval
            probing = True
        self._spec_probing = probing
        allowed = max(1, self.decode_chunk_size)
        per_step = self.draft_len + 1
        rem_max = 0
        for i, slot in enumerate(self.slots):
            if not active[i] or slot.job is None:
                continue
            ctx = min(slot.job.gen.ctx_size, self.config.max_seq_len)
            headroom = ctx - slot.pos - 2
            allowed = min(allowed, max(headroom // per_step, 0))
            rem_max = max(rem_max, slot.remaining)
        if probing:
            allowed = min(allowed, 1)
        # bound by the token budget at the EXPECTED emission per step
        # (1 + the acceptance EMA): bounding at full acceptance would shrink
        # the rungs to a step or two for most of a job, each paying its
        # host syncs. The overshoot is trimmed on the host, as chunked
        # decode's is.
        expected = 1.0 + max(float(np.mean(emas)) if emas else 0.0, 0.0)
        allowed = min(allowed, max(1, -(-rem_max // max(int(expected), 1))))
        if allowed < 1:
            return 0
        # the largest rung that fits
        for n in self._halving_rungs():
            if n <= allowed:
                return n
        return 1

    def _decode_speculative(self, active: np.ndarray, n_steps: int) -> None:
        from llamago_tpu_torch.runtime.speculative import speculative_decode_chunk

        h = self.config.max_seq_len
        # history headroom for every token this chunk can emit, so the
        # history writes never hit their clamp and proposals stay aligned
        writes = n_steps * (self.draft_len + 1) + 1
        tail = max(1, h - writes)
        hist = np.zeros((self.n_slots, h), np.int64)
        hlen = np.ones(self.n_slots, np.int64)
        feed = np.zeros(self.n_slots, np.int64)
        pos = self._decode_positions(active, writes=writes)
        for i, slot in enumerate(self.slots):
            if active[i]:
                hs = slot.history[-tail:]
                hist[i, : len(hs)] = hs
                hlen[i] = len(hs)
                feed[i] = slot.history[-1]
        # the `spec` span: a = verify steps, b = 1 if the gate was probing
        with SPANS.span("spec", None, n_steps, int(self._spec_probing)):
            toks, counts, self.cache, pos_out, _, _ = speculative_decode_chunk(
                self.params, self._tensor(feed), self.cache, self._tensor(pos),
                self._tensor(hist), self._tensor(hlen), self.config,
                n_steps=n_steps, draft_len=self.draft_len)
            with SPANS.wait(READ_SPEC):
                toks_h = toks.cpu().numpy()
                counts_h = counts.cpu().numpy()
                pos_h = pos_out.cpu().numpy()
            # restore the pending-logits invariant: one forward of each slot's
            # last emitted token (as the chunked decode's final forward)
            last = np.zeros((self.n_slots, 1), np.int64)
            for i in range(self.n_slots):
                if active[i]:
                    last[i, 0] = toks_h[i, -1, counts_h[i, -1] - 1]
            self.logits, self.cache = forward_impl(
                self.params, self._tensor(last), self.cache, pos_out, self.config)
        for i, slot in enumerate(self.slots):
            if not active[i] or slot.job is None:
                continue
            # the gate's EMA: counts[i, s] = accepted drafts + 1 bonus token
            accepted = float(counts_h[i].mean()) - 1.0
            self.spec_accept_ema[i] = 0.7 * self.spec_accept_ema[i] + 0.3 * accepted
            job = slot.job
            emitted: list[int] = []
            for s in range(n_steps):
                emitted.extend(int(t) for t in toks_h[i, s, : counts_h[i, s]])
            kept = emitted
            if job.gen.stop_at_eos:
                e = self._first_eos(emitted)
                if e >= 0:
                    kept = emitted[: e + 1]
            kept = kept[: slot.remaining]
            job.output_tokens.extend(kept)
            slot.history.extend(kept)
            slot.remaining -= len(kept)
            # history[-1] is in the cache (the bonus via the restore
            # forward, earlier tokens via the verify writes) and
            # self.logits[i] is its successor distribution. A truncation
            # (EOS or budget) always finishes the job below, so the stale
            # logits are never used.
            slot.pos = int(pos_h[i]) + 1
            done = self._publish_output(job) or slot.remaining <= 0 or (
                job.gen.stop_at_eos and kept and kept[-1] in self._eos_ids)
            if done:
                self._finish(slot)

    # ----------------------------------------------------- chunked decode

    def _chunkable(self, active: np.ndarray) -> int:
        """The chunk every active slot can absorb: bounded by context
        headroom (no swap mid-chunk), single steps while a prefill is in
        flight or a queued job could enter a free slot. All or nothing:
        the short tail before a context swap decodes per token."""
        if self.decode_chunk_size <= 1:
            return 1
        if any(s.pending for s in self.slots):
            return 1
        with self._lock:
            if self._queue and self._agreed_n != 0 and any(s.free for s in self.slots):
                return 1
        allowed = self.decode_chunk_size
        for i, slot in enumerate(self.slots):
            if not active[i] or slot.job is None:
                continue
            ctx = min(slot.job.gen.ctx_size, self.config.max_seq_len)
            # a chunk emits n tokens and feeds n+1 positions
            allowed = min(allowed, ctx - slot.pos - 2)
        return self.decode_chunk_size if allowed >= self.decode_chunk_size else 1

    def _decode_chunked(self, active, n_chunk, temp, top_k, top_p, rp) -> None:
        from llamago_tpu_torch.runtime.decode_loop import decode_chunk

        feed = np.zeros(self.n_slots, np.int64)
        pos = self._decode_positions(active, writes=n_chunk + 1)
        for i, slot in enumerate(self.slots):
            if active[i]:
                feed[i] = slot.history[-1]
        rows = int(active.sum())
        # the `decode_chunk` span: a = rows, b = the chunk's steps
        with SPANS.span("decode_chunk", None, rows, n_chunk):
            toks_dev, self.cache, _, self.sampler_state, self.logits = decode_chunk(
                self.params, self._tensor(feed), self.cache, self._tensor(pos),
                self.config, n_chunk, generators=self.generators,
                state=self.sampler_state, temp=self._tensor(temp),
                top_k=self._tensor(top_k), top_p=self._tensor(top_p),
                repeat_penalty=self._tensor(rp), greedy=False,
                return_final_logits=True, max_top_k=self._static_top_k(top_k, active))
            with SPANS.wait(READ_CHUNK):
                toks = toks_dev.tolist()  # one host sync a chunk
        for i, slot in enumerate(self.slots):
            if not active[i] or slot.job is None:
                continue
            job = slot.job
            emitted = [int(t) for t in toks[i]]
            if job.gen.stop_at_eos:
                e = self._first_eos(emitted)
                if e >= 0:
                    emitted = emitted[: e + 1]
            # budget overshoot: tokens past max_tokens are discarded
            emitted = emitted[: max(slot.remaining, 0)]
            job.output_tokens.extend(emitted)
            slot.history.extend(emitted)
            slot.remaining -= len(emitted)
            slot.pos += n_chunk + 1
            done = self._publish_output(job) or slot.remaining <= 0 or (
                job.gen.stop_at_eos and emitted and emitted[-1] in self._eos_ids)
            if done:
                self._finish(slot)

    # ----------------------------------------------------------- warmup

    def warmup(self, max_bucket: int | None = None,
               include_embed: bool = True) -> float:
        """Run the serving path once before traffic — one prefill (and
        embedding) per bucket up to `max_bucket`, the sampler, a decode
        step, a decode chunk and, with `speculative`, one speculative step
        — so the kernels are built and loaded (with each shape's launch
        attributes set) and the allocator holds its working set before the
        first request. Every rung of the speculative ladder runs the same
        verify forward, only more times, so one step warms them all (the
        restore forward is the decode step's).
        The slots, cache and sampler state are wiped afterwards. Returns
        seconds spent."""
        t0 = time.time()
        limit = max_bucket or self.buckets[-1]
        mask = np.zeros(self.n_slots, bool)
        mask[0] = True
        reset_slots(self.sampler_state, self._tensor(mask),
                    self._tensor(np.full(self.n_slots, self.config.max_seq_len)))
        for b in self.buckets:
            if b > limit:
                break
            ids = [1] * min(b, self.config.max_seq_len - 2)
            self._push_slot_tokens(0, ids)
            self._prefill(0, ids, write_pos=0)
            if include_embed:
                self._embed_ids(ids)
        ones_f = np.ones(self.n_slots, np.float32)
        ones_i = np.ones(self.n_slots, np.int64)
        tokens_dev = sample(self.logits, self.sampler_state, self._tensor(ones_f),
                            self._tensor(ones_i), self._tensor(ones_f),
                            self._tensor(ones_f), self.generators)
        push_tokens(self.sampler_state, tokens_dev[:, None], self._tensor(mask))
        zeros = torch.zeros(self.n_slots, dtype=torch.long, device=self.device)
        self.logits, self.cache = forward_impl(
            self.params, zeros[:, None], self.cache, zeros, self.config)
        if self.decode_chunk_size > 1:
            from llamago_tpu_torch.runtime.decode_loop import decode_chunk

            toks, self.cache, _, self.sampler_state, self.logits = decode_chunk(
                self.params, zeros, self.cache, zeros, self.config,
                self.decode_chunk_size, generators=self.generators,
                state=self.sampler_state, temp=self._tensor(ones_f),
                top_k=self._tensor(ones_i), top_p=self._tensor(ones_f),
                repeat_penalty=self._tensor(ones_f), greedy=False,
                return_final_logits=True)
            toks.tolist()
        if self.speculative:
            from llamago_tpu_torch.runtime.speculative import speculative_decode_chunk

            hist = torch.zeros((self.n_slots, self.config.max_seq_len), dtype=torch.long,
                               device=self.device)
            hlen = torch.ones(self.n_slots, dtype=torch.long, device=self.device)
            _, _, self.cache, _, hist, hlen = speculative_decode_chunk(
                self.params, zeros, self.cache, zeros, hist, hlen, self.config,
                n_steps=1, draft_len=self.draft_len)
        self.logits.cpu()  # waits for the device
        self.cache = self._make_cache()
        reset_slots(self.sampler_state,
                    torch.ones(self.n_slots, dtype=torch.bool, device=self.device))
        self.logits = torch.zeros_like(self.logits)
        for slot in self.slots:
            if slot.free:
                slot.history = []
                slot.pos = 0
                slot.swap_point = None
        return time.time() - t0

    # --------------------------------------------------------- lifecycle

    def _rebuild_device_state(self) -> None:
        """Recreate the device state after a failed step (the slots'
        cached prefixes are forfeited)."""
        self.cache = self._make_cache()
        self.sampler_state = SamplerState.create(
            self.n_slots, self.config.max_seq_len, self.config.vocab_size,
            device=self.device)
        self.logits = torch.zeros((self.n_slots, self.config.vocab_size),
                                  dtype=torch.float32, device=self.device)
        self.generators = [self._generator(i) for i in range(self.n_slots)]
        for slot in self.slots:
            slot.history = []
            slot.pending = []
            slot.pos = 0
            slot.swap_point = None

    def _finish(self, slot: _Slot) -> None:
        """The slot's job is done: finished now, and the slot free."""
        slot.job.status = JobStatus.FINISHED
        slot.job.finished = time.time()
        slot.job = None

    def _fail_active(self, exc: Exception) -> None:
        """Mark every in-flight job failed; the engine loop survives."""
        msg = f"{type(exc).__name__}: {exc}"
        for slot in self.slots:
            if slot.job is not None:
                slot.job.status = JobStatus.FAILED
                slot.job.error = msg
                slot.job.finished = time.time()
                slot.job = None

    def _publish_output(self, job) -> bool:
        """Render, stop-truncate, and publish job.output in ONE assignment
        (a concurrent stream reader never sees text past a stop sequence);
        True if a stop sequence matched."""
        text = _render_output(self.vocab, job)
        stopped = False
        for seq in job.gen.stop or ():
            idx = text.find(seq)
            if idx >= 0:
                text = text[:idx]
                stopped = True
                break
        job.output = text
        return stopped

    def expired_job_ids(self, now: float | None = None) -> list[str]:
        """Active jobs past their wall-clock deadline. Apart from the expiry
        itself so that under lockstep rank 0 decides and broadcasts it: the
        ranks' clocks may disagree."""
        now = time.time() if now is None else now
        return [slot.job.id for slot in self.slots
                if slot.job is not None and slot.job.gen.deadline_s > 0
                and now - slot.job.started > slot.job.gen.deadline_s]

    def apply_expiry(self, job_ids: list[str]) -> None:
        """Fail the active jobs named."""
        if not job_ids:
            return
        idset = set(job_ids)
        for slot in self.slots:
            job = slot.job
            if job is not None and job.id in idset:
                job.status = JobStatus.FAILED
                job.error = f"deadline exceeded ({job.gen.deadline_s:.0f}s)"
                job.output = _render_output(self.vocab, job)
                job.finished = time.time()
                slot.job = None

    def _expire_deadlines(self) -> None:
        """Fail active jobs past their wall-clock deadline (the reference's
        unwritten background watcher, server.go:55)."""
        self.apply_expiry(self.expired_job_ids())

    def enable_lockstep_admission(self) -> None:
        """Gate admissions on the ranks' agreement (see _agreed_n)."""
        with self._lock:
            self._agreed_n = 0

    def approve(self, n: int) -> None:
        """Mark the next n queued jobs agreed (the other ranks call this
        after submitting the broadcast's jobs)."""
        with self._lock:
            if self._agreed_n is not None:
                self._agreed_n += n

    def drain_pending(self) -> list:
        """Take the queue's tail that is not agreed yet (rank 0 drains,
        broadcasts, then requeues the same Job objects, so that the HTTP
        side's references stay live)."""
        with self._lock:
            agreed = self._agreed_n or 0
            jobs, self._queue = self._queue[agreed:], self._queue[:agreed]
        return jobs

    def requeue(self, jobs: list) -> None:
        """Put agreed jobs back right behind the agreed prefix (jobs that
        came in since the drain stay behind them, for the next tick)."""
        if not jobs:
            return
        with self._lock:
            a = self._agreed_n or 0
            self._queue = self._queue[:a] + list(jobs) + self._queue[a:]
            if self._agreed_n is not None:
                self._agreed_n += len(jobs)
        self._wake.set()

    def run_forever(self, poll_interval: float = 0.05) -> None:
        """Engine loop; an event wakes it immediately on submit. Kernel
        launches go to this thread's current stream on the engine's
        device."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while not self._stop.is_set():
            try:
                self._expire_deadlines()
                busy = self.step()
            except Exception as exc:  # noqa: BLE001 — engine must survive
                self._fail_active(exc)
                self._rebuild_device_state()
                busy = True
            if not busy:
                self._wake.wait(timeout=poll_interval)
                self._wake.clear()

    def start(self) -> None:
        self._thread = threading.Thread(target=self.run_forever, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread:
            self._thread.join(timeout=10)

    def generate(self, prompt: str, gen: GenerateConfig) -> Job:
        """Synchronous single-prompt generation (the CLI path)."""
        job = self.submit(prompt, gen)
        while job.status in (JobStatus.QUEUED, JobStatus.PROCESSING):
            self.step()
        return job


def _render_output(vocab: Vocab, job: Job) -> str:
    """Output excludes the prompt and is trimmed (server.go:222-244)."""
    return detokenize(vocab, job.output_tokens).strip()

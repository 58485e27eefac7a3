"""Multi-process serving: every rank runs the same engine tick in lockstep.

Counterpart of the JAX package's `parallel/multihost.py`. Each rank is one
process (parallel/mesh.py); every forward holds collectives, so every rank
must run the same forwards in the same order, and that needs the same host
inputs everywhere. These helpers give that agreement, over the mesh's gloo
control group:

  * is_primary()        — rank 0 owns the HTTP front end
  * broadcast_pytree(x) — rank 0's JSON-serializable object on every rank
                          (torch.distributed.broadcast_object_list)
  * agree(submissions)  — rank 0's queued submissions, seed=-1 resolved
                          there, on every rank
  * serve_lockstep      — the tick: drain, agree, admit, step

Sampling stays the same on every rank because every engine seeds a slot's
generator from its job's seed, and a job with seed=-1 gets its seed on
rank 0 before the broadcast, never from a rank's own clock.
"""

from __future__ import annotations

import dataclasses
import json
import time

import torch.distributed as dist


def is_primary() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def broadcast_pytree(obj, is_source: bool | None = None):
    """rank 0's JSON-serializable `obj` on every rank (the others pass
    anything), through its JSON text on the gloo world group. One process:
    `obj` itself."""
    if process_count() == 1:
        return obj
    if is_source is None:
        is_source = is_primary()
    box = [json.dumps(obj) if is_source else None]
    dist.broadcast_object_list(box, src=0, group=dist.group.WORLD)
    return json.loads(box[0])


def gen_to_dict(gen) -> dict:
    return dataclasses.asdict(gen)


def gen_from_dict(d: dict):
    from llamago_tpu_torch.config import GenerateConfig

    d = dict(d)
    d["stop"] = tuple(d.get("stop", ()))  # JSON carries the tuple as a list
    return GenerateConfig(**d)


def agree(submissions: list[dict]) -> list[dict]:
    """rank 0's pending submissions ({"id", "prompt", "gen": {overrides}})
    on every rank, with seed=-1 resolved on rank 0, so that every rank
    admits byte-identical jobs."""
    if is_primary():
        for s in submissions:
            gen = s.setdefault("gen", {})
            if gen.get("seed", -1) < 0:
                gen["seed"] = time.time_ns() % (2**31)
    return broadcast_pytree(submissions if is_primary() else None)


def serve_lockstep(engine, job_server=None, poll_interval: float = 0.05,
                   stop_when=None) -> None:
    """The serving loop every rank runs. Rank 0 may own the HTTP front end
    (`job_server`, started here without its engine thread; only rank 0 may
    have one); without it rank 0 serves the jobs submitted to its engine
    directly (the CLI's one-shot and chat under a mesh).

    Each tick:
      1. rank 0 drains its queue, resolves seed=-1, takes the embedding
         requests and decides the deadline expiries;
      2. one broadcast carries {subs, embeds, expired, stop} to every rank;
      3. every rank admits the same jobs in the same order (rank 0 requeues
         its own Job objects so the HTTP side's references stay live, the
         others submit equal ones), applies the same expiries and computes
         the same embeddings;
      4. every rank steps its engine: the same state in, the same
         forwards and collectives out. Idle ticks sleep on every rank (the
         state is the same, so is the decision); the broadcast is the
         barrier that keeps the ticks aligned.

    A failed step fails the active jobs and rebuilds the device state on
    every rank. `stop_when` (read on rank 0) ends the loop on every rank
    through the broadcast's stop flag."""
    primary = is_primary()
    engine.enable_lockstep_admission()  # step() admits agreed jobs only
    if job_server is not None:
        if not primary:
            raise ValueError("only rank 0 may own the HTTP front end")
        job_server.start_background(start_engine=False)
    pending: list = []
    try:
        while True:
            if primary:
                pending = engine.drain_pending()
                for j in pending:
                    if j.gen.seed < 0:  # never from a rank's own clock
                        j.gen = j.gen.replace(seed=time.time_ns() % (2**31))
                msg = {"subs": [{"id": j.id, "prompt": j.prompt, "gen": gen_to_dict(j.gen)}
                                for j in pending],
                       "embeds": engine.drain_embeds(),
                       "expired": engine.expired_job_ids(),
                       "stop": bool(stop_when()) if stop_when is not None else False}
            else:
                msg = None
            msg = broadcast_pytree(msg)
            if primary:
                engine.requeue(pending)
            else:
                for s in msg["subs"]:
                    engine.submit(s["prompt"], gen_from_dict(s["gen"]), job_id=s["id"])
                engine.approve(len(msg["subs"]))
            engine.apply_expiry(msg["expired"])
            embeds = msg["embeds"]
            engine.run_embeds(embeds)
            try:
                busy = engine.step()
            except Exception as exc:  # noqa: BLE001 — the engine must survive
                engine._fail_active(exc)
                engine._rebuild_device_state()
                busy = True
            if msg["stop"]:
                return
            if not busy and not msg["subs"] and not embeds:
                time.sleep(poll_interval)
    finally:
        if job_server is not None:
            job_server.shutdown()

"""The comparison that decides `correct` for a served model.

Once the window has closed and the program is freed, a sample of the greedy
requests the run finished, drawn from the seed with the longest always in
it, goes to the reference (reference/model.py): one pass over each prompt
with its served tokens. For every served token the reading is its gap, the
reference's best logit at that position minus the reference's logit of the
served token (0 where the program chose the reference's best). The number
compared is the widest gap. The control (`control=True`) reads, at the same
positions, the gap of the token that the reference computed in fp8 puts
first.
"""

from __future__ import annotations

import numpy as np


def pick(finished: list, seed: int, max_requests: int, target_tokens: int) -> list:
    """finished: (request, served tokens). The longest by served tokens, then
    others in an order drawn from the seed, until `target_tokens` served
    tokens or `max_requests` requests."""
    if not finished:
        return []
    order = sorted(range(len(finished)), key=lambda i: (-len(finished[i][1]),
                                                        finished[i][0].index))
    rest = order[1:]
    rng = np.random.default_rng([int(seed) & (2**63 - 1), 0x636865636b])
    rest = [rest[i] for i in rng.permutation(len(rest))]
    out, tokens = [], 0
    for i in [order[0]] + rest:
        if len(out) >= max_requests or tokens >= target_tokens:
            break
        out.append(finished[i])
        tokens += len(finished[i][1])
    return out


def served_gaps(dims, seed: int, sample: list, device, control: bool = False):
    """(gaps of the served tokens, gaps of the control's first choices or
    None), each a list of f32 arrays, one a request."""
    import torch

    from benchmark.reference.model import logits_at

    seqs, rows, served = [], [], []
    for req, toks in sample:
        ids = req.prompt_ids()
        seqs.append(ids + list(toks[:-1]))
        rows.append(list(range(len(ids) - 1, len(ids) - 1 + len(toks))))
        served.append(toks)
    ref = logits_at(dims, seed, seqs, rows, device)
    gaps = []
    for lg, toks in zip(ref, served):
        idx = torch.tensor(toks, dtype=torch.long, device=lg.device)
        gaps.append((lg.max(dim=-1).values - lg.gather(1, idx[:, None])[:, 0]).cpu().numpy())
    ctrl = None
    if control:
        low = logits_at(dims, seed, seqs, rows, device, precision="fp8")
        ctrl = []
        for lg, lo in zip(ref, low):
            first = lo.argmax(dim=-1)
            ctrl.append((lg.max(dim=-1).values - lg.gather(1, first[:, None])[:, 0])
                        .cpu().numpy())
    return gaps, ctrl

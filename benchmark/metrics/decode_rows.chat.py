"""Engine: mean active slots per decode step over the window (a chunk of n
counts as n steps of its rows), from the host's knowledge of the slots."""


def read(run):
    steps = sum(st.tokens for st in run.steps)
    rows = sum(st.tokens * len(st.positions) for st in run.steps)
    return rows / steps if steps else None

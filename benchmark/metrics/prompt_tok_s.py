"""Prompt tokens prefilled by the steps of the window (each prefill chunk's
real tokens), over the window's seconds."""


def read(run):
    return run.prompt_tokens / run.window_s if run.window_s > 0 else None

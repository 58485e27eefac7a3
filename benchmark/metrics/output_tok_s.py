"""Output tokens emitted by the steps of the window, over the window's seconds."""


def read(run):
    return run.output_tokens / run.window_s if run.window_s > 0 else None

"""Output tokens emitted in the window over the window's seconds."""


def read(run):
    return len(run.token_times()) / run.window_s

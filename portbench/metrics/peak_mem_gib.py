"""peak_mem_gib: `torch.cuda.max_memory_allocated()` over the window (reset
after set-up): the fold, the activations and the workspaces."""


def read(rec):
    return None if rec.window_peak_bytes is None else rec.window_peak_bytes / 2 ** 30

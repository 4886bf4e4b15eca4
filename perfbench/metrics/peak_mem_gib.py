"""``peak_mem_gib``: ``torch.cuda.max_memory_allocated()`` over the
untraced window, after ``reset_peak_memory_stats()`` at its start."""


def read(run):
    if not run.peak_window_bytes:
        return None
    return run.peak_window_bytes / 2 ** 30

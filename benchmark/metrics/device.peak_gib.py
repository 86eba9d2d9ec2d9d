"""The largest device memory the window's requests held at once
(``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats`` at
the window's start), in GiB."""


def read(run):
    return run.peak_window_bytes / 2**30 if run.peak_window_bytes else None

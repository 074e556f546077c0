"""peak_device_mb: torch.cuda.max_memory_allocated() over the window, in
MiB, the graph included; the peak is reset after set-up."""


def read(run):
    if run.peak_bytes is None:
        return None
    return run.peak_bytes / 2**20

"""The window's peak of allocated device memory above what was allocated
when it opened (`torch.cuda.max_memory_allocated`), in MiB."""


def read(t):
    return t["window_peak_bytes"] / 2 ** 20

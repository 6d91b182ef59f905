"""Kernel launches a batch: the kernels the profiler saw in the slice,
on every card, over the batches the slice dispatched."""


def read(run):
    prof, n = run.layer.get("profile"), run.layer.get("slice_batches", 0)
    if prof is None or not n or not prof.kernels:
        return None
    return len(prof.kernels) / n

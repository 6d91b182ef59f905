"""Device time a batch: the summed kernel, copy and set time of the
profiled slice over the batches it dispatched."""


def read(run):
    prof, n = run.layer.get("profile"), run.layer.get("slice_batches", 0)
    if prof is None or not n or not prof.device:
        return None
    return sum(e["dur"] for e in prof.device) / 1e3 / n

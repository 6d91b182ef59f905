"""Share of the profiled slice in which no kernel, copy or set ran (%)."""


def read(run):
    prof = run.layer.get("profile")
    if prof is None or not prof.device or prof.window_s <= 0:
        return None
    return 100.0 * (1.0 - prof.busy_s / prof.window_s)

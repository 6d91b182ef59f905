"""Device time of one express graph replay: the summed time of the
kernels launched by the slice's graph launches, over those launches."""


def read(run):
    g = run.layer.get("graph")
    if not g or not g[1] or g[0] <= 0:
        return None
    return g[0] * 1e3 / g[1]

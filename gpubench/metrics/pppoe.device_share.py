"""Share of the window's lanes that the device decapsulated or
encapsulated (the engine's PPPoE stats, decap + encap, over the window's
retired batches), over the window's lanes (%). The rest went to the host:
control frames, and session data the device could not take."""


def read(run):
    got = run.layer.get("pppoe_lanes")
    if not got or not got[2]:
        return None
    decap, encap, lanes = got
    return 100.0 * (decap + encap) / lanes

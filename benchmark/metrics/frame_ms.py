"""frame_ms: the window's seconds over the frames completed in it (ms)."""


def read(r):
    if r["mode"] != "serve" or not r["units"]:
        return None
    return r["window_s"] / r["units"] * 1e3

"""train_step_ms: the window's seconds (ending with a device synchronise)
over the steps completed in it (ms)."""


def read(r):
    if r["mode"] != "train" or not r["units"]:
        return None
    return r["window_s"] / r["units"] * 1e3

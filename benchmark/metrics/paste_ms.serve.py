"""paste_ms.serve: ms of the mask tool's host work a sample (the program's
``generate_masks.paste_detections`` plus ``paint_sample``), summed over the
window and divided by its frames. The spans are CUDA events, but the card
is idle while the host pastes and paints, so they read the host's time from
the end of the forward's work to the last plane painted."""


def read(r):
    if r["mode"] != "serve" or not r["units"] or not r.get("spans", {}).get("paste"):
        return None
    return sum(r["spans"]["paste"]) / r["units"]

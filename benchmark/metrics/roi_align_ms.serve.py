"""roi_align_ms.serve: CUDA-event ms of a sample's RoI feature extraction
(every call of the program's ``HTC.roi_feats``: FPN RoIAlign and the
semantic embedding's, three box stages and the masks, per camera), summed
over the window and divided by its frames."""


def read(r):
    if r["mode"] != "serve" or not r["units"] or not r.get("spans", {}).get("roi_align"):
        return None
    return sum(r["spans"]["roi_align"]) / r["units"]

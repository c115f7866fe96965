"""dcn_ms.serve: CUDA-event ms of a sample's deformable convolutions (every
call of the program's ``DeformConvBlock``s, 30 a sample, each over the six
cameras), summed over the window and divided by its frames."""


def read(r):
    if r["mode"] != "serve" or not r["units"] or not r.get("spans", {}).get("dcn"):
        return None
    return sum(r["spans"]["dcn"]) / r["units"]

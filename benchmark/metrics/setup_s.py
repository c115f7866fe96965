"""setup_s: process start until the window opens (s)."""


def read(r):
    return r["setup_s"]

"""Output tokens delivered to the clients in the window, over the
window's length."""


def read(rec):
    return rec["tokens"] / rec["window_s"]

"""The device's idle share of the traced window, %: one less the union of
the device's kernel and copy intervals over the window's length."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])

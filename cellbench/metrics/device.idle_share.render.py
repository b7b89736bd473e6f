"""Share of the traced window in which no device activity ran."""


def read(view):
    if view.mode != "render" or view.window_s <= 0:
        return None
    return 100.0 * (1.0 - view.busy_s / view.window_s)

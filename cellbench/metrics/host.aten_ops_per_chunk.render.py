"""Outermost aten ops the host dispatches per 4,096-ray chunk of
``render_image`` (the chunks rendered again counted once more)."""


def read(view):
    if view.mode != "render":
        return None
    return view.aten_ops / (view.counters["chunks"] + view.counters["redo"])

"""Chunks ``render_image`` rendered again at the exact capacity, over the
chunks it rendered: work done twice (the program's ``last_redo``)."""


def read(view):
    if view.mode != "render" or not view.counters.get("chunks"):
        return None
    return 100.0 * view.counters["redo"] / view.counters["chunks"]

"""Device ms an iteration of the renderer's own stages: compaction and
warp (K12), the prefilter and votes (K14), the keep-set compaction (K13)
and compositing (K10/K11)."""

SPANS = ("render.compact_a_warp", "render.prefilter", "render.compact_b", "render.composite")


def read(view):
    if view.mode != "train":
        return None
    return view.span_device_ms(SPANS) / view.units["iterations"]

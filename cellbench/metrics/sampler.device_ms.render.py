"""Device ms an image of the sampler: the octree traversal (K8) and the
marcher (K9 or K7), the spans ``render.traverse`` and ``render.march``."""


def read(view):
    if view.mode != "render":
        return None
    return view.span_device_ms(("render.traverse", "render.march")) / view.units["images"]

"""Device ms an image of the field and shader query: the span
``render.field_shader`` (the encode, the MLPs, the SH shader)."""


def read(view):
    if view.mode != "render":
        return None
    return view.span_device_ms(("render.field_shader",)) / view.units["images"]

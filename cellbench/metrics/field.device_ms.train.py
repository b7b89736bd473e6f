"""Device ms an iteration of the field and shader query: the span
``render.field_shader`` (the encode, the MLPs, the SH shader)."""


def read(view):
    if view.mode != "train":
        return None
    return view.span_device_ms(("render.field_shader",)) / view.units["iterations"]

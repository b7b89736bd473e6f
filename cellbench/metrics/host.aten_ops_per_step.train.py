"""Outermost aten ops the host dispatches an iteration: what the Python
side asks of the device per step."""


def read(view):
    if view.mode != "train":
        return None
    return view.aten_ops / view.units["iterations"]

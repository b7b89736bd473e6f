"""Device ms an iteration of the kernels ``loss.backward()`` launched:
those under autograd's engine (its own thread), the field scatter (K3 or
K6) among them."""


def read(view):
    if view.mode != "train":
        return None
    return view.span_device_ms(("backward",)) / view.units["iterations"]

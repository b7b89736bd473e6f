"""Device ms an iteration of the optimizer: fused Adam (K1) and the
occupancy fold (K14), the spans ``step.adam`` and ``step.occupancy_fold``."""


def read(view):
    if view.mode != "train":
        return None
    return view.span_device_ms(("step.adam", "step.occupancy_fold")) / view.units["iterations"]

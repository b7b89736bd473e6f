"""The whole render's share of the chip's float32 peak: model FLOPs (a
sample's forward over each ray's samples, as the reference counts them on
the checked rays) over the traced window's seconds."""


def read(view):
    c = view.counts
    if view.mode != "render" or not c.get("f32_flops") or not c.get("samples_per_ray"):
        return None
    flops = c["sample_flops"] * c["samples_per_ray"] * view.counters["rays"]
    return 100.0 * flops / (view.window_s * c["f32_flops"])

"""The whole training step's share of the chip's float32 peak: model FLOPs
(3 times a sample's forward, for forward and backward, over the step's
grad-pass samples: buffer B's kept samples and the edge samples) over the
traced window's seconds."""


def read(view):
    c = view.counts
    if view.mode != "train" or not c.get("f32_flops"):
        return None
    flops = 3 * c["sample_flops"] * c["grad_samples"] * view.units["iterations"]
    return 100.0 * flops / (view.window_s * c["f32_flops"])
